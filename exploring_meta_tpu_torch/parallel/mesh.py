"""Task data parallelism over ``torch.distributed`` (port of
``exploring_meta_tpu/parallel/mesh.py``).

JAX shards the task axis of a meta-batch over a device mesh with
``shard_map``: each chip adapts its share of the tasks, the mean
gradients are ``pmean``-reduced over the interconnect, and every chip
applies the same update to its replicated params. Here each share is a
process (``parallel/launch.py``): a :class:`TaskMesh` of a launched rank
holds the process group, the rank and its device, and :meth:`TaskMesh.pmean`
is ``all_reduce(SUM)`` followed by a division by the mesh size, as
``psum / n`` computes it (gloo has no ``AVG`` for CUDA tensors). Every rank
holds the same params; the reduced values are the same on every rank, and
so is everything computed from them, so the params stay bitwise equal.

The factories are JAX's: :func:`make_sharded_meta_step` and
:func:`make_sharded_train_scan` (vision), :func:`make_sharded_trpo_meta_step`
and :func:`make_sharded_trpo_train_scan` (TRPO; every cross-rank quantity
of the natural-gradient step is reduced as JAX's ``_make_local_trpo_outer``
reduces it, ``rl/trpo_meta.py:natural_gradient_step``),
:func:`make_sharded_replay_meta_step` and :func:`make_sharded_adam_train_scan`
(PPO / VPG). Where JAX folds the mesh index into a step key, each rank
draws from its own generator (:func:`rank_generator`).

A server's mesh (``serve.py``) has no collectives (per-request work is
independent, JAX ``serve.py:150-156``): it is one process and a tuple of
local devices, over which the request axis is split into contiguous
shards (:func:`split_requests`).
"""

from __future__ import annotations

import torch

from exploring_meta_tpu_torch.parallel.launch import current_rank
from exploring_meta_tpu_torch.utils.tree import tree_leaves, tree_map

# all_reduce calls since the last reset_counts(); a call made while the
# stream is being captured counts in "captured" (each replay repeats it)
COUNTS = {"all_reduce": 0, "captured": 0}


def reset_counts() -> None:
    for key in COUNTS:
        COUNTS[key] = 0


class TaskMesh:
    """A 1-D mesh over the task axis: ``devices`` by rank, this process's
    ``rank`` (None for a server's one-process mesh), the ``backend`` of
    its process group and the ``axis`` name."""

    def __init__(self, devices, axis: str = "tasks", rank: int | None = None,
                 backend: str | None = None):
        self.devices = tuple(torch.device(d) for d in devices)
        self.axis = axis
        self.rank = rank
        self.backend = backend

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def distributed(self) -> bool:
        return self.rank is not None

    @property
    def device(self) -> torch.device:
        return self.devices[self.rank or 0]

    def __repr__(self) -> str:
        return (f"TaskMesh({self.axis}={self.size}, rank={self.rank}, "
                f"backend={self.backend})")

    def _reduce(self, flat: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist
        if not self.distributed:
            raise RuntimeError("a server mesh runs no collectives")
        if flat.is_cuda and torch.cuda.is_current_stream_capturing():
            COUNTS["captured"] += 1
        else:
            COUNTS["all_reduce"] += 1
        dist.all_reduce(flat, op=dist.ReduceOp.SUM)
        return flat.div_(self.size)

    @torch.no_grad()
    def _pmean_all(self, xs) -> list:
        flat = self._reduce(torch.cat([x.detach().reshape(-1) for x in xs]))
        return [p.view(x.shape) for p, x in
                zip(flat.split([x.numel() for x in xs]), xs)]

    def pmean(self, *xs):
        """The mean over the ranks of each of ``xs`` (one collective for
        all of them) -> a tensor, or a tuple of tensors of their shapes."""
        outs = self._pmean_all(xs)
        return outs[0] if len(xs) == 1 else tuple(outs)

    @torch.no_grad()
    def pmean_(self, tensors) -> None:
        """:meth:`pmean` written back into ``tensors`` in place, so they
        stay at the addresses a captured step reads."""
        tensors = list(tensors)
        for t, m in zip(tensors, self._pmean_all(tensors)):
            t.copy_(m)


def make_task_mesh(n_devices: int | None = None, axis: str = "tasks",
                   devices=None) -> TaskMesh:
    """Inside a launched rank: the mesh over the process group (``n_devices``
    must be its size). Elsewhere, a server's mesh: over ``devices`` when
    given (a device may repeat), else the first ``n_devices`` cards, which
    must exist (never truncated silently)."""
    rank = current_rank()
    if rank is not None and devices is None:
        if n_devices not in (None, rank.size):
            raise ValueError(f"a {n_devices}-device mesh in a launch of "
                             f"{rank.size} ranks")
        return TaskMesh(rank.devices, axis, rank.rank, rank.backend)
    if devices is None:
        have = torch.cuda.device_count()
        n = have if n_devices is None else n_devices
        if n < 1:
            raise ValueError(f"mesh needs >= 1 device, got {n}")
        if n > have:
            # a --mesh larger than the machine would otherwise shrink the
            # effective meta-batch with no warning
            raise ValueError(f"requested a {n}-device mesh but only "
                             f"{have} devices are available")
        devices = [torch.device("cuda", i) for i in range(n)]
    if n_devices is not None and n_devices != len(devices):
        raise ValueError(f"a {n_devices}-device mesh over {len(devices)} "
                         "devices")
    if not devices:
        raise ValueError("mesh needs >= 1 device, got 0")
    return TaskMesh(devices, axis)


def local_count(size: int, n: int) -> int:
    """Each of ``size`` ranks' share of a meta-batch of ``n`` tasks, which
    must divide evenly (JAX's message)."""
    if n % size:
        raise ValueError(f"meta_batch_size={n} not divisible by mesh size "
                         f"{size}")
    return n // size


def shard_task_batch(mesh: TaskMesh, task_batch):
    """This rank's contiguous shard of a task batch's leading axis (on a
    server's mesh, the tuple of every device's shard, each moved there).
    A batch the mesh does not divide raises JAX's ``ValueError``."""
    n = mesh.size
    leaves = tree_leaves(task_batch)
    lead = leaves[0].shape[0]
    if lead % n:
        raise ValueError(f"task batch size {lead} not divisible by mesh "
                         f"axis {mesh.axis!r} size {n}")
    k = lead // n
    if mesh.distributed:
        r = mesh.rank
        return tree_map(lambda x: x[r * k:(r + 1) * k], task_batch)
    return tuple(tree_map(lambda x: x[i * k:(i + 1) * k].to(d),
                          task_batch)
                 for i, d in enumerate(mesh.devices))


def split_requests(mesh: TaskMesh, n: int) -> list:
    """A server mesh's contiguous request shards of a batch of ``n``:
    ``[(device, start, stop)]``, the first ``n % size`` shards one request
    longer, empty shards left out (5 requests on 8 devices: five shards
    of one)."""
    base, extra = divmod(n, mesh.size)
    out, start = [], 0
    for i, dev in enumerate(mesh.devices):
        stop = start + base + (i < extra)
        if stop > start:
            out.append((dev, start, stop))
        start = stop
    return out


def rank_generator(mesh: TaskMesh | None, gen: torch.Generator, seed: int,
                   start: int = 0) -> torch.Generator:
    """The generator a rank samples its own tasks from, where JAX folds the
    mesh index into the step key: rank 0 draws from the run's ``gen``
    (so a mesh of one is the run without a mesh), rank ``r > 0`` from a
    generator seeded from ``(seed, r, start)`` (``start``: the iteration
    a resumed run continues at)."""
    if mesh is None or not mesh.rank:
        return gen
    mix = (seed * 0x9E3779B97F4A7C15 + mesh.rank * 0xBF58476D1CE4E5B9
           + start * 0x94D049BB133111EB) % (2 ** 63)
    return torch.Generator(device=gen.device).manual_seed(mix)


def check_fusable(mesh: TaskMesh | None, device) -> None:
    """A fused iteration captures its collectives in the CUDA graph, which
    NCCL allows and gloo does not: ``--fuse`` on a gloo group on the card
    raises (on the CPU the fused loop runs eagerly)."""
    if (mesh is not None and mesh.backend == "gloo"
            and torch.device(device).type == "cuda"):
        raise ValueError("--fuse captures the iteration in a CUDA graph, "
                         "and gloo collectives cannot be captured: run "
                         "--fuse on an NCCL group (one rank a card) or "
                         "eagerly (--fuse 1)")


# --------------------------------------------------------------------------
# the sharded factories, in JAX's order
# --------------------------------------------------------------------------

def make_sharded_meta_step(fast_adapt, mesh: TaskMesh):
    """``meta_step(params, opt, *local_batch) -> (params, opt, metrics)``:
    the local mean query loss is differentiated, the gradients and metrics
    are ``pmean``-reduced and every rank takes the same Adam step
    (``adapt/maml.py:make_meta_step`` with the mesh)."""
    from exploring_meta_tpu_torch.adapt.maml import make_meta_step
    return make_meta_step(fast_adapt, mesh=mesh)


def make_sharded_train_scan(fast_adapt, sample_local, n_steps: int,
                            mesh: TaskMesh, eval_sample_local=None):
    """``train(params, opt, gen, n)``: ``n`` sharded meta-iterations, each
    rank sampling its share from its own generator ``gen``
    (:func:`rank_generator`), the valid pass reduced too, fused as
    ``adapt/maml.py:make_train_scan`` fuses them."""
    from exploring_meta_tpu_torch.adapt.maml import make_train_scan
    return make_train_scan(fast_adapt, sample_local, n_steps,
                           eval_sample_fn=eval_sample_local, mesh=mesh)


def make_sharded_trpo_meta_step(policy, cfg, trpo_cfg, adapt_steps: int,
                                mesh: TaskMesh, host_free: bool = False):
    """``(params, local old params, local replays) -> (params, info)``: the
    TRPO outer step on this rank's shard with every cross-rank quantity
    reduced (JAX ``_make_local_trpo_outer``): the surrogate and its
    gradient, each Fisher-vector product before the damping, each line
    search candidate's loss and KL."""
    from exploring_meta_tpu_torch.rl.trpo_meta import make_trpo_meta_step
    return make_trpo_meta_step(policy, cfg, trpo_cfg, adapt_steps,
                               host_free=host_free, reduce=mesh.pmean)


def make_sharded_trpo_train_scan(env, policy, rollout_fn, cfg, trpo_cfg,
                                 meta_batch_size: int, n_steps: int,
                                 mesh: TaskMesh):
    """``train(params, gen, n)``: fused MAML-TRPO iterations, each rank
    sampling and collecting ``meta_batch_size / size`` tasks from its own
    generator, the outer step sharded; metrics are global means."""
    from exploring_meta_tpu_torch.rl.train_scan import make_trpo_train_scan
    return make_trpo_train_scan(env, policy, rollout_fn, cfg, trpo_cfg,
                                meta_batch_size, n_steps, mesh=mesh)


def make_sharded_replay_meta_step(policy, cfg, algo: str, mesh: TaskMesh):
    """``(params, opt, local replays) -> (params, opt, loss)``: the PPO /
    VPG query losses rederived from this rank's shard of recorded replays
    (``rl/replay_meta.py``), the gradients and the loss reduced, one Adam
    step on every rank."""
    from exploring_meta_tpu_torch.adapt.maml import apply_meta_gradient
    from exploring_meta_tpu_torch.rl.replay_meta import make_replay_meta_loss
    meta_loss = make_replay_meta_loss(algo, policy, cfg)

    def step(params, opt, local_replays):
        loss = meta_loss(params, local_replays)
        apply_meta_gradient(opt, loss, params, reduce=mesh.pmean_)
        return params, opt, mesh.pmean(loss.detach())

    return step


def make_sharded_adam_train_scan(env, policy, rollout_fn, cfg, algo: str,
                                 meta_batch_size: int, n_steps: int,
                                 mesh: TaskMesh):
    """``train(params, opt, gen, n)``: fused PPO / VPG iterations, each rank
    adapting its own ``meta_batch_size / size`` tasks, the meta-gradients
    reduced before one Adam step on every rank."""
    from exploring_meta_tpu_torch.rl.train_scan import make_adam_train_scan
    return make_adam_train_scan(env, policy, rollout_fn, cfg, algo,
                                meta_batch_size, n_steps, mesh=mesh)


def replicated_equal(mesh: TaskMesh, tensors) -> bool:
    """Whether every rank holds bitwise the same ``tensors`` (a check for
    tests and the smoke run, not a step of training): rank 0's values are
    broadcast and compared."""
    import torch.distributed as dist
    differ = 0
    for t in tensors:
        rank0 = t.detach().clone()
        dist.broadcast(rank0, src=0)
        differ += not torch.equal(rank0, t.detach())
    flag = torch.tensor([float(differ)], device=mesh.device)
    dist.all_reduce(flag, op=dist.ReduceOp.SUM)
    return flag.item() == 0.0


__all__ = ["TaskMesh", "make_task_mesh", "make_sharded_adam_train_scan",
           "make_sharded_meta_step", "make_sharded_replay_meta_step",
           "make_sharded_train_scan", "make_sharded_trpo_meta_step",
           "make_sharded_trpo_train_scan", "shard_task_batch"]
