"""Serving of meta-trained models (port of ``VisionServer`` and
``PolicyServer`` from ``exploring_meta_tpu/serve.py``).

:class:`VisionServer`: one request is ``(support_x [S, H, W, C],
support_y [S], query_x [Q, H, W, C])``. The server adapts the model on
the support set with the inner SGD it was meta-trained with (first order:
serving takes no meta-gradient), then predicts the queries.
:meth:`VisionServer.batch` serves B requests at once, with the request
axis written out: each request's params are adapted on its own support
set, and BN statistics are per request. On the Omniglot spec the base
runs on the fused CUDA block kernels (``set_conv_impl("fused")``, the
default).

:class:`PolicyServer`: one request is a collected support
:class:`~exploring_meta_tpu_torch.rl.rollout.Trajectory` ``[T, E, ...]``;
the server adapts a meta-trained Gaussian policy on it with the
analysis-side inner step (``rl/adapt_rl.py:single_adapt_step``: vpg, ppo
or trpo, first order), whose GAE and discount sweeps run on the CUDA
kernels, and acts with the adapted params.

Both servers run one program per request bucket, as the JAX servers run
one jitted XLA program: a batch of B requests is padded to the next
power-of-two bucket (``_next_bucket``) by repeating its first request
(``_pad_leading``), served as a bucket, and the padding is sliced off.
The program is a CUDA graph (``utils/graphs.py:CapturedCalls``, one
memory pool a server): the first call at a bucket and input shape runs
eagerly and is captured right after, every later one is a replay, one
graph launch instead of thousands of kernel launches. Per-request work is
independent (BN statistics, inner steps and actions are per request), so
the padding changes no request's result. A server's graph calls are
serialised by a lock, so several threads may call one server. On the CPU
the same code runs eagerly. Inside ``utils/profiling.py:tracing`` a batched
call is a root span (``serve.batch``, ``serve.adapt_batched``) over the
graph's ``graphs.copy_in``, ``graphs.replay`` and ``graphs.clone_out``.

``mesh=`` (``parallel/mesh.py:make_task_mesh``, a server's mesh: one
process, a tuple of local devices) makes every bucket a multiple of the
device count, as JAX's do, and splits it into equal contiguous shards,
one a device (5 requests on 3 devices: the power of two 8 rounded up to
a bucket of 9, three a device). The params are placed on each device
once; each shard is served by its device's graph and the results are
concatenated on the first device. Per-request work has no collectives,
so a request's result is the one it gets in an unsharded batch.
"""

from __future__ import annotations

import torch

from exploring_meta_tpu_torch.adapt.maml import inner_sgd, per_task
from exploring_meta_tpu_torch.device import resolve_device
from exploring_meta_tpu_torch.models.cnn4 import (
    CNN4Spec, cnn4_apply, cnn4_features, cnn4_head_apply, init_cnn4,
)
from exploring_meta_tpu_torch.models import distributions as dist
from exploring_meta_tpu_torch.ops.losses import cross_entropy
from exploring_meta_tpu_torch.parallel.mesh import split_requests
from exploring_meta_tpu_torch.rl.adapt_rl import RLConfig, single_adapt_step
from exploring_meta_tpu_torch.rl.rollout import Trajectory
from exploring_meta_tpu_torch.utils.graphs import CapturedCalls
from exploring_meta_tpu_torch.utils.profiling import span
from exploring_meta_tpu_torch.utils.tree import tree_map


def _next_bucket(B: int, multiple: int = 1) -> int:
    """The next power of two >= B, rounded up to a multiple of
    ``multiple`` (a mesh's device count, which need not be a power of
    two): the request buckets, one program each."""
    b = 1
    while b < B:
        b *= 2
    if b % multiple:
        b = -(-b // multiple) * multiple
    return b


def _pad_leading(tree, pad: int):
    """Every leaf's leading axis padded by ``pad`` copies of its first
    slice, on its device."""
    if not pad:
        return tree
    return tree_map(lambda x: torch.cat(
        [x, x[:1].expand((pad,) + tuple(x.shape[1:]))]), tree)


def _placed(params, mesh, device):
    """``(params on device, {device: params there})`` over the devices the
    server serves on, detached; a mesh's first device is the server's
    device."""
    if mesh is not None and mesh.distributed:
        raise ValueError("a server takes a server mesh (make_task_mesh "
                         "outside a launch), not a rank's")
    params = tree_map(lambda t: t.detach().to(device), params)
    devices = (device,) if mesh is None else mesh.devices
    return params, {d: tree_map(lambda t: t.to(d), params)
                    for d in set(devices)}


def _sharded(mesh, fn, bucket: int, *stacks, rows=None):
    """``fn(device, *shards)`` on each of ``mesh``'s equal contiguous
    shards of ``stacks`` (trees with a leading axis of ``bucket``, a
    multiple of the mesh size), each moved to its device -> the per-shard
    outputs (trees of tensors) concatenated on the first device, cut to
    their first ``rows`` rows."""
    home = mesh.devices[0]
    outs = []
    for dev, a, b in split_requests(mesh, bucket):
        shards = [tree_map(lambda t: t[a:b].to(dev), s) for s in stacks]
        outs.append(fn(dev, *shards))
    return tree_map(lambda *xs: torch.cat([x.to(home) for x in xs])[:rows],
                    *outs)


class VisionServer:
    """Few-shot classification serving on a meta-trained CNN4.

    ``compute_dtype=torch.bfloat16`` runs adaptation and prediction in
    bf16 (the params are cast once, here; the inputs inside the served
    program); probabilities come back in f32 either way. ``device``
    defaults to the card; pass ``device="cpu"`` to serve on the CPU.
    ``mesh`` shards :meth:`batch` over its devices (the first is the
    server's device)."""

    def __init__(self, spec: CNN4Spec, params, *, inner_lr: float,
                 adapt_steps: int, anil: bool = False, compute_dtype=None,
                 device=None, mesh=None):
        self.spec = spec
        self.mesh = mesh
        self.device = (resolve_device(device) if mesh is None
                       else mesh.devices[0])
        self.inner_lr = inner_lr
        self.adapt_steps = adapt_steps
        self.anil = anil
        self.compute_dtype = compute_dtype
        self.params, placed = _placed(params, mesh, self.device)
        self._served_params = {
            d: p if compute_dtype is None else tree_map(
                lambda t: t.to(compute_dtype), p) for d, p in placed.items()}
        self._graphs = CapturedCalls()

    @classmethod
    def from_checkpoint(cls, path: str, spec: CNN4Spec, **kwargs):
        """Load a ``model.npz`` written by the JAX trainers or by
        :func:`~exploring_meta_tpu_torch.utils.experiment.flatten_params`."""
        from exploring_meta_tpu_torch.utils.experiment import load_params
        template = init_cnn4(torch.Generator().manual_seed(0), spec,
                             device="cpu")
        return cls(spec, load_params(path, template), **kwargs)

    def _inputs(self, support_x, support_y, query_x) -> tuple:
        def put(a, dtype=None):
            return torch.as_tensor(a, device=self.device, dtype=dtype)
        return (put(support_x, torch.float32), put(support_y).long(),
                put(query_x, torch.float32))

    def __call__(self, support_x, support_y, query_x):
        """Serve one request -> ``(predicted_labels [Q], probs [Q, ways])``:
        bucket 1, on the server's device (JAX's ``_one``)."""
        one = [a.unsqueeze(0) for a in self._inputs(support_x, support_y,
                                                    query_x)]
        preds, probs = self._served(self.device, *one)
        return preds[0], probs[0]

    _bucket = staticmethod(_next_bucket)

    def batch(self, support_x, support_y, query_x):
        """Serve B requests (leading axis) -> ``(preds [B, Q],
        probs [B, Q, ways])``, as the program of B's bucket."""
        with span("serve.batch") as root:
            inputs = self._inputs(support_x, support_y, query_x)
            B = inputs[0].shape[0]
            bucket = self._bucket(B, self.mesh.size if self.mesh else 1)
            root.note(rows=B, bucket=bucket)
            inputs = _pad_leading(inputs, bucket - B)
            if self.mesh is None:
                return self._served(self.device, *inputs, rows=B)
            return _sharded(self.mesh, self._served, bucket, *inputs,
                            rows=B)

    def _served(self, device, sx, sy, qx, rows=None):
        """:meth:`_serve` of a bucket on ``device`` as its graph."""
        params = self._served_params[device]
        return self._graphs("serve", lambda *xs: self._serve(params, *xs),
                            (sx, sy, qx), rows=rows)

    def _serve(self, p, sx, sy, qx):
        if self.compute_dtype is not None:
            sx, qx = sx.to(self.compute_dtype), qx.to(self.compute_dtype)
        B = sx.shape[0]
        spec = self.spec
        if self.anil:
            # The body encodes support+query jointly (batch-stat BN as in
            # meta-training), then only the head adapts.
            with torch.no_grad():
                feats = cnn4_features(p, spec, torch.cat([sx, qx], dim=1))
            f_s, f_q = feats[:, : sx.shape[1]], feats[:, sx.shape[1]:]

            def head_loss(head, batch):
                f, y = batch
                return cross_entropy(cnn4_head_apply({"head": head}, f),
                                     y).sum()

            head = inner_sgd(head_loss, per_task(p["head"], B), (f_s, sy),
                             self.inner_lr, self.adapt_steps, first_order=True)
            with torch.no_grad():
                logits = cnn4_head_apply({"head": head}, f_q)
        else:
            def loss(pp, batch):
                x, y = batch
                return cross_entropy(cnn4_apply(pp, spec, x), y).sum()

            adapted = inner_sgd(loss, per_task(p, B), (sx, sy),
                                self.inner_lr, self.adapt_steps,
                                first_order=True)
            with torch.no_grad():
                logits = cnn4_apply(adapted, spec, qx)
        probs = torch.softmax(logits.float(), dim=-1)
        return probs.argmax(dim=-1), probs


class PolicyServer:
    """Meta-RL serving: adapt a meta-trained policy to a new task from a
    collected support trajectory, then act.

    ``algo`` (``"vpg"``, ``"ppo"`` or ``"trpo"``) selects the inner step;
    ``cfg.adapt_steps`` is the default number of steps a request. ``act``
    is the deterministic action (production control): a Gaussian policy's
    mean, a categorical policy's (no ``density``) argmax of its logits;
    ``sample`` the stochastic action (training-time behaviour), for a
    categorical policy ``(action, {"log_prob"})``. ``device`` defaults to
    the card; pass ``device="cpu"`` to serve on the CPU. ``mesh`` shards
    the batched calls over its devices. Every call is bucketed and served
    as a graph as the module's docstring says; the single-request calls
    are bucket 1 on the server's device (JAX's ``_adapt``, ``_act`` and
    ``_sample``)."""

    def __init__(self, policy, params, cfg: RLConfig, algo: str = "vpg",
                 mesh=None, device=None):
        if algo not in ("vpg", "ppo", "trpo"):
            raise ValueError(f"unknown adaptation algorithm {algo!r}")
        self.policy = policy
        self.cfg = cfg
        self.algo = algo
        self.mesh = mesh
        self.device = (resolve_device(device) if mesh is None
                       else mesh.devices[0])
        self.params, self._params_on = _placed(params, mesh, self.device)
        self._graphs = CapturedCalls()

    @classmethod
    def from_checkpoint(cls, path: str, policy, cfg: RLConfig, **kwargs):
        """Load a ``model.npz`` / checkpoint written by either package's RL
        trainers; ``policy`` is the spec it was trained with."""
        from exploring_meta_tpu_torch.utils.experiment import load_params
        template = policy.init(torch.Generator().manual_seed(0), device="cpu")
        return cls(policy, load_params(path, template), cfg, **kwargs)

    def _as_input(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device)

    def _on_device(self, tree):
        return tree_map(self._as_input, tree)

    @torch.no_grad()
    def adapt(self, support, steps: int | None = None):
        """-> params adapted on one support trajectory ``[T, E, ...]`` by
        ``steps`` inner steps (default ``cfg.adapt_steps``; 0 returns the
        meta-params). Served as bucket 1 on the server's device."""
        one = Trajectory(*(self._as_input(x).unsqueeze(0) for x in support))
        steps = self.cfg.adapt_steps if steps is None else steps
        return tree_map(lambda t: t[0], self._adapted(self.device, one,
                                                      steps))

    @torch.no_grad()
    def adapt_batched(self, support_stack, steps: int | None = None):
        """Adapt to ``n`` tasks at once: ``support_stack`` has a leading
        task axis ``[n, T, E, ...]`` -> per-task params ``[n, ...]``, with
        the same ``steps`` budget as :meth:`adapt`. The stack is padded to
        its bucket and the whole ``steps``-step inner loop is one graph
        per (bucket, shapes, steps)."""
        with span("serve.adapt_batched") as root:
            support = Trajectory(*(self._as_input(x)
                                   for x in support_stack))
            steps = self.cfg.adapt_steps if steps is None else steps
            n = support.reward.shape[0]
            bucket = _next_bucket(n, self.mesh.size if self.mesh else 1)
            root.note(rows=n, bucket=bucket, steps=steps)
            support = _pad_leading(support, bucket - n)
            if self.mesh is None:
                return self._adapted(self.device, support, steps, rows=n)
            return _sharded(self.mesh, lambda d, sup: self._adapted(
                d, sup, steps), bucket, support, rows=n)

    def _adapted(self, device, support: Trajectory, steps: int, rows=None):
        meta = self._params_on[device]
        if not steps:
            return per_task(meta, rows or support.reward.shape[0])
        return self._graphs(("adapt", steps), lambda sup: self._adapt(
            meta, sup, steps), (support,), rows=rows)

    def _adapt(self, meta_params, support: Trajectory, steps: int):
        params = per_task(meta_params, support.reward.shape[0])
        for _ in range(steps):
            params = single_adapt_step(self.algo, self.policy, params,
                                       support, self.cfg)
        return params

    def _dist(self, params, obs) -> tuple:
        """The action distribution's parameters: ``(loc, scale)``, or a
        categorical policy's ``(logits,)``."""
        if hasattr(self.policy, "density"):
            return self.policy.density(params, obs)
        return (self.policy.logits(params, obs),)

    def _draw(self, gen: torch.Generator, dparams):
        if len(dparams) == 2:
            return dist.normal_sample(gen, *dparams)
        action = dist.categorical_sample(gen, dparams[0])
        return action, {"log_prob": dist.categorical_log_prob(dparams[0],
                                                              action)}

    def _act(self, params, obs):
        return self._deterministic(self._dist(params, obs))

    def _sample(self, gen: torch.Generator, params, obs):
        return self._draw(gen, self._dist(params, obs))

    def _bucketed(self, params_stack, obs_stack) -> tuple:
        """``(n, bucket, (params, obs) on the device padded to the
        bucket)`` of a fleet call (JAX's ``_fleet_call``)."""
        stacks = (self._on_device(params_stack), self._as_input(obs_stack))
        n = stacks[1].shape[0]
        bucket = _next_bucket(n, self.mesh.size if self.mesh else 1)
        return n, bucket, _pad_leading(stacks, bucket - n)

    def _per_shard(self, key, fn, bucket: int, stacks, rows=None):
        """``fn(params, obs)`` on each device's shard, as its graph."""
        return _sharded(self.mesh, lambda d, p, o: self._graphs(
            key, fn, (p, o)), bucket, *stacks, rows=rows)

    @torch.no_grad()
    def sample(self, params, gen: torch.Generator, obs):
        """Stochastic actions ``[E, act]`` for observations ``[E, obs]``
        (a categorical policy: ``(actions [E], {"log_prob"})``)."""
        return self._graphs("sample", self._sample, (self._on_device(params),
                                                     self._as_input(obs)),
                            generator=gen)

    @torch.no_grad()
    def act(self, params, obs) -> torch.Tensor:
        """Deterministic actions ``[E, act]``: the Gaussian mean, or the
        argmax of a categorical policy's logits ``[E]``."""
        return self._graphs("act", self._act, (self._on_device(params),
                                               self._as_input(obs)))

    @staticmethod
    def _deterministic(dparams) -> torch.Tensor:
        return dparams[0] if len(dparams) == 2 else dparams[0].argmax(-1)

    @torch.no_grad()
    def act_batched(self, params_stack, obs_stack) -> torch.Tensor:
        """:meth:`act` for ``n`` tasks' adapted params ``[n, ...]`` on their
        own observations ``[n, E, obs]`` -> ``[n, E, act]``, in one call:
        the graph of n's bucket."""
        n, bucket, stacks = self._bucketed(params_stack, obs_stack)
        if self.mesh is None:
            return self._graphs("act", self._act, stacks, rows=n)
        return self._per_shard("act", self._act, bucket, stacks, rows=n)

    @torch.no_grad()
    def sample_batched(self, params_stack, gen: torch.Generator, obs_stack):
        """Stochastic :meth:`act_batched`. One generator serves the fleet
        (JAX takes a key per task) and draws for the whole bucket; any
        generator on the device replays the bucket's one graph. With a
        mesh the distributions are computed on the shards and the draw is
        made for the whole bucket on the first device, so it is the
        unsharded batch's where the two buckets are equal."""
        n, bucket, stacks = self._bucketed(params_stack, obs_stack)
        if self.mesh is None:
            return self._graphs("sample", self._sample, stacks, rows=n,
                                generator=gen)
        dparams = self._per_shard("dist", lambda p, o: list(
            self._dist(p, o)), bucket, stacks)
        return self._graphs("draw", lambda g, *d: self._draw(g, d),
                            tuple(dparams), rows=n, generator=gen)
