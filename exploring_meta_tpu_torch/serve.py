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

Eager PyTorch compiles nothing per batch size, so both servers serve
exactly B requests; the JAX servers' power-of-two buckets, which bound
XLA compiles, have no counterpart here.

``mesh=`` (``parallel/mesh.py:make_task_mesh``, a server's mesh: one
process, a tuple of local devices) splits the request axis into
contiguous shards, one a device (a ragged batch leaves the last devices
idle: 5 requests on 8 devices run one a device on the first five). The
params are placed on each device once; each shard is served on its
device and the results are concatenated on the first device. Per-request
work has no collectives, so a request's result is the one it gets in an
unsharded batch.
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
from exploring_meta_tpu_torch.parallel.mesh import map_leaves, split_requests
from exploring_meta_tpu_torch.rl.adapt_rl import RLConfig, single_adapt_step
from exploring_meta_tpu_torch.rl.rollout import Trajectory
from exploring_meta_tpu_torch.utils.tree import tree_leaves, tree_map


def _placed(params, mesh, device):
    """``(params on device, {device: params there} for a mesh's devices)``,
    detached; a mesh's first device is the server's device."""
    if mesh is not None and mesh.distributed:
        raise ValueError("a server takes a server mesh (make_task_mesh "
                         "outside a launch), not a rank's")
    params = tree_map(lambda t: t.detach().to(device), params)
    if mesh is None:
        return params, None
    return params, {d: tree_map(lambda t: t.to(d), params)
                    for d in set(mesh.devices)}


def _sharded(mesh, fn, n: int, *stacks):
    """``fn(device, *shards)`` on each of ``mesh``'s contiguous request
    shards of ``stacks`` (trees with a leading axis of ``n``), each moved
    to its device -> the per-shard outputs (trees of tensors) concatenated
    on the first device."""
    home = mesh.devices[0]
    outs = []
    for dev, a, b in split_requests(mesh, n):
        shards = [map_leaves(lambda t: t[a:b].to(dev), s) for s in stacks]
        outs.append(fn(dev, *shards))
    return map_leaves(lambda *xs: torch.cat([x.to(home) for x in xs]),
                       *outs)


class VisionServer:
    """Few-shot classification serving on a meta-trained CNN4.

    ``compute_dtype=torch.bfloat16`` runs adaptation and prediction in
    bf16; probabilities come back in f32 either way. ``device`` defaults
    to the card; pass ``device="cpu"`` to serve on the CPU. ``mesh``
    shards :meth:`batch` over its devices (the first is the server's
    device)."""

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
        self.params, self._mesh_params = _placed(params, mesh, self.device)

    @classmethod
    def from_checkpoint(cls, path: str, spec: CNN4Spec, **kwargs):
        """Load a ``model.npz`` written by the JAX trainers or by
        :func:`~exploring_meta_tpu_torch.utils.experiment.flatten_params`."""
        from exploring_meta_tpu_torch.utils.experiment import load_params
        template = init_cnn4(torch.Generator().manual_seed(0), spec,
                             device="cpu")
        return cls(spec, load_params(path, template), **kwargs)

    def _as_input(self, a, dtype=None) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device, dtype=dtype)

    def __call__(self, support_x, support_y, query_x):
        """Serve one request -> ``(predicted_labels [Q], probs [Q, ways])``."""
        preds, probs = self.batch(*(self._as_input(a).unsqueeze(0)
                                    for a in (support_x, support_y, query_x)))
        return preds[0], probs[0]

    def batch(self, support_x, support_y, query_x):
        """Serve B requests (leading axis) -> ``(preds [B, Q],
        probs [B, Q, ways])``."""
        sx = self._as_input(support_x, torch.float32)
        qx = self._as_input(query_x, torch.float32)
        sy = self._as_input(support_y).long()
        if self.mesh is None:
            return self._serve(self.params, sx, sy, qx)
        return _sharded(self.mesh, lambda d, *xs: self._serve(
            self._mesh_params[d], *xs), sx.shape[0], sx, sy, qx)

    def _serve(self, p, sx, sy, qx):
        if self.compute_dtype is not None:
            p = tree_map(lambda t: t.to(self.compute_dtype), p)
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
    the batched calls over its devices."""

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
        self.params, self._mesh_params = _placed(params, mesh, self.device)

    @classmethod
    def from_checkpoint(cls, path: str, policy, cfg: RLConfig, **kwargs):
        """Load a ``model.npz`` / checkpoint written by either package's RL
        trainers; ``policy`` is the spec it was trained with."""
        from exploring_meta_tpu_torch.utils.experiment import load_params
        template = policy.init(torch.Generator().manual_seed(0), device="cpu")
        return cls(policy, load_params(path, template), cfg, **kwargs)

    def _as_input(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device)

    @torch.no_grad()
    def adapt(self, support, steps: int | None = None):
        """-> params adapted on one support trajectory ``[T, E, ...]`` by
        ``steps`` inner steps (default ``cfg.adapt_steps``; 0 returns the
        meta-params). Served as a batch of one request."""
        one = Trajectory(*(self._as_input(x).unsqueeze(0) for x in support))
        return tree_map(lambda t: t[0], self.adapt_batched(one, steps))

    @torch.no_grad()
    def adapt_batched(self, support_stack, steps: int | None = None):
        """Adapt to ``n`` tasks at once: ``support_stack`` has a leading
        task axis ``[n, T, E, ...]`` -> per-task params ``[n, ...]``, with
        the same ``steps`` budget as :meth:`adapt`."""
        support = Trajectory(*(self._as_input(x) for x in support_stack))
        steps = self.cfg.adapt_steps if steps is None else steps
        if self.mesh is None:
            return self._adapt(self.params, support, steps)
        return _sharded(self.mesh, lambda d, sup: self._adapt(
            self._mesh_params[d], sup, steps), support.reward.shape[0],
            support)

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

    def _fleet_dist(self, params_stack, obs_stack) -> tuple:
        """:meth:`_dist` of ``n`` tasks' params on their observations,
        sharded over the mesh when there is one."""
        obs_stack = self._as_input(obs_stack)
        if self.mesh is None:
            return self._dist(params_stack, obs_stack)
        n = tree_leaves(params_stack)[0].shape[0]
        return tuple(_sharded(self.mesh, lambda d, p, o: list(
            self._dist(p, o)), n, params_stack, obs_stack))

    @torch.no_grad()
    def sample(self, params, gen: torch.Generator, obs):
        """Stochastic actions ``[E, act]`` for observations ``[E, obs]``
        (a categorical policy: ``(actions [E], {"log_prob"})``)."""
        return self._draw(gen, self._dist(params, self._as_input(obs)))

    @torch.no_grad()
    def act(self, params, obs) -> torch.Tensor:
        """Deterministic actions ``[E, act]``: the Gaussian mean, or the
        argmax of a categorical policy's logits ``[E]``."""
        return self._deterministic(self._dist(params, self._as_input(obs)))

    @staticmethod
    def _deterministic(dparams) -> torch.Tensor:
        return dparams[0] if len(dparams) == 2 else dparams[0].argmax(-1)

    @torch.no_grad()
    def act_batched(self, params_stack, obs_stack) -> torch.Tensor:
        """:meth:`act` for ``n`` tasks' adapted params ``[n, ...]`` on their
        own observations ``[n, E, obs]`` -> ``[n, E, act]``, in one call."""
        return self._deterministic(self._fleet_dist(params_stack, obs_stack))

    @torch.no_grad()
    def sample_batched(self, params_stack, gen: torch.Generator, obs_stack):
        """Stochastic :meth:`act_batched`. One generator serves the fleet
        (JAX takes a key per task): with a mesh the distributions are
        computed on the shards and the draw is made for the whole fleet on
        the first device, so it is the unsharded batch's."""
        return self._draw(gen, self._fleet_dist(params_stack, obs_stack))
