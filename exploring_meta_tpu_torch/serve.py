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
"""

from __future__ import annotations

import torch

from exploring_meta_tpu_torch.adapt.maml import inner_sgd, per_task
from exploring_meta_tpu_torch.device import resolve_device
from exploring_meta_tpu_torch.models.cnn4 import (
    CNN4Spec, cnn4_apply, cnn4_features, cnn4_head_apply, init_cnn4,
)
from exploring_meta_tpu_torch.ops.losses import cross_entropy
from exploring_meta_tpu_torch.rl.adapt_rl import RLConfig, single_adapt_step
from exploring_meta_tpu_torch.rl.rollout import Trajectory
from exploring_meta_tpu_torch.utils.tree import tree_map


class VisionServer:
    """Few-shot classification serving on a meta-trained CNN4.

    ``compute_dtype=torch.bfloat16`` runs adaptation and prediction in
    bf16; probabilities come back in f32 either way. ``device`` defaults
    to the card; pass ``device="cpu"`` to serve on the CPU."""

    def __init__(self, spec: CNN4Spec, params, *, inner_lr: float,
                 adapt_steps: int, anil: bool = False, compute_dtype=None,
                 device=None):
        self.spec = spec
        self.device = resolve_device(device)
        self.inner_lr = inner_lr
        self.adapt_steps = adapt_steps
        self.anil = anil
        self.compute_dtype = compute_dtype
        self.params = tree_map(lambda t: t.detach().to(self.device), params)

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
        p = self.params
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
    is the deterministic Gaussian mean (production control), ``sample``
    the stochastic action (training-time behaviour). ``device`` defaults
    to the card; pass ``device="cpu"`` to serve on the CPU."""

    def __init__(self, policy, params, cfg: RLConfig, algo: str = "vpg",
                 mesh=None, device=None):
        if algo not in ("vpg", "ppo", "trpo"):
            raise ValueError(f"unknown adaptation algorithm {algo!r}")
        if mesh is not None:
            raise NotImplementedError(
                "PolicyServer: mesh is not ported yet (ROADMAP Queue 1, "
                "later slices: scale-out)")
        if not hasattr(policy, "density"):
            raise NotImplementedError(
                f"PolicyServer: {type(policy).__name__} is not ported yet "
                "(ROADMAP Queue 1, later slices: ANIL and the Adam outer "
                "paths, its remaining policies)")
        self.policy = policy
        self.cfg = cfg
        self.algo = algo
        self.device = resolve_device(device)
        self.params = tree_map(lambda t: t.detach().to(self.device), params)

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
        params = per_task(self.params, support.reward.shape[0])
        for _ in range(self.cfg.adapt_steps if steps is None else steps):
            params = single_adapt_step(self.algo, self.policy, params,
                                       support, self.cfg)
        return params

    @torch.no_grad()
    def sample(self, params, gen: torch.Generator, obs) -> torch.Tensor:
        """Stochastic actions ``[E, act]`` for observations ``[E, obs]``."""
        return self.policy.sample(params, gen, self._as_input(obs))

    @torch.no_grad()
    def act(self, params, obs) -> torch.Tensor:
        """Deterministic actions (the Gaussian mean) ``[E, act]``."""
        return self.policy.density(params, self._as_input(obs))[0]

    def act_batched(self, params_stack, obs_stack) -> torch.Tensor:
        """:meth:`act` for ``n`` tasks' adapted params ``[n, ...]`` on their
        own observations ``[n, E, obs]`` -> ``[n, E, act]``, in one call."""
        return self.act(params_stack, obs_stack)

    def sample_batched(self, params_stack, gen: torch.Generator,
                       obs_stack) -> torch.Tensor:
        """Stochastic :meth:`act_batched`. One generator serves the fleet
        (JAX takes a key per task)."""
        return self.sample(params_stack, gen, obs_stack)
