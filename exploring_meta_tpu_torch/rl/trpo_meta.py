"""TRPO meta-optimization: the natural-gradient outer step (port of
``exploring_meta_tpu/rl/trpo_meta.py``; reference ``meta_optimize_trpo`` +
``meta_surrogate_loss``, ``core_functions/rl.py:409-473``).

The surrogate re-runs every task's inner adaptation from the stored
replays with a second-order graph (on the head and sigma only, on
detached body features, when ``cfg.anil``); the step direction is a
conjugate-gradient solve against the Fisher (the Hessian of the mean KL),
scaled to the trust region, then accepted by a backtracking line search.

JAX differentiates ``jvp(grad(kl))`` inside one XLA program. Here
``grad(kl)`` is taken once with a graph, and each Fisher-vector product is
one double backward through it (``ops/cg.py``). CG runs a fixed number of
iterations with no host sync. The line search takes the first candidate
that is accepted, as JAX's ``lax.while_loop`` does, in one of two ways: the
per-iteration path reads each candidate's accept flag on the host and stops
at the first accepted one; the fused path (``host_free=True``, captured in
a CUDA graph, which cannot stop early) evaluates all ``ls_max_steps``
candidates and selects the first accepted one on the device, with no read
back. Both give the same params. The step itself
(:func:`natural_gradient_step`) also takes the single-task TRPO
baseline's (``trainers/baselines.py``).

A one-program seed sweep (``seeds=S``, ``parallel/multiseed.py``) steps
``S`` seeds' stacked params as flat ``[S, P]`` rows: the surrogate and KL
come out per seed, their sums are differentiated (the Fisher of the summed
KLs is block-diagonal over seeds, so one Fisher-vector product gives every
seed's), CG runs per row (``ops/cg.py``), and the host-free line search
takes each seed's first accepted candidate on its own: a seed that accepts
nothing keeps its params whatever the others do.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from exploring_meta_tpu_torch.adapt.maml import task_copies
from exploring_meta_tpu_torch.models.distributions import (
    normal_kl, normal_log_prob,
)
from exploring_meta_tpu_torch.ops.cg import (
    conjugate_gradient, dot, grad_vector_product,
)
from exploring_meta_tpu_torch.ops.losses import trpo_policy_loss
from exploring_meta_tpu_torch.parallel.multiseed import seed_means
from exploring_meta_tpu_torch.rl.adapt_rl import (
    RLConfig, masked_mean, masked_normalize, traj_advantages, trpo_update,
)
from exploring_meta_tpu_torch.rl.rollout import Trajectory, stack_trajectories
from exploring_meta_tpu_torch.utils.profiling import span
from exploring_meta_tpu_torch.utils.tree import (
    tree_leaves, tree_map, tree_unflatten,
)


class TRPOConfig(NamedTuple):
    """Outer-step hyperparameters (reference ``rl/maml_trpo.py:19-40``)."""
    outer_lr: float = 0.1
    max_kl: float = 0.01
    ls_max_steps: int = 15
    backtrack_factor: float = 0.5
    cg_iterations: int = 10
    damping: float = 1e-5


def stack_replays(replay) -> Trajectory:
    """List over (adapt_steps + 1) of task-batch Trajectories ``[B, T, E,
    ...]`` -> one Trajectory ``[B, steps + 1, T, E, ...]``."""
    return stack_trajectories(replay, dim=1)


def meta_surrogate_loss(policy, params, old_params_stack, replays: Trajectory,
                        cfg: RLConfig, adapt_steps: int,
                        seeds: int | None = None):
    """-> (mean surrogate loss, mean KL(new || old)) over the tasks.

    ``params`` are the shared meta-params; ``replays`` is ``[B, steps+1,
    T, E, ...]`` with the query set last on axis 1; ``old_params_stack``
    are the per-task adapted params of collection time. With ``seeds``,
    ``params`` are stacked ``[S, ...]`` and both means are ``[S]``, one a
    seed over its share of the tasks."""
    new_params = task_copies(params, replays.reward.shape[0], seeds)
    # re-run the inner adaptation with the full second-order graph
    for i in range(adapt_steps):
        support = replays.map(lambda x: x[:, i])
        new_params = trpo_update(policy, new_params, support, cfg,
                                 first_order=False)

    query = replays.map(lambda x: x[:, -1])
    states = query.flat(query.state)
    actions = query.flat(query.action)
    valid = query.flat(query.valid).unsqueeze(-1)
    old_loc, old_scale = policy.density(old_params_stack, states)
    new_loc, new_scale = policy.density(new_params, states)
    kl = masked_mean(normal_kl(new_loc, new_scale, old_loc, old_scale), valid)

    adv, _ = traj_advantages(query, cfg)
    adv = masked_normalize(query.flat(adv), query.flat(query.valid)).detach()
    old_lp = normal_log_prob(old_loc, old_scale, actions).mean(
        dim=-1, keepdim=True).detach()
    new_lp = normal_log_prob(new_loc, new_scale, actions).mean(
        dim=-1, keepdim=True)
    surrogate = trpo_policy_loss(new_lp, old_lp, adv.unsqueeze(-1),
                                 valid=valid)
    return seed_means(surrogate, seeds), seed_means(kl, seeds)


def ravel(params, seeds: int | None = None):
    """Params tree -> (flat detached vector, unravel: vector -> tree of
    views, differentiable). ``seeds``: stacked ``[S, ...]`` params ->
    ``[S, P]`` rows, one a seed."""
    lead = () if seeds is None else (seeds,)
    leaves = tree_leaves(params)
    shapes = [tuple(leaf.shape[len(lead):]) for leaf in leaves]
    sizes = [math.prod(s) for s in shapes]

    def unravel(flat):
        pieces = torch.split(flat, sizes, dim=-1)
        return tree_unflatten(params, [p.reshape(lead + s)
                                       for p, s in zip(pieces, shapes)])

    flat = torch.cat([leaf.detach().reshape(lead + (-1,))
                      for leaf in leaves], dim=-1)
    return flat, unravel


def natural_gradient_step(loss_kl, flat0: torch.Tensor,
                          trpo_cfg: TRPOConfig, host_free: bool = False,
                          reduce=None):
    """The TRPO step of ``loss_kl(flat) -> (surrogate, mean KL)``, two
    scalars, from the flat params ``flat0``: the CG solve against the
    damped Fisher (the Hessian of the KL), scaled to the trust region, then
    the backtracking line search -> (the first accepted candidate, or
    ``flat0``; ``{"old_loss", "accepted"}``, and on the early-exit path
    ``"index"``, the accepted candidate's, -1 for none). ``accepted`` is a
    Python bool, or with ``host_free`` a device bool (no host sync).

    ``flat0`` may be ``[S, P]``, one row a seed, with ``loss_kl`` giving
    ``[S]`` surrogates and KLs: every step is then per row (the line
    search host-free, each row taking its own first accepted candidate)
    and ``old_loss`` and ``accepted`` are ``[S]``.

    ``reduce`` (a mesh's ``pmean``; ``loss_kl`` then covers this rank's
    shard of the tasks) averages over the ranks what JAX's
    ``_make_local_trpo_outer`` averages: the surrogate and its gradient,
    each Fisher-vector product (before the damping), and each line-search
    candidate's loss and KL, so every rank takes the same step. The
    host-free search evaluates every candidate first and reduces their
    ``[ls_max_steps, 2]`` values in one collective."""
    rows = flat0.ndim == 2
    if rows and not host_free:
        raise ValueError("a step of several seeds' rows runs the host-free "
                         "line search (host_free=True)")
    total = (lambda v: v.sum()) if rows else (lambda v: v)
    x = flat0.clone().requires_grad_()
    with torch.enable_grad():
        old_loss, kl = loss_kl(x)
        (grad_flat,) = torch.autograd.grad(total(old_loss), x,
                                           retain_graph=True)
        (grad_kl,) = torch.autograd.grad(total(kl), x, create_graph=True)
    old_loss = old_loss.detach()
    if reduce is not None:
        old_loss, grad_flat = reduce(old_loss, grad_flat)
    Fvp = grad_vector_product(grad_kl, x, trpo_cfg.damping, reduce=reduce)

    step = conjugate_gradient(Fvp, grad_flat,
                              num_iterations=trpo_cfg.cg_iterations)
    shs = 0.5 * dot(step, Fvp(step))
    step = step / torch.sqrt(shs / trpo_cfg.max_kl)
    del Fvp, grad_kl

    # backtracking line search: the first candidate that improves the
    # surrogate inside the KL bound is taken
    final, accepted, index = flat0, False, -1
    sizes = [trpo_cfg.backtrack_factor ** i * trpo_cfg.outer_lr
             for i in range(trpo_cfg.ls_max_steps)]
    with torch.no_grad(), span("trpo_line_search", ranged=True):
        if host_free:
            accepted = torch.zeros(old_loss.shape, dtype=torch.bool,
                                   device=flat0.device)
            candidates = [flat0 - size * step for size in sizes]
            values = [loss_kl(c) for c in candidates]
            if reduce is not None:
                both = reduce(torch.stack([torch.stack(v) for v in values]))
                values = [tuple(v) for v in both]
            for candidate, (new_loss, kl) in zip(candidates, values):
                ok = (new_loss < old_loss) & (kl < trpo_cfg.max_kl)
                take = ok & ~accepted
                final = torch.where(take.unsqueeze(-1), candidate, final)
                accepted = accepted | take
        else:
            for ls_step, size in enumerate(sizes):
                candidate = flat0 - size * step
                new_loss, kl = loss_kl(candidate)
                if reduce is not None:
                    new_loss, kl = reduce(new_loss, kl)
                if bool((new_loss < old_loss) & (kl < trpo_cfg.max_kl)):
                    final, accepted, index = candidate, True, ls_step
                    break
    info = {"old_loss": old_loss, "accepted": accepted}
    if not host_free:
        info["index"] = index
    return final, info


def meta_optimize_trpo(policy, params, old_params_stack, replays,
                       cfg: RLConfig, trpo_cfg: TRPOConfig,
                       adapt_steps: int, host_free: bool = False,
                       seeds: int | None = None, reduce=None):
    """One TRPO outer step -> (new params, the info of
    :func:`natural_gradient_step`) (reference ``meta_optimize_trpo``,
    ``rl.py:409-438``); with ``seeds``, one step of each seed's stacked
    params on its share of the replays; with ``reduce``, the sharded step
    on this rank's replays."""
    flat0, unravel = ravel(params, seeds)

    def loss_kl(flat):
        return meta_surrogate_loss(policy, unravel(flat), old_params_stack,
                                   replays, cfg, adapt_steps, seeds)

    final, info = natural_gradient_step(loss_kl, flat0, trpo_cfg,
                                        host_free=host_free, reduce=reduce)
    new_params = tree_map(lambda t: t.detach().clone(), unravel(final))
    return new_params, info


def make_trpo_meta_step(policy, cfg: RLConfig, trpo_cfg: TRPOConfig,
                        adapt_steps: int, host_free: bool = False,
                        seeds: int | None = None, reduce=None):
    """``(params, old_params_stack, replays) -> (params, info)``."""
    def step(params, old_params_stack, replays):
        return meta_optimize_trpo(policy, params, old_params_stack, replays,
                                  cfg, trpo_cfg, adapt_steps,
                                  host_free=host_free, seeds=seeds,
                                  reduce=reduce)
    return step
