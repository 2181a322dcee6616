"""TRPO meta-optimization: the natural-gradient outer step (port of
``exploring_meta_tpu/rl/trpo_meta.py``; reference ``meta_optimize_trpo`` +
``meta_surrogate_loss``, ``core_functions/rl.py:409-473``).

The surrogate re-runs every task's inner adaptation from the stored
replays with a second-order graph; the step direction is a
conjugate-gradient solve against the Fisher (the Hessian of the mean KL),
scaled to the trust region, then accepted by a backtracking line search.

JAX differentiates ``jvp(grad(kl))`` inside one XLA program. Here
``grad(kl)`` is taken once with a graph, and each Fisher-vector product is
one double backward through it (``ops/cg.py``). CG runs a fixed number of
iterations with no host sync; the line search reads its accept flag on the
host once per step, at most ``ls_max_steps`` times.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from exploring_meta_tpu_torch.models.distributions import (
    normal_kl, normal_log_prob,
)
from exploring_meta_tpu_torch.ops.cg import (
    conjugate_gradient, grad_vector_product,
)
from exploring_meta_tpu_torch.ops.losses import trpo_policy_loss
from exploring_meta_tpu_torch.rl.adapt_rl import (
    RLConfig, masked_mean, masked_normalize, per_task, traj_advantages,
    trpo_update,
)
from exploring_meta_tpu_torch.rl.rollout import Trajectory, stack_trajectories
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
                        cfg: RLConfig, adapt_steps: int):
    """-> (mean surrogate loss, mean KL(new || old)) over the tasks.

    ``params`` are the shared meta-params; ``replays`` is ``[B, steps+1,
    T, E, ...]`` with the query set last on axis 1; ``old_params_stack``
    are the per-task adapted params of collection time."""
    new_params = per_task(params, replays.reward.shape[0])
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
    return surrogate.mean(), kl.mean()


def _ravel(params):
    """Params tree -> (flat detached vector, unravel: vector -> tree of
    views, differentiable)."""
    leaves = tree_leaves(params)
    shapes = [leaf.shape for leaf in leaves]
    sizes = [math.prod(s) for s in shapes]

    def unravel(flat):
        pieces = torch.split(flat, sizes)
        return tree_unflatten(params, [p.reshape(s)
                                       for p, s in zip(pieces, shapes)])

    flat = torch.cat([leaf.detach().reshape(-1) for leaf in leaves])
    return flat, unravel


def meta_optimize_trpo(policy, params, old_params_stack, replays,
                       cfg: RLConfig, trpo_cfg: TRPOConfig,
                       adapt_steps: int):
    """One TRPO outer step -> (new params, ``{"old_loss", "accepted"}``)
    (reference ``meta_optimize_trpo``, ``rl.py:409-438``)."""
    flat0, unravel = _ravel(params)

    def loss_kl(flat):
        return meta_surrogate_loss(policy, unravel(flat), old_params_stack,
                                   replays, cfg, adapt_steps)

    x = flat0.clone().requires_grad_()
    with torch.enable_grad():
        old_loss, kl = loss_kl(x)
        (grad_flat,) = torch.autograd.grad(old_loss, x, retain_graph=True)
        (grad_kl,) = torch.autograd.grad(kl, x, create_graph=True)
    Fvp = grad_vector_product(grad_kl, x, trpo_cfg.damping)

    step = conjugate_gradient(Fvp, grad_flat,
                              num_iterations=trpo_cfg.cg_iterations)
    shs = 0.5 * torch.dot(step, Fvp(step))
    step = step / torch.sqrt(shs / trpo_cfg.max_kl)
    del Fvp, grad_kl
    old_loss = old_loss.detach()

    # backtracking line search: the first candidate that improves the
    # surrogate inside the KL bound is taken
    final, accepted = flat0, False
    with torch.no_grad():
        for ls_step in range(trpo_cfg.ls_max_steps):
            stepsize = (trpo_cfg.backtrack_factor ** ls_step
                        * trpo_cfg.outer_lr)
            candidate = flat0 - stepsize * step
            new_loss, kl = loss_kl(candidate)
            if bool((new_loss < old_loss) & (kl < trpo_cfg.max_kl)):
                final, accepted = candidate, True
                break
    new_params = tree_map(lambda t: t.detach().clone(), unravel(final))
    return new_params, {"old_loss": old_loss, "accepted": accepted}


def make_trpo_meta_step(policy, cfg: RLConfig, trpo_cfg: TRPOConfig,
                        adapt_steps: int):
    """``(params, old_params_stack, replays) -> (params, info)``."""
    def step(params, old_params_stack, replays):
        return meta_optimize_trpo(policy, params, old_params_stack, replays,
                                  cfg, trpo_cfg, adapt_steps)
    return step
