"""Meta-RL fast adaptation, the TRPO part (port of
``exploring_meta_tpu/rl/adapt_rl.py``; reference ``core_functions/rl.py``).

JAX ``vmap``-s these functions over tasks. Here the task axis is written
out: every trajectory is a task batch ``[B, T, E, ...]``, per-task params
carry a leading ``[B]`` on every leaf, and every loss and metric is a
``[B]`` vector, one value per task. An inner step differentiates the sum
of the per-task losses with respect to per-task params, so each task
adapts on its own data only.

Masking: trajectories are fixed-shape with a ``valid`` mask, and every
reduction is valid-weighted (PARITY D7). Sampled actions are data
(rollout.py), so no reparameterization path reaches the meta-gradient.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from exploring_meta_tpu_torch.adapt.maml import inner_sgd
from exploring_meta_tpu_torch.ops.gae import compute_advantages, discount
from exploring_meta_tpu_torch.ops.losses import a2c_policy_loss
from exploring_meta_tpu_torch.ops.value import fit_linear_value, linear_value
from exploring_meta_tpu_torch.rl.rollout import Trajectory, stack_trajectories
from exploring_meta_tpu_torch.utils.tree import tree_map


class RLConfig(NamedTuple):
    """Hyperparameters of the RL fast-adapt paths (the reference's
    per-script ``params`` dict, e.g. ``rl/maml_trpo.py:19-40``)."""
    inner_lr: float = 0.1
    gamma: float = 0.99
    tau: float = 1.0
    adapt_steps: int = 1
    adapt_batch_size: int = 20    # episodes per rollout
    max_path_length: int = 100    # horizon
    first_order: bool = False
    flat_timestep: bool = False   # True: cherry's LinearValue time feature,
                                  # the row index of the flat concatenated
                                  # replay (crossing episodes); default is
                                  # the within-episode index (PARITY.md)
    value_reg: float = 1e-5       # LinearValue ridge; the reference passes
                                  # the action size here by accident (2.0
                                  # on Particles2D, PARITY D9)


def per_task(params, B: int):
    """Shared params -> ``[B, ...]`` copies, one per task (differentiable
    with respect to the shared params)."""
    return tree_map(lambda t: t.unsqueeze(0).expand((B,) + tuple(t.shape))
                    .contiguous(), params)


def _per_task_sum(x: torch.Tensor) -> torch.Tensor:
    return x.flatten(1).sum(dim=1)


def masked_mean(x, mask) -> torch.Tensor:
    """``[B]`` mean of ``x`` over the valid entries of each task."""
    mask = mask.expand_as(x)
    return _per_task_sum(x * mask) / _per_task_sum(mask).clamp(min=1.0)


def masked_normalize(x, mask, epsilon: float = 1e-8) -> torch.Tensor:
    """``(x - mean) / (std + eps)`` over each task's valid entries,
    Bessel-corrected (``ch.normalize`` on a real-steps-only replay)."""
    n = _per_task_sum(mask).clamp(min=2.0)
    view = (-1,) + (1,) * (x.ndim - 1)
    centered = x - masked_mean(x, mask).view(view)
    var = _per_task_sum(centered ** 2 * mask) / (n - 1.0)
    return centered / (torch.sqrt(var).view(view) + epsilon)


def traj_advantages(traj: Trajectory, cfg: RLConfig, update_vf: bool = True,
                    baseline_w=None):
    """GAE advantages of a task batch, after fitting the linear baseline on
    the discounted returns (reference ``compute_advantages``,
    ``rl.py:95-110``) -> (advantages ``[B, T, E]``, baseline ``[B, D, 1]``)."""
    returns = discount(cfg.gamma, traj.reward, traj.done)
    flat_states = traj.flat(traj.state)
    if cfg.flat_timestep:
        # cherry's time feature: the row of the flat concatenated-episodes
        # replay, row(t, e) = sum(len(ep < e)) + t, used for next states too
        lengths = traj.valid.sum(dim=-2)
        offsets = (torch.cumsum(lengths, dim=-1) - lengths).to(
            traj.timestep.dtype)
        flat_t = traj.flat(traj.timestep + offsets.unsqueeze(-2))
        next_t = flat_t
    else:
        flat_t = traj.flat(traj.timestep)
        next_t = flat_t + 1
    if update_vf or baseline_w is None:
        baseline_w = fit_linear_value(flat_states, flat_t,
                                      traj.flat(returns), reg=cfg.value_reg,
                                      weights=traj.flat(traj.valid))
    shape = traj.reward.shape
    values = linear_value(baseline_w, flat_states, flat_t).reshape(shape)
    next_values = linear_value(baseline_w, traj.flat(traj.next_state),
                               next_t).reshape(shape)
    adv = compute_advantages(cfg.tau, cfg.gamma, traj.reward, traj.done,
                             values, next_values)
    return adv, baseline_w


def _log_prob(policy, params, traj: Trajectory) -> torch.Tensor:
    """``[B, T*E, 1]`` action log-probs (the mean over action dims)."""
    return policy.log_prob(params, traj.flat(traj.state),
                           traj.flat(traj.action))


def _inner_update(policy, params, loss_fn, cfg: RLConfig):
    """One MAML inner step ``p' = p - inner_lr * g`` on per-task params;
    ``loss_fn(params) -> [B]``. ``cfg.first_order`` takes ``g`` without a
    graph (JAX ``stop_gradient``); otherwise ``p'`` stays differentiable
    to second order."""
    return inner_sgd(lambda p, _: loss_fn(p).sum(), params, None,
                     cfg.inner_lr, 1, first_order=cfg.first_order)


def _query_metrics(query: Trajectory) -> dict:
    rew = (query.reward * query.valid).flatten(1).sum(dim=1) / query.n_episodes
    return {"reward": rew, "success": query.episode_successes().mean(dim=-1)}


def trpo_a2c_loss(policy, params, traj: Trajectory, cfg: RLConfig,
                  update_vf: bool = True, baseline_w=None) -> torch.Tensor:
    """``[B]`` A2C surrogates with normalized, detached advantages
    (reference ``trpo_a2c_loss``, ``rl.py:346-358``). ``update_vf=False``
    reuses ``baseline_w``; without one it fits on this trajectory."""
    log_probs = _log_prob(policy, params, traj)
    adv, _ = traj_advantages(traj, cfg, update_vf=update_vf,
                             baseline_w=baseline_w)
    valid = traj.flat(traj.valid)
    adv = masked_normalize(traj.flat(adv), valid).detach()
    return a2c_policy_loss(log_probs, adv.unsqueeze(-1),
                           valid=valid.unsqueeze(-1))


def trpo_update(policy, params, traj: Trajectory, cfg: RLConfig,
                first_order: bool | None = None, baseline_w=None):
    """One TRPO-style inner MAML step on per-task params (reference
    ``trpo_update``, ``rl.py:361-374``). A pre-fitted ``baseline_w``
    skips the in-loss ridge fit (the fit is deterministic and outside the
    gradient either way)."""
    step_cfg = cfg if first_order is None else cfg._replace(
        first_order=first_order)
    loss_fn = lambda p: trpo_a2c_loss(policy, p, traj, step_cfg,
                                      update_vf=baseline_w is None,
                                      baseline_w=baseline_w)
    return _inner_update(policy, params, loss_fn, step_cfg)


def fast_adapt_trpo(policy, params, rollout_fn: Callable, tasks,
                    gen: torch.Generator, cfg: RLConfig):
    """First-order TRPO collection for a task batch ``tasks [B, ...]`` from
    the shared ``params`` -> (adapted per-task params, valid losses ``[B]``,
    replay [Trajectory ``[B, T, E, ...]`` x (adapt_steps + 1)], query
    metrics). The outer step rebuilds the second-order graph from the
    replay (reference ``rl/maml_trpo.py:113``, ``rl.py:441-473``)."""
    params = per_task(tree_map(torch.Tensor.detach, params), tasks.shape[0])
    replay = []
    baseline_w = None
    for _ in range(cfg.adapt_steps):
        support = rollout_fn(params, tasks, gen)
        replay.append(support)
        # one baseline fit per support batch: the inner update uses it, and
        # the query loss reuses the last one (the reference's shared
        # LinearValue, update_vf=False)
        _, baseline_w = traj_advantages(support, cfg)
        params = tree_map(torch.Tensor.detach, trpo_update(
            policy, params, support, cfg, first_order=True,
            baseline_w=baseline_w))
    query = rollout_fn(params, tasks, gen)
    replay.append(query)
    with torch.no_grad():
        valid_loss = trpo_a2c_loss(policy, params, query, cfg,
                                   update_vf=False, baseline_w=baseline_w)
    return params, valid_loss, replay, _query_metrics(query)


def trpo_collect_body(policy, rollout_fn: Callable, cfg: RLConfig):
    """``(params, tasks [B, ...], gen) -> (adapted params, valid losses,
    stacked replays [B, steps+1, T, E, ...], query metrics)``: the
    collection half of a MAML-TRPO iteration over a task batch."""
    def collect(params, tasks, gen):
        adapted, losses, replay, metrics = fast_adapt_trpo(
            policy, params, rollout_fn, tasks, gen, cfg)
        return adapted, losses, stack_trajectories(replay, dim=1), metrics
    return collect


# Eager PyTorch has nothing to compile: the JAX jit wrapper is the body.
make_trpo_collect = trpo_collect_body
