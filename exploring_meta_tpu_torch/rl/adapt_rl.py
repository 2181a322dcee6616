"""Meta-RL fast adaptation: VPG, PPO and TRPO (port of
``exploring_meta_tpu/rl/adapt_rl.py``; reference
``core_functions/rl.py:199-406``).

JAX ``vmap``-s these functions over tasks. Here the task axis is written
out: every trajectory is a task batch ``[B, T, E, ...]``, per-task params
carry a leading ``[B]`` on every leaf, and every loss and metric is a
``[B]`` vector, one value per task. An inner step differentiates the sum
of the per-task losses with respect to per-task params, so each task
adapts on its own data only. A task batch is a tensor ``[B, ...]`` on a
device env, or a host env's list (Meta-World dicts) or array of ``B``
tasks: only its length is read here, and the rollout takes it as it is.

A one-program seed sweep (``parallel/multiseed.py``) passes ``seeds=S``:
the params are ``S`` seeds' stacked ``[S, ...]`` params, the task batch
holds ``S·B`` tasks seed-major, and ``gen`` is the tuple of the seeds'
generators, which the rollout's action noise draws from per seed
(``models/distributions.py:normal_sample``).

Masking: trajectories are fixed-shape with a ``valid`` mask, and every
reduction is valid-weighted (PARITY D7). Sampled actions are data
(rollout.py), so no reparameterization path reaches the meta-gradient,
and neither do the advantages: they are functions of the trajectory
alone, so the sweep kernels never see a tensor that requires grad.

ANIL (reference ``turn_off_body_grads``, ``policies.py:94-106``): inner
losses detach the body features and the inner update moves only the
``head`` and ``sigma`` leaves; query losses keep the full graph.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from exploring_meta_tpu_torch.adapt.maml import inner_sgd, task_copies
from exploring_meta_tpu_torch.models.policies import DiagNormalPolicyANIL
from exploring_meta_tpu_torch.ops.gae import compute_advantages, discount
from exploring_meta_tpu_torch.ops.losses import (
    a2c_policy_loss, magic_box, ppo_policy_loss, weighted_cumsum,
)
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
    ppo_epochs: int = 3
    ppo_clip_ratio: float = 0.3
    anil: bool = False
    first_order: bool = False
    flat_timestep: bool = False   # True: cherry's LinearValue time feature,
                                  # the row index of the flat concatenated
                                  # replay (crossing episodes); default is
                                  # the within-episode index (PARITY.md)
    value_reg: float = 1e-5       # LinearValue ridge; the reference passes
                                  # the action size here by accident (2.0
                                  # on Particles2D, PARITY D9)


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


def _log_prob(policy, params, traj: Trajectory,
              inner_anil: bool = False) -> torch.Tensor:
    """``[B, T*E, 1]`` action log-probs (the mean over action dims);
    ``inner_anil`` detaches an ANIL policy's body features."""
    s, a = traj.flat(traj.state), traj.flat(traj.action)
    if inner_anil and isinstance(policy, DiagNormalPolicyANIL):
        return policy.log_prob(params, s, a, stop_body_grad=True)
    return policy.log_prob(params, s, a)


def policy_anil_mask(params, _trainable: bool = False):
    """Trainable mask for ANIL: True on every leaf under a ``head`` or
    ``sigma`` key, False on the body."""
    if isinstance(params, dict):
        return {k: policy_anil_mask(v, _trainable or k in ("head", "sigma"))
                for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(policy_anil_mask(v, _trainable) for v in params)
    return _trainable


def _inner_update(policy, params, loss_fn, cfg: RLConfig):
    """One MAML inner step ``p' = p - inner_lr * g`` on per-task params;
    ``loss_fn(params) -> [B]``. ``cfg.first_order`` takes ``g`` without a
    graph (JAX ``stop_gradient``); otherwise ``p'`` stays differentiable
    to second order. ``cfg.anil`` freezes the body."""
    return inner_sgd(lambda p, _: loss_fn(p).sum(), params, None,
                     cfg.inner_lr, 1, first_order=cfg.first_order,
                     trainable=policy_anil_mask(params) if cfg.anil else None)


def _query_metrics(query: Trajectory) -> dict:
    rew = (query.reward * query.valid).flatten(1).sum(dim=1) / query.n_episodes
    return {"reward": rew, "success": query.episode_successes().mean(dim=-1)}


def normalized_advantages(traj: Trajectory, cfg: RLConfig,
                          **kw) -> torch.Tensor:
    """``[B, T*E, 1]`` GAE advantages normalized over each task's valid
    steps, detached."""
    adv, _ = traj_advantages(traj, cfg, **kw)
    return masked_normalize(traj.flat(adv),
                            traj.flat(traj.valid)).detach().unsqueeze(-1)


# --------------------------------------------------------------------------
# A2C / VPG
# --------------------------------------------------------------------------

def vpg_a2c_loss(policy, params, traj: Trajectory, cfg: RLConfig,
                 inner_anil: bool = False, dice: bool = False) -> torch.Tensor:
    """``[B]`` masked ``-(log pi * A).mean()`` with GAE advantages
    (reference ``vpg_a2c_loss``, ``rl.py:208-226``; DiCE variant
    ``:219-224``)."""
    log_probs = _log_prob(policy, params, traj, inner_anil)
    adv, _ = traj_advantages(traj, cfg)
    adv = traj.flat(adv).unsqueeze(-1)
    valid = traj.flat(traj.valid).unsqueeze(-1)
    if dice:
        # The DiCE recurrence runs over time within each episode, on the
        # [B, T, E] layout. Terminal flags count only on valid steps: the
        # filler after termination repeats done=1 but is no boundary (the
        # reference's dones.sum() is the episode count, rl.py:219-222).
        B, T, E = traj.reward.shape
        lp = log_probs.reshape(B, T, E)
        dones = traj.done * traj.valid
        weights = torch.ones_like(dones)
        weights[:, 1:] -= dones[:, :-1]
        weights = weights / dones.flatten(1).sum(dim=1).clamp(
            min=1.0).view(B, 1, 1)
        lp = magic_box(weighted_cumsum(lp, weights, dim=1))
        log_probs = lp.reshape(B, T * E, 1)
    return a2c_policy_loss(log_probs, adv, valid=valid)


def fast_adapt_vpg(policy, params, rollout_fn: Callable, tasks,
                   gen: torch.Generator, cfg: RLConfig, dice: bool = False,
                   seeds: int | None = None):
    """VPG inner loop for a task batch ``tasks [B, ...]`` from the shared
    ``params`` (or ``seeds`` seeds' stacked ones) -> (adapted per-task
    params, differentiable query losses ``[B]``, query metrics) (reference
    ``fast_adapt_vpg``, ``rl.py:229-254``)."""
    params = task_copies(params, len(tasks), seeds)
    for _ in range(cfg.adapt_steps):
        support = rollout_fn(params, tasks, gen)
        params = _inner_update(
            policy, params, lambda p: vpg_a2c_loss(
                policy, p, support, cfg, inner_anil=cfg.anil, dice=dice),
            cfg)
    query = rollout_fn(params, tasks, gen)
    return (params, vpg_a2c_loss(policy, params, query, cfg),
            _query_metrics(query))


# --------------------------------------------------------------------------
# PPO
# --------------------------------------------------------------------------

def _ppo_clip_loss(policy, params, traj, adv_flat, old_log_probs,
                   cfg: RLConfig, inner_anil: bool) -> torch.Tensor:
    new_lp = _log_prob(policy, params, traj, inner_anil)
    return ppo_policy_loss(new_lp, old_log_probs, adv_flat,
                           clip=cfg.ppo_clip_ratio,
                           valid=traj.flat(traj.valid).unsqueeze(-1))


def _ppo_updates(policy, params, support: Trajectory, cfg: RLConfig,
                 epochs: int):
    """``epochs`` clipped updates on one support batch, against its
    detached log-probs and normalized advantages."""
    adv = normalized_advantages(support, cfg)
    old_lp = _log_prob(policy, params, support, cfg.anil).detach()
    for _ in range(epochs):
        params = _inner_update(
            policy, params, lambda p: _ppo_clip_loss(
                policy, p, support, adv, old_lp, cfg, cfg.anil), cfg)
    return params


def fast_adapt_ppo(policy, params, rollout_fn: Callable, tasks,
                   gen: torch.Generator, cfg: RLConfig,
                   seeds: int | None = None):
    """PPO inner loop with differentiable query losses ``[B]`` (reference
    ``fast_adapt_ppo``, ``rl.py:264-316``): ``cfg.ppo_epochs`` clipped
    updates per support batch, each kept to second order unless
    ``cfg.first_order`` (the outer step differentiates through all of
    them, ``maml_ppo.py:128-130``) -> (adapted per-task params, query
    losses, query metrics). ``seeds``: as :func:`fast_adapt_vpg`."""
    params = task_copies(params, len(tasks), seeds)
    for _ in range(cfg.adapt_steps):
        support = rollout_fn(params, tasks, gen)
        params = _ppo_updates(policy, params, support, cfg, cfg.ppo_epochs)
    query = rollout_fn(params, tasks, gen)
    old_lp = _log_prob(policy, params, query).detach()
    valid_loss = _ppo_clip_loss(policy, params, query,
                                normalized_advantages(query, cfg), old_lp,
                                cfg, False)
    return params, valid_loss, _query_metrics(query)


# --------------------------------------------------------------------------
# TRPO inner loop (outer step in trpo_meta.py)
# --------------------------------------------------------------------------

def trpo_a2c_loss(policy, params, traj: Trajectory, cfg: RLConfig,
                  update_vf: bool = True, inner_anil: bool = False,
                  baseline_w=None) -> torch.Tensor:
    """``[B]`` A2C surrogates with normalized, detached advantages
    (reference ``trpo_a2c_loss``, ``rl.py:346-358``). ``update_vf=False``
    reuses ``baseline_w``; without one it fits on this trajectory."""
    log_probs = _log_prob(policy, params, traj, inner_anil)
    adv = normalized_advantages(traj, cfg, update_vf=update_vf,
                                baseline_w=baseline_w)
    return a2c_policy_loss(log_probs, adv,
                           valid=traj.flat(traj.valid).unsqueeze(-1))


def single_adapt_step(algo: str, policy, params, support: Trajectory,
                      cfg: RLConfig, ppo_epochs: int = 1):
    """One first-order inner step of per-task ``params`` on a collected
    support batch ``[B, T, E, ...]``, by algorithm (the reference's
    analysis-side updates, ``cl_rl.py:70-87``: vpg ``adapt``,
    ``single_ppo_update``, ``trpo_update``).

    ``ppo_epochs``: clipped updates per call for ``algo="ppo"``. The
    reference's ``single_ppo_update`` makes one (``rl.py:319-336``), its
    training ``fast_adapt_ppo`` ``params['ppo_epochs']``; the default 1 is
    the analysis semantics."""
    step_cfg = cfg._replace(first_order=True)
    if algo == "trpo":
        return trpo_update(policy, params, support, step_cfg)
    if algo == "vpg":
        return _inner_update(policy, params, lambda p: vpg_a2c_loss(
            policy, p, support, cfg, inner_anil=cfg.anil), step_cfg)
    if algo == "ppo":
        return _ppo_updates(policy, params, support, step_cfg, ppo_epochs)
    raise ValueError(f"unknown algo {algo!r}")


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
                                      inner_anil=step_cfg.anil,
                                      baseline_w=baseline_w)
    return _inner_update(policy, params, loss_fn, step_cfg)


def fast_adapt_trpo(policy, params, rollout_fn: Callable, tasks,
                    gen: torch.Generator, cfg: RLConfig,
                    seeds: int | None = None):
    """First-order TRPO collection for a task batch ``tasks [B, ...]`` from
    the shared ``params`` -> (adapted per-task params, valid losses ``[B]``,
    replay [Trajectory ``[B, T, E, ...]`` x (adapt_steps + 1)], query
    metrics). The outer step rebuilds the second-order graph from the
    replay (reference ``rl/maml_trpo.py:113``, ``rl.py:441-473``).
    ``seeds``: as :func:`fast_adapt_vpg`."""
    params = task_copies(tree_map(torch.Tensor.detach, params),
                         len(tasks), seeds)
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


def trpo_collect_body(policy, rollout_fn: Callable, cfg: RLConfig,
                      seeds: int | None = None):
    """``(params, tasks [B, ...], gen) -> (adapted params, valid losses,
    stacked replays [B, steps+1, T, E, ...], query metrics)``: the
    collection half of a MAML-TRPO iteration over a task batch
    (``seeds``: as :func:`fast_adapt_vpg`)."""
    def collect(params, tasks, gen):
        adapted, losses, replay, metrics = fast_adapt_trpo(
            policy, params, rollout_fn, tasks, gen, cfg, seeds=seeds)
        return adapted, losses, stack_trajectories(replay, dim=1), metrics
    return collect


# Eager PyTorch has nothing to compile: the JAX jit wrapper is the body.
make_trpo_collect = trpo_collect_body
