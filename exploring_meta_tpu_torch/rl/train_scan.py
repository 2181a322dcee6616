"""Fused meta-RL training: whole iterations as CUDA-graph replays (port of
``exploring_meta_tpu/rl/train_scan.py``).

On a device env (Particles2D) a whole meta-RL iteration is device work
with no host sync: task sampling, the rollouts and inner adaptation of the
task batch, and the outer step (the TRPO natural-gradient step with its
host-free line search, or Adam through the differentiable query losses).
JAX runs ``n_steps`` such iterations under ``lax.scan`` as one program;
here one iteration is captured as a CUDA graph and replayed
(:class:`exploring_meta_tpu_torch.utils.graphs.FusedIterations`; on the
CPU it runs eagerly). Every metric stays a device tensor.

Used by ``trainers/rl.py`` ``--fuse N``.
"""

from __future__ import annotations

import torch

from exploring_meta_tpu_torch.adapt.maml import apply_meta_gradient
from exploring_meta_tpu_torch.rl.adapt_rl import (
    RLConfig, fast_adapt_ppo, fast_adapt_vpg, make_trpo_collect,
)
from exploring_meta_tpu_torch.rl.trpo_meta import (
    TRPOConfig, make_trpo_meta_step,
)
from exploring_meta_tpu_torch.utils.graphs import FusedIterations, bind_once
from exploring_meta_tpu_torch.utils.profiling import no_phase
from exploring_meta_tpu_torch.utils.tree import tree_leaves


def make_trpo_iteration(env, policy, rollout_fn, cfg: RLConfig,
                        trpo_cfg: TRPOConfig, meta_batch_size: int,
                        host_free: bool = False, phase=no_phase):
    """-> ``iteration(params, gen) -> (new params, metrics)``: one
    MAML-TRPO meta-iteration (first-order collection, then the
    second-order CG / line-search outer step). ``host_free`` takes the
    line search that reads nothing back (``rl/trpo_meta.py``).
    ``phase(name)`` (``PhaseTimer.phase`` under ``--profile``) times JAX's
    eager phases ``collect`` and ``meta_step``; a fused iteration takes
    none, since its phases would sync inside a capture."""
    collect = make_trpo_collect(policy, rollout_fn, cfg)
    meta_step = make_trpo_meta_step(policy, cfg, trpo_cfg, cfg.adapt_steps,
                                    host_free=host_free)

    def iteration(params, gen):
        tasks = env.sample_tasks(gen, meta_batch_size)
        with phase("collect") as sync:
            old_params, _, replays, ms = collect(params, tasks, gen)
            sync.append(replays)
        with phase("meta_step") as sync:
            params, info = meta_step(params, old_params, replays)
            sync.append(params)
        return params, {"adapt_reward": ms["reward"].mean(),
                        "adapt_success": ms["success"].mean(),
                        "meta_loss": info["old_loss"],
                        "ls_accepted": info["accepted"]}

    return iteration


def make_adam_iteration(env, policy, rollout_fn, cfg: RLConfig, algo: str,
                        meta_batch_size: int, phase=no_phase):
    """-> ``iteration(params, opt, gen) -> metrics``: second-order PPO or
    VPG adaptation of a task batch and one step of ``opt`` (from
    ``adapt/maml.py:adam``) on the mean query loss, in place. As in JAX
    the whole of it is one ``phase`` (``meta_step``)."""
    fast_adapt = {"ppo": fast_adapt_ppo, "vpg": fast_adapt_vpg}[algo]

    def iteration(params, opt, gen):
        tasks = env.sample_tasks(gen, meta_batch_size)
        with phase("meta_step") as sync:
            _, losses, ms = fast_adapt(policy, params, rollout_fn, tasks,
                                       gen, cfg)
            loss = losses.mean()
            apply_meta_gradient(opt, loss, params)
            sync.append(params)
        return {"meta_loss": loss.detach(),
                "adapt_reward": ms["reward"].mean(),
                "adapt_success": ms["success"].mean()}

    return iteration


def make_trpo_train_scan(env, policy, rollout_fn, cfg: RLConfig,
                         trpo_cfg: TRPOConfig, meta_batch_size: int,
                         n_steps: int):
    """-> ``train(params, gen, n=n_steps) -> (params, metrics)`` running
    ``n <= n_steps`` full MAML-TRPO meta-iterations, the params stepped in
    place; metrics ``adapt_reward``, ``adapt_success``, ``meta_loss``,
    ``ls_accepted``, each ``[n]`` on the device. The function is bound to
    the params and generator of its first call."""
    iteration = make_trpo_iteration(env, policy, rollout_fn, cfg, trpo_cfg,
                                    meta_batch_size, host_free=True)

    def make(params, gen):
        def step():
            new, metrics = iteration(params, gen)
            with torch.no_grad():
                for p, q in zip(tree_leaves(params), tree_leaves(new)):
                    p.copy_(q)
            return metrics
        return FusedIterations(step, n_steps, gen.device, (gen,))

    loop = bind_once(make)

    def train(params, gen, n=None):
        return params, loop(params, gen)(n)

    train.fused = loop     # its FusedIterations: train.fused.bound()
    return train


def make_adam_train_scan(env, policy, rollout_fn, cfg: RLConfig, algo: str,
                         meta_batch_size: int, n_steps: int):
    """-> ``train(params, opt, gen, n=n_steps) -> (params, opt, metrics)``
    for the PPO / VPG meta-paths (Adam through the differentiable query
    losses, reference ``rl/maml_ppo.py:128-130``); metrics ``meta_loss``,
    ``adapt_reward``, ``adapt_success``, each ``[n]``. Bound to the
    params, optimizer and generator of its first call."""
    iteration = make_adam_iteration(env, policy, rollout_fn, cfg, algo,
                                    meta_batch_size)

    def make(params, opt, gen):
        return FusedIterations(lambda: iteration(params, opt, gen), n_steps,
                               gen.device, (gen,))

    loop = bind_once(make)

    def train(params, opt, gen, n=None):
        return params, opt, loop(params, opt, gen)(n)

    train.fused = loop     # its FusedIterations: train.fused.bound()
    return train
