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

Used by ``trainers/rl.py`` ``--fuse N``. With a ``mesh``
(``parallel/mesh.py``, JAX's ``make_sharded_*_train_scan``) each rank
samples and adapts its ``meta_batch_size / size`` tasks from its own
generator, the outer step is averaged over the ranks, and the metrics are
global means. The seeded factories
(:func:`make_seeded_trpo_train_scan`, :func:`make_seeded_adam_train_scan`)
train ``S`` seeds as one program (``sweep.py --vmap_seeds``; JAX's
``vmap_seeds`` of these scans): the seed axis folds into the task axis
(``parallel/multiseed.py``), so each kernel launches as many times a
seeded iteration as a solo one.
"""

from __future__ import annotations

import torch

from exploring_meta_tpu_torch.adapt.maml import apply_meta_gradient
from exploring_meta_tpu_torch.parallel.mesh import check_fusable, local_count
from exploring_meta_tpu_torch.parallel.multiseed import seed_draws, seed_means
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
                        host_free: bool = False, phase=no_phase,
                        seeds: int | None = None, mesh=None,
                        meta_step=None):
    """-> ``iteration(params, gen) -> (new params, metrics)``: one
    MAML-TRPO meta-iteration (first-order collection, then the
    second-order CG / line-search outer step). ``host_free`` takes the
    line search that reads nothing back (``rl/trpo_meta.py``).
    ``phase(name)`` (``PhaseTimer.phase`` under ``--profile``) times JAX's
    eager phases ``collect`` and ``meta_step``; a fused iteration takes
    none, since its phases would sync inside a capture.

    ``seeds``: ``params`` are ``S`` seeds' stacked params, ``gen`` the
    tuple of their generators; each seed samples its own
    ``meta_batch_size`` tasks, and every metric is ``[S]``.

    ``mesh``: ``gen`` is this rank's generator; the rank samples and
    collects its share of the tasks and the outer step is the sharded one.
    ``meta_step`` replaces the outer step (the eager ``--mesh`` path's,
    which shards a globally collected batch)."""
    collect = make_trpo_collect(policy, rollout_fn, cfg, seeds=seeds)
    n_tasks = meta_batch_size if mesh is None else local_count(
        mesh.size, meta_batch_size)
    if meta_step is None:
        meta_step = make_trpo_meta_step(
            policy, cfg, trpo_cfg, cfg.adapt_steps, host_free=host_free,
            seeds=seeds, reduce=None if mesh is None else mesh.pmean)

    def iteration(params, gen):
        tasks = seed_draws(lambda g: env.sample_tasks(g, n_tasks), gen,
                           seeds)
        with phase("collect") as sync:
            old_params, _, replays, ms = collect(params, tasks, gen)
            sync.append(replays)
        with phase("meta_step") as sync:
            params, info = meta_step(params, old_params, replays)
            sync.append(params)
        reward = seed_means(ms["reward"], seeds)
        success = seed_means(ms["success"], seeds)
        if mesh is not None:
            reward, success = mesh.pmean(reward, success)
        return params, {"adapt_reward": reward, "adapt_success": success,
                        "meta_loss": info["old_loss"],
                        "ls_accepted": info["accepted"]}

    return iteration


def make_adam_iteration(env, policy, rollout_fn, cfg: RLConfig, algo: str,
                        meta_batch_size: int, phase=no_phase,
                        seeds: int | None = None, mesh=None):
    """-> ``iteration(params, opt, gen) -> metrics``: second-order PPO or
    VPG adaptation of a task batch and one step of ``opt`` (from
    ``adapt/maml.py:adam``) on the mean query loss, in place. As in JAX
    the whole of it is one ``phase`` (``meta_step``). ``seeds``: as
    :func:`make_trpo_iteration`; the step is taken on the sum of the
    seeds' mean query losses, each seed's gradient its own. ``mesh``: the
    rank adapts its share of the tasks, drawn from its generator ``gen``,
    and the meta-gradients and metrics are averaged over the ranks (JAX's
    ``make_sharded_adam_train_scan``, eager or fused)."""
    fast_adapt = {"ppo": fast_adapt_ppo, "vpg": fast_adapt_vpg}[algo]
    n_tasks = meta_batch_size if mesh is None else local_count(
        mesh.size, meta_batch_size)

    def iteration(params, opt, gen):
        tasks = seed_draws(lambda g: env.sample_tasks(g, n_tasks), gen,
                           seeds)
        with phase("meta_step") as sync:
            _, losses, ms = fast_adapt(policy, params, rollout_fn, tasks,
                                       gen, cfg, seeds=seeds)
            loss = seed_means(losses, seeds)
            apply_meta_gradient(
                opt, loss if seeds is None else loss.sum(), params,
                reduce=None if mesh is None else mesh.pmean_)
            sync.append(params)
        metrics = (loss.detach(), seed_means(ms["reward"], seeds),
                   seed_means(ms["success"], seeds))
        if mesh is not None:
            metrics = mesh.pmean(*metrics)
        return dict(zip(("meta_loss", "adapt_reward", "adapt_success"),
                        metrics))

    return iteration


def _trpo_train_scan(env, policy, rollout_fn, cfg, trpo_cfg, meta_batch_size,
                     n_steps, seeds=None, mesh=None):
    iteration = make_trpo_iteration(env, policy, rollout_fn, cfg, trpo_cfg,
                                    meta_batch_size, host_free=True,
                                    seeds=seeds, mesh=mesh)

    def make(params, *gens):
        check_fusable(mesh, gens[0].device)
        gen = gens[0] if seeds is None else gens

        def step():
            new, metrics = iteration(params, gen)
            with torch.no_grad():
                for p, q in zip(tree_leaves(params), tree_leaves(new)):
                    p.copy_(q)
            return metrics
        return FusedIterations(step, n_steps, gens[0].device, gens,
                               metric_shape=() if seeds is None
                               else (seeds,))

    loop = bind_once(make)

    def train(params, gen, n=None):
        gens = (gen,) if seeds is None else tuple(gen)
        return params, loop(params, *gens)(n)

    train.fused = loop     # its FusedIterations: train.fused.bound()
    return train


def _adam_train_scan(env, policy, rollout_fn, cfg, algo, meta_batch_size,
                     n_steps, seeds=None, mesh=None):
    iteration = make_adam_iteration(env, policy, rollout_fn, cfg, algo,
                                    meta_batch_size, seeds=seeds, mesh=mesh)

    def make(params, opt, *gens):
        check_fusable(mesh, gens[0].device)
        gen = gens[0] if seeds is None else gens
        return FusedIterations(lambda: iteration(params, opt, gen), n_steps,
                               gens[0].device, gens,
                               metric_shape=() if seeds is None
                               else (seeds,))

    loop = bind_once(make)

    def train(params, opt, gen, n=None):
        gens = (gen,) if seeds is None else tuple(gen)
        return params, opt, loop(params, opt, *gens)(n)

    train.fused = loop     # its FusedIterations: train.fused.bound()
    return train


def make_trpo_train_scan(env, policy, rollout_fn, cfg: RLConfig,
                         trpo_cfg: TRPOConfig, meta_batch_size: int,
                         n_steps: int, mesh=None):
    """-> ``train(params, gen, n=n_steps) -> (params, metrics)`` running
    ``n <= n_steps`` full MAML-TRPO meta-iterations, the params stepped in
    place; metrics ``adapt_reward``, ``adapt_success``, ``meta_loss``,
    ``ls_accepted``, each ``[n]`` on the device. The function is bound to
    the params and generator of its first call. ``mesh``: as
    :func:`make_trpo_iteration` (``gen`` this rank's)."""
    return _trpo_train_scan(env, policy, rollout_fn, cfg, trpo_cfg,
                            meta_batch_size, n_steps, mesh=mesh)


def make_adam_train_scan(env, policy, rollout_fn, cfg: RLConfig, algo: str,
                         meta_batch_size: int, n_steps: int, mesh=None):
    """-> ``train(params, opt, gen, n=n_steps) -> (params, opt, metrics)``
    for the PPO / VPG meta-paths (Adam through the differentiable query
    losses, reference ``rl/maml_ppo.py:128-130``); metrics ``meta_loss``,
    ``adapt_reward``, ``adapt_success``, each ``[n]``. Bound to the
    params, optimizer and generator of its first call. ``mesh``: as
    :func:`make_adam_iteration`."""
    return _adam_train_scan(env, policy, rollout_fn, cfg, algo,
                            meta_batch_size, n_steps, mesh=mesh)


def make_seeded_trpo_train_scan(env, policy, rollout_fn, cfg: RLConfig,
                                trpo_cfg: TRPOConfig, meta_batch_size: int,
                                n_steps: int, seeds: int):
    """:func:`make_trpo_train_scan` for ``seeds`` seeds as one program:
    ``train(params [S, ...], gens, n)``, ``gens`` the seeds' generators
    (``parallel/multiseed.py:stack_seed_states``); each metric ``[n,
    S]``; one capture for all seeds, one replay a seeded iteration."""
    return _trpo_train_scan(env, policy, rollout_fn, cfg, trpo_cfg,
                            meta_batch_size, n_steps, seeds=seeds)


def make_seeded_adam_train_scan(env, policy, rollout_fn, cfg: RLConfig,
                                algo: str, meta_batch_size: int,
                                n_steps: int, seeds: int):
    """:func:`make_adam_train_scan` for ``seeds`` seeds as one program:
    ``train(params [S, ...], opt, gens, n)``, ``opt`` the one Adam over
    the stacked leaves; each metric ``[n, S]``."""
    return _adam_train_scan(env, policy, rollout_fn, cfg, algo,
                            meta_batch_size, n_steps, seeds=seeds)
