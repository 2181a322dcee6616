"""Meta-RL evaluation on device envs (port of the device-env part of
``exploring_meta_tpu/rl/evaluate.py``; reference ``evaluate``,
``core_functions/rl.py:142-196``): adapt to fresh tasks, then measure a
fresh rollout of each adapted policy. Host envs, with their ``each3`` and
explicit ML10 task selection and per-task-name rewards, are not ported
yet.

Evaluation takes no meta-gradient, so VPG and PPO adapt under
``torch.no_grad()``: the inner steps then run first order
(``adapt/maml.py:inner_sgd``) to the same adapted values.
"""

from __future__ import annotations

import torch

from exploring_meta_tpu_torch.envs.factory import HOST_ENVS, make_env
from exploring_meta_tpu_torch.rl.adapt_rl import (
    RLConfig, _query_metrics, fast_adapt_ppo, fast_adapt_trpo, fast_adapt_vpg,
)
from exploring_meta_tpu_torch.rl.rollout import make_rollout

FAST_ADAPT = {"vpg": fast_adapt_vpg, "ppo": fast_adapt_ppo,
              "trpo": fast_adapt_trpo}


def adapt_tasks(algo: str, policy, params, rollout_fn, tasks,
                gen: torch.Generator, cfg: RLConfig):
    """``fast_adapt_<algo>`` of the shared ``params`` to the task batch
    ``tasks [B, ...]`` without a graph -> the adapted per-task params."""
    fast_adapt = FAST_ADAPT.get(algo)
    if fast_adapt is None:
        raise ValueError(f"unknown algo {algo!r}")
    with torch.no_grad():
        return fast_adapt(policy, params, rollout_fn, tasks, gen, cfg)[0]


def evaluate(algo: str, policy, params, env, rollout_fn, cfg: RLConfig,
             n_tasks: int | str, gen: torch.Generator,
             device_env: bool = True, each3: bool = False,
             test_on_train: bool = False, task_batch: bool = False,
             grouped_roll_factory=None) -> dict:
    """Adapt ``params`` to ``n_tasks`` fresh tasks, all at once, and roll
    each adapted policy out once more -> metrics dict (per-task rewards
    and success rates, their means, and ``rewards_per_task``, empty on a
    device env).

    As in JAX, ``each3`` or a task name in ``n_tasks`` raises
    ``ValueError`` on a device env, and ``test_on_train`` only names the
    task table of a host env: the caller builds the env with
    ``test=not test_on_train`` (:func:`meta_test` does)."""
    if device_env and (each3 or isinstance(n_tasks, str)):
        raise ValueError(
            "each3 / explicit-task selection needs dict tasks with a "
            "'task' id (Meta-World-style host envs); this env samples "
            "plain array tasks")
    if not device_env or task_batch or grouped_roll_factory is not None:
        raise NotImplementedError(f"evaluate: {HOST_ENVS}")
    tasks = env.sample_tasks(gen, n_tasks)
    adapted = adapt_tasks(algo, policy, params, rollout_fn, tasks, gen, cfg)
    m = _query_metrics(rollout_fn(adapted, tasks, gen))
    rewards, successes = m["reward"].cpu(), m["success"].cpu()
    return {
        "tasks_rewards": rewards.tolist(),
        "tasks_success_rate": successes.tolist(),
        "mean_reward": float(rewards.mean()),
        "mean_success": float(successes.mean()),
        "rewards_per_task": {},
    }


def meta_test(algo: str, env_name: str, policy, params, cfg: RLConfig,
              n_tasks: int | str, gen: torch.Generator, seed: int = 42,
              test_on_train: bool = False, each3: bool = False,
              workers: int | None = None, task_batch: bool = False) -> dict:
    """The reference's full ``evaluate`` contract (``rl.py:142-196``):
    :func:`evaluate` on a fresh env built from its name with ``test=not
    test_on_train``."""
    env, is_device = make_env(env_name,
                              workers=workers or cfg.adapt_batch_size,
                              seed=seed, test=not test_on_train,
                              max_path_length=cfg.max_path_length)
    roll = make_rollout(env, policy.sample, episodes=cfg.adapt_batch_size,
                        horizon=cfg.max_path_length)
    return evaluate(algo, policy, params, env, roll, cfg, n_tasks, gen,
                    device_env=is_device, each3=each3,
                    test_on_train=test_on_train, task_batch=task_batch)
