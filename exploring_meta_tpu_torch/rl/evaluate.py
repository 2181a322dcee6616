"""Meta-RL evaluation on device envs (port of the device-env part of
``exploring_meta_tpu/rl/evaluate.py``; reference ``evaluate``,
``core_functions/rl.py:142-196``): adapt to fresh tasks, then measure a
fresh rollout of each adapted policy. Host envs, ``each3``, explicit ML10
tasks and ``test_on_train`` are not ported yet.
"""

from __future__ import annotations

import torch

from exploring_meta_tpu_torch.envs.factory import make_env
from exploring_meta_tpu_torch.rl.adapt_rl import (
    RLConfig, _query_metrics, fast_adapt_trpo,
)
from exploring_meta_tpu_torch.rl.rollout import make_rollout


def evaluate(algo: str, policy, params, env, rollout_fn, cfg: RLConfig,
             n_tasks: int, gen: torch.Generator) -> dict:
    """Adapt ``params`` to ``n_tasks`` fresh tasks, all at once, and roll
    each adapted policy out once more -> metrics dict (per-task rewards
    and success rates, their means, empty ``rewards_per_task``)."""
    if algo != "trpo":
        raise NotImplementedError(
            f"evaluate: algo {algo!r} is not ported yet (ROADMAP Queue 1, "
            "later slices: the Adam outer paths)")
    tasks = env.sample_tasks(gen, n_tasks)
    adapted, _, _, _ = fast_adapt_trpo(policy, params, rollout_fn, tasks,
                                       gen, cfg)
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
              n_tasks: int, gen: torch.Generator) -> dict:
    """:func:`evaluate` on a fresh env built from its name."""
    env = make_env(env_name)
    roll = make_rollout(env, policy.sample, episodes=cfg.adapt_batch_size,
                        horizon=cfg.max_path_length)
    return evaluate(algo, policy, params, env, roll, cfg, n_tasks, gen)
