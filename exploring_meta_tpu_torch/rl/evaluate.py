"""Meta-RL evaluation: adapt to fresh tasks, then measure a fresh rollout
of each adapted policy (port of ``exploring_meta_tpu/rl/evaluate.py``;
reference ``evaluate``, ``core_functions/rl.py:142-196``), with the
reference's three task selections: ``n_tasks`` sampled tasks, ``each3``
(3 trials of every distinct task id, Meta-World) or one named ML10 task;
the ``test_on_train`` switch (the benchmark's train tasks,
``rl.py:147-153``); and ``rewards_per_task`` keyed by ML10 task name
(``rl.py:143,186-190``), which the bar plots read.

A device env adapts the whole task batch at once. A host env adapts one
task at a time (task i's adaptation rollouts, then its measured rollout,
then task i + 1, as JAX's eager loop), or, with ``task_batch``, all tasks
in lockstep through one big vec env (``rl/host_batched.py``).

Evaluation takes no meta-gradient, so VPG and PPO adapt under
``torch.no_grad()``: the inner steps then run first order
(``adapt/maml.py:inner_sgd``) to the same adapted values.
"""

from __future__ import annotations

import torch

from exploring_meta_tpu_torch.envs.factory import make_env
from exploring_meta_tpu_torch.rl.adapt_rl import (
    RLConfig, _query_metrics, fast_adapt_ppo, fast_adapt_trpo, fast_adapt_vpg,
)
from exploring_meta_tpu_torch.rl.rollout import make_rollout

FAST_ADAPT = {"vpg": fast_adapt_vpg, "ppo": fast_adapt_ppo,
              "trpo": fast_adapt_trpo}

# Meta-World ML10 task-name tables (reference rl.py:22-41)
ML10_TRAIN_TASK_NAMES = {
    0: "reach", 1: "push", 2: "pick-place", 3: "door-open",
    4: "drawer-close", 5: "button-press", 6: "peg-insert-side",
    7: "window-open", 8: "sweep", 9: "basketball",
}
ML10_EVAL_TASK_NAMES = {
    0: "drawer-open", 1: "door-close", 2: "shelf-place",
    3: "sweep-into", 4: "lever-pull",
}


def sample_3_from_each_task(env, gen, pool: int = 200, per_task: int = 3):
    """Sample ``pool`` tasks and keep the first ``per_task`` of every
    distinct task id, in id order (reference ``sample_3_from_each_task``,
    ``rl.py:113-125``); host envs whose tasks are dicts with a ``task`` id
    (the Meta-World adapter)."""
    buckets: dict = {}
    for t in env.sample_tasks(gen, pool):
        buckets.setdefault(t["task"], []).append(t)
    return [t for tid in sorted(buckets) for t in buckets[tid][:per_task]]


def sample_explicit_task(env, gen, task_name: str, pool: int = 100):
    """The first of ``pool`` sampled tasks that is the named ML10 task, or
    None (reference ``sample_explicit_task``, ``rl.py:128-139``). The eval
    table is searched first, else the train table: the two share ids, so
    they are never merged."""
    table = (ML10_EVAL_TASK_NAMES
             if task_name in ML10_EVAL_TASK_NAMES.values()
             else ML10_TRAIN_TASK_NAMES)
    index = {v: k for k, v in table.items()}[task_name]
    for t in env.sample_tasks(gen, pool):
        if t["task"] == index:
            return t
    return None


def adapt_tasks(algo: str, policy, params, rollout_fn, tasks,
                gen: torch.Generator, cfg: RLConfig):
    """``fast_adapt_<algo>`` of the shared ``params`` to the task batch
    ``tasks`` without a graph -> the adapted per-task params."""
    fast_adapt = FAST_ADAPT.get(algo)
    if fast_adapt is None:
        raise ValueError(f"unknown algo {algo!r}")
    with torch.no_grad():
        return fast_adapt(policy, params, rollout_fn, tasks, gen, cfg)[0]


def _select_tasks(env, gen, n_tasks, each3: bool) -> list:
    if each3:
        return sample_3_from_each_task(env, gen)
    if isinstance(n_tasks, str):
        task = sample_explicit_task(env, gen, n_tasks)
        if task is None:
            raise ValueError(f"task {n_tasks!r} not found")
        return [task]
    return env.sample_tasks(gen, n_tasks)


def evaluate(algo: str, policy, params, env, rollout_fn, cfg: RLConfig,
             n_tasks: int | str, gen: torch.Generator,
             device_env: bool = True, each3: bool = False,
             test_on_train: bool = False, extra_info: bool = False,
             task_batch: bool = False, grouped_roll_factory=None) -> dict:
    """Adapt ``params`` to fresh tasks and roll each adapted policy out once
    more -> metrics dict: per-task rewards and success rates, their means,
    and ``rewards_per_task``.

    ``n_tasks`` tasks are sampled; ``each3`` takes 3 trials of every
    distinct task id, and a task name in ``n_tasks`` that one ML10 task
    (host envs; on a device env both raise ``ValueError``, as in JAX).
    ``test_on_train`` only names the ML10 table here: the caller builds the
    env with ``test=not test_on_train`` (:func:`meta_test` does).
    ``extra_info`` (a Meta-World env) fills ``rewards_per_task`` with
    ``[reward, success, ...]`` pairs per task name, the bar plots' input.
    ``task_batch`` (host envs) adapts and measures all tasks in lockstep
    through ``grouped_roll_factory(n_tasks)``.

    ``mean_reward`` is the mean over the evaluated tasks (the reference
    divides by ``params['n_tasks']`` even under ``each3``, ``rl.py:191``,
    which JAX treats as a bug)."""
    if device_env and (each3 or isinstance(n_tasks, str)):
        raise ValueError(
            "each3 / explicit-task selection needs dict tasks with a "
            "'task' id (Meta-World-style host envs); this env samples "
            "plain array tasks")
    tasks = _select_tasks(env, gen, n_tasks, each3)
    if device_env:
        adapted = adapt_tasks(algo, policy, params, rollout_fn, tasks, gen,
                              cfg)
        m = _query_metrics(rollout_fn(adapted, tasks, gen))
        rewards, successes = m["reward"], m["success"]
    elif task_batch:
        from exploring_meta_tpu_torch.rl.host_batched import (
            adapt_task_batched,
        )
        if grouped_roll_factory is None:
            raise ValueError("task_batch=True needs grouped_roll_factory")
        grouped = grouped_roll_factory(len(tasks))
        adapted, _ = adapt_task_batched(algo, policy, params, grouped, tasks,
                                        gen, cfg)
        m = _query_metrics(grouped(adapted, tasks, gen))
        rewards, successes = m["reward"], m["success"]
    else:
        rows = []
        for i in range(len(tasks)):
            one = tasks[i:i + 1]
            adapted = adapt_tasks(algo, policy, params, rollout_fn, one, gen,
                                  cfg)
            rows.append(_query_metrics(rollout_fn(adapted, one, gen)))
        rewards = torch.cat([r["reward"] for r in rows])
        successes = torch.cat([r["success"] for r in rows])
    rewards, successes = rewards.cpu(), successes.cpu()

    # [reward, success] pairs per task name (reference rl.py:186-190)
    rewards_per_task: dict = {}
    if extra_info and not device_env:
        names = (ML10_TRAIN_TASK_NAMES if test_on_train
                 else ML10_EVAL_TASK_NAMES)
        for task, rew, suc in zip(tasks, rewards.tolist(),
                                  successes.tolist()):
            name = names.get(task["task"], str(task["task"]))
            rewards_per_task.setdefault(name, []).extend([rew, suc])
    return {
        "tasks_rewards": rewards.tolist(),
        "tasks_success_rate": successes.tolist(),
        "mean_reward": float(rewards.mean()),
        "mean_success": float(successes.mean()),
        "rewards_per_task": rewards_per_task,
    }


def meta_test(algo: str, env_name: str, policy, params, cfg: RLConfig,
              n_tasks: int | str, gen: torch.Generator, seed: int = 42,
              test_on_train: bool = False, each3: bool = False,
              workers: int | None = None, task_batch: bool = False) -> dict:
    """The reference's full ``evaluate`` contract (``rl.py:142-196``):
    :func:`evaluate` on a fresh env built from its name with ``test=not
    test_on_train`` (``rl.py:153``). ``workers``: a host env's episode
    slots (default ``cfg.adapt_batch_size``, so one collection is the
    whole episode batch); under ``task_batch`` the named env only samples
    tasks, and the rollouts go through the grouped factory's vec env."""
    env, is_device = make_env(env_name,
                              workers=(1 if task_batch else
                                       workers or cfg.adapt_batch_size),
                              seed=seed, test=not test_on_train,
                              max_path_length=cfg.max_path_length)
    grouped_roll_factory = None
    if is_device:
        roll = make_rollout(env, policy.sample, episodes=cfg.adapt_batch_size,
                            horizon=cfg.max_path_length)
    elif task_batch:
        from exploring_meta_tpu_torch.envs.host import (
            make_grouped_roll_factory,
        )
        roll = None
        grouped_roll_factory = make_grouped_roll_factory(
            env_name, policy, cfg, seed, test=not test_on_train)
    else:
        from exploring_meta_tpu_torch.envs.host import make_host_rollout
        roll = make_host_rollout(env, policy, cfg.max_path_length)
    return evaluate(algo, policy, params, env, roll, cfg, n_tasks, gen,
                    device_env=is_device, each3=each3,
                    test_on_train=test_on_train,
                    extra_info=env_name.startswith("ML"),
                    task_batch=task_batch and not is_device,
                    grouped_roll_factory=grouped_roll_factory)
