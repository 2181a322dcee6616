"""Host-physics environments behind the port's rollout contract (port of
``exploring_meta_tpu/envs/host.py``).

MuJoCo and Meta-World physics run on the host. The policy lives on the
card: each step moves the observations host -> device and the sampled
actions device -> host (one round trip, which syncs), and the finished
rollout is built in numpy ``[T, E, ...]`` buffers exactly as JAX builds
them, then shipped to the training device once, a field a copy, as the
port's :class:`~exploring_meta_tpu_torch.rl.rollout.Trajectory`.

``HostVecEnv`` steps E envs in lockstep, through the native C++ thread
pool (``native/binding.py:PythonEnvPool``) when it can overlap physics,
else a plain Python loop. ``make_host_rollout`` collects one task at a
time; ``make_grouped_host_rollout`` collects a whole task batch in one
``n_tasks * episodes``-slot vec env, so one policy round trip serves every
task. Both take the port's shared or ``[B]``-stacked params, as
``rl/rollout.py:rollout`` does, and give ``[B, T, E, ...]`` for a task
batch (a list of tasks, or an array of them), ``[T, E, ...]`` for one task.

Envs provided: ``AntDirectionEnv`` (gymnasium's MuJoCo ``Ant-v5`` with
direction-reward tasks, l2l's ``AntDirection-v1``); Meta-World ML1 / ML10
/ ML45 through ``envs/metaworld_adapter.py``. gymnasium, mujoco and
metaworld are imported when an env is built, never when this module is.

``set_host_policy_device("cpu")`` (``--host_policy cpu``) runs the per-step
forwards on the CPU: the params are copied there once a rollout, and the
action noise is drawn from a CPU generator seeded once a rollout from the
rollout's generator (the rollout's own, when that is a CPU generator). The
finished rollout still ships to the card. ``"device"`` is the default; the
CPU is never chosen because a card is missing.

``COUNTS`` tallies what collection costs: ``steps`` policy forwards,
``round_trips`` of them that crossed to a non-CPU device and back, and
``shipments`` of finished rollouts to a non-CPU device.
"""

from __future__ import annotations

import sys
from typing import Callable

import numpy as np
import torch

from exploring_meta_tpu_torch.native.binding import effective_cpus
from exploring_meta_tpu_torch.rl.rollout import Trajectory
from exploring_meta_tpu_torch.utils.tree import tree_leaves, tree_map

_POLICY_DEVICE_MODE = "device"
COUNTS = {"steps": 0, "round_trips": 0, "shipments": 0}


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


def set_host_policy_device(mode: str) -> None:
    """Set where host-rollout policy forwards run by default (``"device"``
    or ``"cpu"``); the trainers wire ``--host_policy`` here."""
    global _POLICY_DEVICE_MODE
    _check_mode(mode)
    _POLICY_DEVICE_MODE = mode


def _check_mode(mode: str) -> None:
    if mode not in ("device", "cpu"):  # a typo must not fall back silently
        raise ValueError(f"host policy device must be 'device' or 'cpu', "
                         f"got {mode!r}")


def _place_policy(mode, params, gen: torch.Generator):
    """-> ``(params, generator)`` of the per-step forwards for ``mode``
    (``None``: the module default of :func:`set_host_policy_device`)."""
    mode = mode or _POLICY_DEVICE_MODE
    _check_mode(mode)
    if mode == "device":
        return params, gen
    params = tree_map(lambda t: t.detach().to("cpu"), params)
    if gen.device.type != "cpu":
        seed = torch.randint(0, 2 ** 62, (), generator=gen, device=gen.device)
        gen = torch.Generator().manual_seed(int(seed))
    return params, gen


class AntDirectionEnv:
    """AntDirection-v1 semantics on gymnasium's MuJoCo Ant: a task is a 2D
    unit direction, and the forward reward is the velocity along it
    (reference env: l2l.gym ``AntDirectionEnv``, ``utils/env_maker.py:7``)."""

    def __init__(self, seed: int = 42):
        import gymnasium as gym
        self._env = gym.make("Ant-v5",
                             exclude_current_positions_from_observation=True)
        self._task = np.array([1.0, 0.0])
        self.obs_size = int(np.prod(self._env.observation_space.shape))
        self.action_size = int(np.prod(self._env.action_space.shape))
        self._act_low = self._env.action_space.low
        self._act_high = self._env.action_space.high
        self._rng = np.random.default_rng(seed)
        # seed gym's np_random at build (reference make_env,
        # env_maker.py:16): reset(seed=None) would draw OS entropy
        self._env.reset(seed=seed)

    def sample_tasks(self, gen, n: int) -> np.ndarray:
        del gen  # the env's own numpy stream draws, as JAX ignores its key
        theta = self._rng.uniform(0, 2 * np.pi, size=n)
        return np.stack([np.cos(theta), np.sin(theta)], axis=1)

    def set_task(self, task) -> None:
        self._task = np.asarray(task)

    def reset(self, seed: int | None = None):
        obs, _ = self._env.reset(seed=seed)
        return obs

    def step(self, action):
        # ActionSpaceScaler (reference env_maker.py:15,39): the raw Gaussian
        # sample is stored for the log-probs, the physics sees it clamped
        action = np.clip(np.asarray(action), self._act_low, self._act_high)
        obs, _, terminated, truncated, info = self._env.step(action)
        # the direction-projected forward reward replaces the x-velocity
        # one; the control and contact costs and the survival bonus stay
        vel = np.array([info.get("x_velocity", 0.0),
                        info.get("y_velocity", 0.0)])
        fwd = float(vel @ self._task)
        reward = (fwd + float(info.get("reward_ctrl", 0.0))
                  + float(info.get("reward_contact", 0.0))
                  + float(info.get("reward_survive", 0.0)))
        return obs, reward, bool(terminated), truncated, 0.0


class HostVecEnv:
    """Step E host envs in lockstep and emit a Trajectory.

    ``backend``: ``"auto"`` (the native pool when it is built and more than
    one worker can run, else the Python loop), ``"native"`` (the pool, or
    raise) or ``"python"``. Workers are counted on the CPUs this process
    may use (``os.sched_getaffinity``): with one, the pool only adds its
    callback crossings, so ``"auto"`` takes the loop."""

    def __init__(self, env_factory: Callable[[], object], n_envs: int,
                 backend: str = "auto", n_threads: int | None = None):
        if backend not in ("auto", "native", "python"):
            raise ValueError(f"unknown backend {backend!r}; "
                             "one of 'auto' | 'native' | 'python'")
        self.envs = [env_factory() for _ in range(n_envs)]
        self.n_envs = n_envs
        self.obs_size = self.envs[0].obs_size
        self.action_size = self.envs[0].action_size
        self._pool = None
        threads = min(n_threads if n_threads is not None else n_envs,
                      effective_cpus())
        if backend == "native" or (backend == "auto" and threads > 1):
            from exploring_meta_tpu_torch.native.binding import PythonEnvPool
            try:
                self._pool = PythonEnvPool(self.envs, n_threads=n_threads)
            except RuntimeError as exc:
                if backend == "native":
                    raise
                print(f"native env pool unavailable ({exc}); falling back "
                      "to sequential stepping", file=sys.stderr)
        self.backend = "native" if self._pool is not None else "python"

    def sample_tasks(self, gen, n: int):
        return self.envs[0].sample_tasks(gen, n)

    def set_task(self, task) -> None:
        for e in self.envs:
            e.set_task(task)

    def set_tasks(self, tasks, group_size: int) -> None:
        """Task ``i`` to env slots ``[i * group_size, (i + 1) *
        group_size)``, the slot layout of a grouped rollout."""
        if len(tasks) * group_size != self.n_envs:
            raise ValueError(f"{len(tasks)} tasks x group {group_size} != "
                             f"{self.n_envs} env slots")
        for i, e in enumerate(self.envs):
            e.set_task(tasks[i // group_size])

    def collect(self, action_fn: Callable, gen, horizon: int,
                seed: int | None = None, device=None) -> Trajectory:
        """Roll all E envs for ``horizon`` steps -> a ``[T, E, ...]``
        Trajectory on ``device`` (the CPU by default).

        ``action_fn(gen, obs [E, obs] float64 numpy) -> actions [E, act]``
        (a tensor on any device, or an array) is called once a step."""
        E, T = self.n_envs, horizon
        if self._pool is not None:
            obs = self._pool.reset(seed=seed)  # the pool offsets per slot
        else:
            obs = np.stack([
                e.reset(seed=None if seed is None else seed + i)
                for i, e in enumerate(self.envs)])
        states = np.zeros((T, E, self.obs_size), np.float32)
        next_states = np.zeros_like(states)
        actions = np.zeros((T, E, self.action_size), np.float32)
        rewards = np.zeros((T, E), np.float32)
        dones = np.zeros((T, E), np.float32)
        successes = np.zeros((T, E), np.float32)
        valids = np.zeros((T, E), np.float32)
        timesteps = np.zeros((T, E), np.int32)

        alive = np.ones(E, bool)
        t_in_ep = np.zeros(E, np.int32)
        for t in range(T):
            acts = action_fn(gen, obs)
            acts = (acts.cpu().numpy() if torch.is_tensor(acts)
                    else np.asarray(acts))
            states[t] = obs
            actions[t] = acts
            timesteps[t] = t_in_ep
            valids[t] = alive.astype(np.float32)
            if self._pool is not None:
                # one native call fans the batch over the pool's threads;
                # finished envs are stepped too and their results dropped
                # below (physics is per env, so the record is the loop's)
                o2b, rb, db, sb = self._pool.step(acts)
                step_results = [(o2b[i], rb[i], db[i] > 0.5, False, sb[i])
                                for i in range(E)]
            else:
                step_results = [env.step(acts[i]) if alive[i] else None
                                for i, env in enumerate(self.envs)]
            for i in range(E):
                if not alive[i]:
                    next_states[t, i] = obs[i]
                    dones[t, i] = 1.0
                    continue
                o2, r, done, _truncated, suc = step_results[i]
                next_states[t, i] = o2
                rewards[t, i] = r
                successes[t, i] = suc
                dones[t, i] = 1.0 if (done or t == T - 1) else 0.0
                if done:
                    alive[i] = False
                else:
                    obs[i] = o2
                    t_in_ep[i] += 1

        device = torch.device("cpu") if device is None else torch.device(
            device)
        if device.type != "cpu":
            COUNTS["shipments"] += 1
        return Trajectory(*(torch.from_numpy(x).to(device) for x in (
            states, actions, rewards, dones, next_states, successes, valids,
            timesteps)))


def _task_batch(task) -> tuple[list, bool]:
    """-> (the tasks as a list, whether ``task`` was a task batch): a list
    or tuple of tasks, or an array of them (Ant's ``[B, 2]``), is a batch;
    a Meta-World dict or a 1-D array is one task."""
    if isinstance(task, (list, tuple)):
        return list(task), True
    if isinstance(task, dict):
        return [task], False
    arr = np.asarray(task)
    return (list(arr), True) if arr.ndim >= 2 else ([arr], False)


def _collect_group(vec_env: HostVecEnv, policy, params, tasks: list,
                   horizon: int, gen, policy_device) -> Trajectory:
    """All ``tasks`` in one collection of ``vec_env`` (``n_tasks *
    episodes`` slots, task-major) -> ``[n_tasks, T, episodes, ...]`` on the
    params' device. ``params`` are shared or ``[n_tasks]``-stacked."""
    n = len(tasks)
    episodes = vec_env.n_envs // n
    vec_env.set_tasks(tasks, episodes)
    device = tree_leaves(params)[0].device
    params, gen = _place_policy(policy_device, params, gen)
    pdev = tree_leaves(params)[0].device

    def action_fn(g, obs):
        x = torch.from_numpy(obs.astype(np.float32)).to(pdev)
        with torch.no_grad():
            acts = policy.sample(params, g, x.reshape(n, episodes, -1))
        COUNTS["steps"] += 1
        COUNTS["round_trips"] += pdev.type != "cpu"
        return acts.reshape(n * episodes, -1)

    traj = vec_env.collect(action_fn, gen, horizon, device=device)
    return traj.map(lambda x: x.reshape((x.shape[0], n, episodes)
                                        + x.shape[2:]).movedim(1, 0)
                    .contiguous())


def make_grouped_host_rollout(vec_env: HostVecEnv, policy, horizon: int,
                              n_tasks: int, episodes: int,
                              policy_device: str | None = None):
    """Task-batched host rollout: all ``n_tasks`` tasks' episodes step in
    lockstep through one vec env of ``n_tasks * episodes`` slots, so each
    policy round trip serves the whole batch (``n_tasks`` times fewer than
    per-task collection), and the native pool fans every slot at once.

    -> ``roll(params, tasks, gen) -> Trajectory [n_tasks, T, episodes,
    ...]``; ``params`` shared or ``[n_tasks]``-stacked (the per-task
    adapted policies). ``policy_device``: see :func:`make_host_rollout`."""
    if vec_env.n_envs != n_tasks * episodes:
        raise ValueError(f"vec env has {vec_env.n_envs} slots, need "
                         f"{n_tasks} tasks x {episodes} episodes")

    def roll(params, tasks, gen):
        tasks, _ = _task_batch(tasks)
        return _collect_group(vec_env, policy, params, tasks, horizon, gen,
                              policy_device)

    return roll


def make_grouped_roll_factory(env_name: str, policy, cfg, seed: int,
                              test: bool = True):
    """-> ``factory(n_tasks) -> grouped rollout`` on a named host env for
    task-batched evaluation and analysis (``rl/evaluate.py:meta_test``,
    ``analysis/eval_rl.py``), memoised per ``n_tasks`` so that the eval,
    CL and RC sections share one big vec env. ``cfg`` is an ``RLConfig``
    (episodes ``adapt_batch_size``, horizon ``max_path_length``)."""
    cache: dict = {}

    def factory(n: int):
        if n not in cache:
            from exploring_meta_tpu_torch.envs.factory import make_env
            big, _ = make_env(env_name, workers=n * cfg.adapt_batch_size,
                              seed=seed, test=test,
                              max_path_length=cfg.max_path_length)
            cache[n] = make_grouped_host_rollout(big, policy,
                                                 cfg.max_path_length, n,
                                                 cfg.adapt_batch_size)
        return cache[n]

    return factory


def make_host_rollout(vec_env: HostVecEnv, policy, horizon: int,
                      policy_device: str | None = None):
    """Per-task host rollout, the device rollout's signature: ``roll(params,
    task, gen)``. One task gives ``[T, E, ...]`` (shared params); a task
    batch is collected one task after another, task i under row i of
    ``[B]``-stacked params (or the shared ones), -> ``[B, T, E, ...]``.

    ``policy_device`` (``None``: the module default): ``"cpu"`` runs the
    per-step forwards on the CPU (:func:`set_host_policy_device`)."""

    def roll(params, task, gen):
        tasks, batched = _task_batch(task)
        stacked = params["sigma"].ndim > 1
        trajs = [_collect_group(
            vec_env, policy,
            tree_map(lambda t: t[i:i + 1], params) if stacked else params,
            [t], horizon, gen, policy_device) for i, t in enumerate(tasks)]
        if not batched:
            return trajs[0].map(lambda x: x[0])
        return Trajectory(*(torch.cat(xs) for xs in zip(*trajs)))

    return roll
