"""Meta-World ML1 / ML10 / ML45 adapter (port of
``exploring_meta_tpu/envs/metaworld_adapter.py``, its own copy; reference
``utils/metaworld_wrapper.py``): bridges Meta-World's benchmark API to the
framework's task API (``sample_tasks`` / ``set_task``) with the
reference's episode semantics: ``done`` forced at the horizon and info
stripped to the ``success`` flag (``metaworld_wrapper.py:30-40``).

Pure numpy. ``metaworld`` is imported when a benchmark is built, never
when this module is imported (the card's machine lacks it); without it,
construction raises a clear ``ImportError``.
"""

from __future__ import annotations

import numpy as np


def _require_metaworld():
    try:
        import metaworld  # noqa: F401
        return metaworld
    except ImportError as e:  # pragma: no cover
        raise ImportError(
            "Meta-World is not installed. The MetaWorldML* envs need the "
            "`metaworld` package (and MuJoCo); install it or use "
            "Particles2D-v1 / AntDirection-v1.") from e


def make_benchmark(benchmark_name: str, task_name: str | None = None,
                   seed: int = 42):
    """Construct a metaworld benchmark object (shareable across env
    slots via ``MetaWorldEnv(benchmark=...)``)."""
    metaworld = _require_metaworld()
    if benchmark_name == "ML1":
        return metaworld.ML1(task_name, seed=seed)
    if benchmark_name == "ML10":
        return metaworld.ML10(seed=seed)
    if benchmark_name == "ML45":
        return metaworld.ML45(seed=seed)
    raise ValueError(f"unknown Meta-World benchmark {benchmark_name}")


class MetaWorldEnv:
    """One Meta-World benchmark env with the framework's task API."""

    def __init__(self, benchmark_name: str, task_name: str | None = None,
                 seed: int = 42, test: bool = False,
                 max_path_length: int = 150, benchmark=None):
        """``benchmark``: a pre-built metaworld benchmark to share across
        env slots (benchmark construction parses every class's task
        pickles — minutes for ML45 — and the factory's vec envs only
        differ per slot in their reset-noise RNG, not the task pool)."""
        self._bench = (benchmark if benchmark is not None
                       else make_benchmark(benchmark_name, task_name, seed))

        classes = (self._bench.test_classes if test
                   else self._bench.train_classes)
        self._tasks = [t for t in (self._bench.test_tasks if test
                                   else self._bench.train_tasks)]
        self._classes = classes
        self._class_names = list(classes.keys())
        self._rng = np.random.default_rng(seed)
        self.max_path_length = max_path_length
        self._env = None
        self._env_cache: dict = {}  # class name -> constructed env
        self._steps = 0

        first = classes[self._class_names[0]]()
        # keep the probe env: set_task reuses it for its class instead of
        # re-parsing the same MuJoCo model (seeding happens there, so the
        # RNG draw order is unchanged)
        self._probe = first
        self.obs_size = int(np.prod(first.observation_space.shape))
        self.action_size = int(np.prod(first.action_space.shape))
        # ActionSpaceScaler parity (reference utils/env_maker.py:39): the
        # raw Gaussian sample is stored for log-probs, but the physics
        # sees an action clamped to the space bounds (same contract as
        # ``envs/host.py:AntDirectionEnv``).
        self._act_low = np.asarray(first.action_space.low, np.float64)
        self._act_high = np.asarray(first.action_space.high, np.float64)

    # -- task API -----------------------------------------------------------

    def sample_tasks(self, gen, n: int) -> list:
        del gen  # the adapter's own numpy stream draws, as JAX ignores its key
        idx = self._rng.integers(0, len(self._tasks), size=n)
        out = []
        for i in idx:
            task = self._tasks[int(i)]
            out.append({"task": self._class_names.index(task.env_name),
                        "mw_task": task})
        return out

    def set_task(self, task) -> None:
        mw_task = task["mw_task"]
        name = mw_task.env_name
        if name not in self._env_cache:
            # Construct once per class (MuJoCo model parsing is expensive)
            # and seed its np_random from the adapter's stream so reset
            # noise is reproducible — a fresh env per set_task call would
            # draw initial states from OS entropy.
            if name == self._class_names[0] and self._probe is not None:
                env, self._probe = self._probe, None
            else:
                env = self._classes[name]()
            env.reset(seed=int(self._rng.integers(0, 2**31 - 1)))
            self._env_cache[name] = env
        self._env = self._env_cache[name]
        self._env.set_task(mw_task)
        self._steps = 0

    # -- episode API (reference metaworld_wrapper.py:30-53) ------------------

    def reset(self, seed: int | None = None):
        self._steps = 0
        obs, _ = self._env.reset(seed=seed)
        return np.asarray(obs, np.float32)

    def step(self, action):
        action = np.clip(np.asarray(action), self._act_low, self._act_high)
        obs, reward, terminated, truncated, info = self._env.step(action)
        self._steps += 1
        done = bool(terminated) or self._steps >= self.max_path_length
        success = float(info.get("success", 0.0))
        return (np.asarray(obs, np.float32), float(reward), done,
                bool(truncated), success)

    def set_max_path_length(self, n: int) -> None:
        self.max_path_length = n

    def get_max_path_length(self) -> int:
        return self.max_path_length


def MetaWorldML1(task_name: str, seed: int = 42, test: bool = False,
                 max_path_length: int = 150) -> MetaWorldEnv:
    return MetaWorldEnv("ML1", task_name, seed=seed, test=test,
                        max_path_length=max_path_length)


def MetaWorldML10(seed: int = 42, test: bool = False,
                  max_path_length: int = 150) -> MetaWorldEnv:
    return MetaWorldEnv("ML10", seed=seed, test=test,
                        max_path_length=max_path_length)


def MetaWorldML45(seed: int = 42, test: bool = False,
                  max_path_length: int = 150) -> MetaWorldEnv:
    return MetaWorldEnv("ML45", seed=seed, test=test,
                        max_path_length=max_path_length)
