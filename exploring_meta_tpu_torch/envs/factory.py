"""Env construction by name (port of ``exploring_meta_tpu/envs/factory.py``;
reference ``utils/env_maker.py``).

``Particles2D-v1`` is the batched device env; ``AntDirection-v1`` and the
Meta-World benchmarks (``ML1_<task>``, ``ML10``, ``ML45``) run host physics
behind :class:`~exploring_meta_tpu_torch.envs.host.HostVecEnv`.
"""

from __future__ import annotations

import itertools

from exploring_meta_tpu_torch.envs.particles2d import Particles2D


def make_env(name: str, workers: int = 1, seed: int = 42,
             test: bool = False, max_path_length: int = 150,
             backend: str = "auto", n_threads: int | None = None):
    """-> ``(env, is_device_env)``. ``workers`` is the host envs' episode
    slots (the reference's AsyncVectorEnv worker count,
    ``env_maker.py:18-21``); they step through the native thread pool when
    it can run (``backend="auto"``), ``n_threads`` capping its threads
    (default: min(workers, the CPUs this process may use)). Particles2D's
    goals carry no train/test split, and the host-env arguments do not
    change it."""
    if name.startswith("Particles2D"):
        return Particles2D(), True

    if name.startswith("AntDirection"):
        from exploring_meta_tpu_torch.envs.host import (
            AntDirectionEnv, HostVecEnv,
        )
        # per-slot seeds (gym AsyncVectorEnv seeds worker i with seed + i):
        # one seed would put every slot's np_random in lockstep
        ctr = itertools.count()
        return HostVecEnv(lambda: AntDirectionEnv(seed=seed + next(ctr)),
                          workers, backend=backend,
                          n_threads=n_threads), False

    if name.startswith("ML"):
        from exploring_meta_tpu_torch.envs.host import HostVecEnv
        from exploring_meta_tpu_torch.envs.metaworld_adapter import (
            MetaWorldEnv, make_benchmark,
        )
        if name.startswith("ML1_"):
            bench, task_name = "ML1", name[4:]
        else:
            bench, task_name = name, None
        # one benchmark for all slots (building one parses every class's
        # task pickles); the slots differ only in their reset-noise stream
        # (seed + slot), and sample_tasks reads slot 0's
        shared = make_benchmark(bench, task_name, seed=seed)
        ctr = itertools.count()
        return HostVecEnv(
            lambda: MetaWorldEnv(bench, task_name, seed=seed + next(ctr),
                                 test=test, max_path_length=max_path_length,
                                 benchmark=shared),
            workers, backend=backend, n_threads=n_threads), False

    raise ValueError(f"unknown environment {name!r}")


def calculate_samples_seen(max_path_length: int, episodes: int,
                           adapt_steps: int, meta_batch_size: int,
                           num_iterations: int) -> int:
    """Sample budget (reference ``env_maker.py:63-72``): samples an
    iteration = steps x episodes x (adapt_steps + 1) x tasks."""
    per_iter = max_path_length * episodes * (adapt_steps + 1) * meta_batch_size
    total = per_iter * num_iterations
    print(f"Samples per iteration: {per_iter}; total: {total}")
    return total
