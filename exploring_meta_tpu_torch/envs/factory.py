"""Env construction by name (port of the device-env half of
``exploring_meta_tpu/envs/factory.py``; reference ``utils/env_maker.py``).
"""

from __future__ import annotations

from exploring_meta_tpu_torch.envs.particles2d import Particles2D

HOST_ENVS = ("host envs (MuJoCo, Meta-World) are not ported yet (ROADMAP "
             "Queue 1, later slices: host envs)")


def make_env(name: str, workers: int = 1, seed: int = 42,
             test: bool = False, max_path_length: int = 150,
             backend: str = "auto", n_threads: int | None = None):
    """-> ``(env, is_device_env)``, the JAX signature. ``Particles2D*`` is
    the batched device env; its goals carry no train/test split, so
    ``test``, and the host envs' ``workers``, ``seed``,
    ``max_path_length``, ``backend`` and ``n_threads``, do not change it.
    The host-physics envs (MuJoCo Ant, Meta-World) are not ported yet."""
    if name.startswith("Particles2D"):
        return Particles2D(), True
    raise NotImplementedError(f"env {name!r}: {HOST_ENVS}")
