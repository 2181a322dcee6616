"""Env construction by name (the device-env half of
``exploring_meta_tpu/envs/factory.py``)."""

from __future__ import annotations

from exploring_meta_tpu_torch.envs.particles2d import Particles2D


def make_env(name: str):
    """``Particles2D*`` -> the batched device env. The host-physics envs
    (MuJoCo Ant, Meta-World) are not ported yet."""
    if name.startswith("Particles2D"):
        return Particles2D()
    raise NotImplementedError(
        f"env {name!r}: host envs (MuJoCo, Meta-World) are not ported yet "
        "(ROADMAP Queue 1, later slices: host envs)")
