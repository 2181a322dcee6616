"""Script configs and flags (port of ``VisionConfig``,
``anil_vision_defaults``, ``vision_argparser``, ``RLScriptConfig``,
``rl_argparser`` and the ``EMT_FORCE_CPU`` switch of
``exploring_meta_tpu/utils/config.py``).

The fields, defaults and flag names are the JAX package's, so a run's
``logger.json`` config reads the same. One default differs: the vision
``conv_impl`` is ``"fused"`` (the CNN4 kernels; JAX's ``"pallas"`` is
accepted and means the same), where JAX has ``"direct"``. ``--mesh N``
runs the trainers over N ranks (``parallel/launch.py``): one card a rank
with NCCL, or, under ``EMT_FORCE_CPU=1``, N CPU processes with gloo.
"""

from __future__ import annotations

import argparse
import os
from dataclasses import asdict, dataclass

# stride-2 conv lowerings: the JAX flag's names -> the port's
# (models/layers.py:set_conv_impl); "pallas" runs the fused CUDA kernels
CONV_IMPLS = {"direct": "direct", "s2d": "s2d", "pallas": "fused",
              "fused": "fused"}


def requested_device() -> str | None:
    """``EMT_FORCE_CPU=1`` is the explicit request to run on the CPU ->
    ``"cpu"``; otherwise ``None``, the card."""
    return "cpu" if os.environ.get("EMT_FORCE_CPU") == "1" else None


@dataclass
class VisionConfig:
    """Defaults of the reference ``vision/maml_vision.py:15-25`` and the
    JAX package's extras, except ``conv_impl``."""
    dataset: str = "omni"
    ways: int = 5
    shots: int = 1
    outer_lr: float = 0.003
    inner_lr: float = 0.5
    adapt_steps: int = 1
    meta_batch_size: int = 32
    num_iterations: int = 5000
    save_every: int = 1000
    seed: int = 42
    synthetic: bool = False      # force synthetic data
    synth_classes: int = 0       # synthetic class count (0: small default;
                                 # 1623: real Omniglot shape)
    synth_per_class: int = 0     # synthetic samples a class (0: default;
                                 # 20 omni / 600 min: real shape)
    mesh: int = 1                # devices for task-DP sharding
    use_wandb: bool = False
    resume: str = ""             # checkpoint to resume training from
    profile: bool = False        # per-phase timing -> phase_times.json
    trace: str = ""              # device trace directory
    fuse: int = 1                # iterations fused per device program
    async_ckpt: bool = False     # checkpoint writes on a background thread
    bf16: bool = False           # bf16 compute graph, f32 master params
    remat_body: bool = False     # ANIL: checkpoint the body conv blocks
    conv_impl: str = "fused"     # stride-2 conv lowering: "fused" (the CNN4
                                 # CUDA kernels; JAX: "pallas") | "direct"
                                 # | "s2d"
    nan_guard: bool = True       # stop + save when train loss goes non-finite
    ckpt_backend: str = "npz"    # "npz" | "orbax"
    compile_cache: str = ""      # persistent compile cache directory

    def to_params(self) -> dict:
        return asdict(self)


def anil_vision_defaults() -> VisionConfig:
    """ANIL-vision defaults (reference ``vision/anil_vision.py``: outer_lr
    0.001, inner_lr 0.1)."""
    return VisionConfig(outer_lr=0.001, inner_lr=0.1)


def _conv_impl(name: str) -> str:
    if name not in CONV_IMPLS:
        raise argparse.ArgumentTypeError(
            f"invalid choice {name!r} (choose from direct, s2d, pallas, "
            f"fused)")
    return CONV_IMPLS[name]


def vision_argparser(defaults: VisionConfig,
                     description: str) -> argparse.ArgumentParser:
    """The JAX package's vision flags, with ``defaults`` as their
    defaults; ``--conv_impl pallas`` parses to ``"fused"``."""
    p = argparse.ArgumentParser(description=description)
    for name in ("dataset", "resume", "trace", "compile_cache"):
        p.add_argument(f"--{name}", type=str, default=getattr(defaults, name))
    for name in ("outer_lr", "inner_lr"):
        p.add_argument(f"--{name}", type=float,
                       default=getattr(defaults, name))
    for name in ("ways", "shots", "adapt_steps", "meta_batch_size",
                 "num_iterations", "save_every", "seed", "synth_classes",
                 "synth_per_class", "mesh", "fuse"):
        p.add_argument(f"--{name}", type=int, default=getattr(defaults, name))
    for name in ("synthetic", "profile", "async_ckpt", "bf16", "remat_body"):
        p.add_argument(f"--{name}", action="store_true",
                       default=getattr(defaults, name))
    p.add_argument("--wandb", dest="use_wandb", action="store_true",
                   default=defaults.use_wandb)
    p.add_argument("--ckpt_backend", choices=["npz", "orbax"],
                   default=defaults.ckpt_backend)
    p.add_argument("--conv_impl", type=_conv_impl,
                   default=defaults.conv_impl,
                   help="stride-2 conv lowering: fused (the CNN4-Omniglot "
                        "base on the fused CUDA kernels; 'pallas' is the "
                        "JAX name for it), direct, or s2d")
    p.add_argument("--no_nan_guard", dest="nan_guard", action="store_false",
                   default=defaults.nan_guard,
                   help="disable the divergence watchdog")
    return p


@dataclass
class RLScriptConfig:
    """Flag surface of the reference RL scripts (``rl/maml_trpo.py:19-40``
    field names plus the TRPO/PPO knobs), with the JAX package's numeric
    defaults."""
    env: str = "Particles2D-v1"
    outer_lr: float = 0.1
    inner_lr: float = 0.05
    adapt_steps: int = 1
    meta_batch_size: int = 20
    adapt_batch_size: int = 20
    num_iterations: int = 250
    save_every: int = 25
    seed: int = 42
    gamma: float = 0.99
    tau: float = 1.0
    max_path_length: int = 100
    # TRPO outer step
    backtrack_factor: float = 0.5
    ls_max_steps: int = 15
    max_kl: float = 0.01
    # PPO inner loop
    ppo_epochs: int = 3
    ppo_clip_ratio: float = 0.3
    # extras
    n_eval_tasks: int = 10
    fc_neurons: int = 100        # ANIL policy head width
    activation: str = "relu"     # DiagNormalPolicy hidden activation
    workers: int = 1             # host-env physics thread-pool cap
    use_wandb: bool = False
    mesh: int = 1                # devices for task-DP sharding
    profile: bool = False        # per-phase timing -> phase_times.json
    trace: str = ""              # device trace directory
    fuse: int = 1                # iterations fused per device program
    task_batch: bool = False     # host envs: one meta_batch*episodes vec env
    async_ckpt: bool = False     # checkpoint writes on a background thread
    resume: str = ""             # checkpoint to resume training from
    bf16: bool = False           # bf16 policy compute, f32 master params
    nan_guard: bool = True       # stop + save when train loss goes non-finite
    ckpt_backend: str = "npz"    # "npz" | "orbax"
    host_policy: str = "device"  # host envs: where per-step forwards run
    compile_cache: str = ""      # persistent compile cache directory

    def to_params(self) -> dict:
        return asdict(self)


def rl_argparser(defaults: RLScriptConfig,
                 description: str) -> argparse.ArgumentParser:
    """The JAX package's RL flags, with ``defaults`` as their defaults."""
    p = argparse.ArgumentParser(description=description)
    for name in ("env", "trace", "resume", "compile_cache"):
        p.add_argument(f"--{name}", type=str, default=getattr(defaults, name))
    # as in JAX, the TRPO line-search and PPO knobs have no flag
    for name in ("outer_lr", "inner_lr", "gamma", "tau"):
        p.add_argument(f"--{name}", type=float,
                       default=getattr(defaults, name))
    for name in ("adapt_steps", "meta_batch_size", "adapt_batch_size",
                 "num_iterations", "save_every", "seed", "max_path_length",
                 "n_eval_tasks", "fc_neurons", "workers", "mesh", "fuse"):
        p.add_argument(f"--{name}", type=int, default=getattr(defaults, name))
    for name in ("profile", "task_batch", "async_ckpt", "bf16"):
        p.add_argument(f"--{name}", action="store_true",
                       default=getattr(defaults, name))
    p.add_argument("--activation", choices=["relu", "tanh"],
                   default=defaults.activation)
    p.add_argument("--wandb", dest="use_wandb", action="store_true",
                   default=defaults.use_wandb)
    p.add_argument("--ckpt_backend", choices=["npz", "orbax"],
                   default=defaults.ckpt_backend)
    p.add_argument("--host_policy", choices=["device", "cpu"],
                   default=defaults.host_policy)
    p.add_argument("--no_nan_guard", dest="nan_guard", action="store_false",
                   default=defaults.nan_guard,
                   help="disable the divergence watchdog")
    return p
