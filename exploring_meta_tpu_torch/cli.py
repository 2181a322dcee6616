"""Console entry points of the port (counterparts of
``exploring_meta_tpu/cli.py``; the flag surface is the JAX package's).

    python -m exploring_meta_tpu_torch.cli maml_vision --num_iterations 3
    python -m exploring_meta_tpu_torch.cli anil_vision --dataset min ...
    python -m exploring_meta_tpu_torch.cli maml_trpo --num_iterations 3
    python -m exploring_meta_tpu_torch.cli anil_ppo --num_iterations 3
    EMT_FORCE_CPU=1 python -m exploring_meta_tpu_torch.cli maml_vision ...

Runs go to the card unless ``EMT_FORCE_CPU=1`` asks for the CPU.
"""

from __future__ import annotations

import sys


def _vision_main(anil: bool, description: str, argv=None) -> float:
    from exploring_meta_tpu_torch.trainers.vision import VisionTrainer
    from exploring_meta_tpu_torch.utils.config import (
        VisionConfig, anil_vision_defaults, requested_device,
        vision_argparser,
    )

    defaults = anil_vision_defaults() if anil else VisionConfig()
    args = vision_argparser(defaults, description).parse_args(argv)
    return VisionTrainer(VisionConfig(**vars(args)), anil=anil,
                         device=requested_device()).run()


def _rl_main(algo: str, anil: bool, description: str, argv=None) -> dict:
    from exploring_meta_tpu_torch.trainers.rl import RLTrainer
    from exploring_meta_tpu_torch.utils.config import (
        RLScriptConfig, requested_device, rl_argparser,
    )

    args = rl_argparser(RLScriptConfig(), description).parse_args(argv)
    cfg = RLScriptConfig(**vars(args))
    return RLTrainer(cfg, algo=algo, anil=anil,
                     device=requested_device()).run()


def maml_vision(argv=None) -> float:
    """MAML few-shot vision meta-training (``emt-maml-vision``)."""
    return _vision_main(False, "MAML on Vision", argv)


def anil_vision(argv=None) -> float:
    """ANIL few-shot vision meta-training (``emt-anil-vision``)."""
    return _vision_main(True, "ANIL on Vision", argv)


def maml_trpo(argv=None) -> dict:
    """MAML-TRPO meta-training (``emt-maml-trpo``)."""
    return _rl_main("trpo", False, "MAML-TRPO on Meta-RL", argv)


def anil_trpo(argv=None) -> dict:
    """ANIL-TRPO meta-training (``emt-anil-trpo``)."""
    return _rl_main("trpo", True, "ANIL-TRPO on Meta-RL", argv)


def maml_ppo(argv=None) -> dict:
    """MAML-PPO meta-training (``emt-maml-ppo``)."""
    return _rl_main("ppo", False, "MAML-PPO on Meta-RL", argv)


def anil_ppo(argv=None) -> dict:
    """ANIL-PPO meta-training (``emt-anil-ppo``)."""
    return _rl_main("ppo", True, "ANIL-PPO on Meta-RL", argv)


def maml_vpg(argv=None) -> dict:
    """MAML-VPG meta-training (``emt-maml-vpg``)."""
    return _rl_main("vpg", False, "MAML-VPG on Meta-RL", argv)


def anil_vpg(argv=None) -> dict:
    """ANIL-VPG meta-training (``emt-anil-vpg``)."""
    return _rl_main("vpg", True, "ANIL-VPG on Meta-RL", argv)


COMMANDS = {"maml_vision": maml_vision, "anil_vision": anil_vision,
            "maml_trpo": maml_trpo, "anil_trpo": anil_trpo,
            "maml_ppo": maml_ppo, "anil_ppo": anil_ppo,
            "maml_vpg": maml_vpg, "anil_vpg": anil_vpg}

if __name__ == "__main__":
    if len(sys.argv) < 2 or sys.argv[1] not in COMMANDS:
        sys.exit("usage: python -m exploring_meta_tpu_torch.cli "
                 f"{{{','.join(COMMANDS)}}} [flags]")
    COMMANDS[sys.argv[1]](sys.argv[2:])
