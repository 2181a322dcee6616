"""Console entry points of the port (counterparts of
``exploring_meta_tpu/cli.py``; the flag surface is the JAX package's).

    python -m exploring_meta_tpu_torch.cli maml_trpo --num_iterations 3
    EMT_FORCE_CPU=1 python -m exploring_meta_tpu_torch.cli maml_trpo ...

Runs go to the card unless ``EMT_FORCE_CPU=1`` asks for the CPU.
"""

from __future__ import annotations

import sys


def _rl_main(algo: str, anil: bool, description: str, argv=None) -> dict:
    from exploring_meta_tpu_torch.trainers.rl import RLTrainer
    from exploring_meta_tpu_torch.utils.config import (
        RLScriptConfig, requested_device, rl_argparser,
    )

    args = rl_argparser(RLScriptConfig(), description).parse_args(argv)
    cfg = RLScriptConfig(**vars(args))
    return RLTrainer(cfg, algo=algo, anil=anil,
                     device=requested_device()).run()


def maml_trpo(argv=None) -> dict:
    """MAML-TRPO meta-training (``emt-maml-trpo``)."""
    return _rl_main("trpo", False, "MAML-TRPO on Meta-RL", argv)


if __name__ == "__main__":
    if sys.argv[1:2] != ["maml_trpo"]:
        sys.exit("usage: python -m exploring_meta_tpu_torch.cli maml_trpo "
                 "[flags]")
    maml_trpo(sys.argv[2:])
