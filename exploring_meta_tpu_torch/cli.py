"""Console entry points of the port (counterparts of
``exploring_meta_tpu/cli.py``; the flag surface is the JAX package's).

    python -m exploring_meta_tpu_torch.cli maml_vision --num_iterations 3
    python -m exploring_meta_tpu_torch.cli anil_vision --dataset min ...
    python -m exploring_meta_tpu_torch.cli maml_trpo --num_iterations 3
    python -m exploring_meta_tpu_torch.cli anil_ppo --num_iterations 3
    python -m exploring_meta_tpu_torch.cli eval_vision <run_dir>
    python -m exploring_meta_tpu_torch.cli eval_rl <run_dir> --cl --rc
    python -m exploring_meta_tpu_torch.cli maml_ppo --env ML10 --task_batch
    python -m exploring_meta_tpu_torch.cli eval_rl <run_dir> --each3 \
        --task_batch --cl --rc
    python -m exploring_meta_tpu_torch.cli ppo_baseline --num_iterations 3
    python -m exploring_meta_tpu_torch.cli vision_baseline --synthetic
    python -m exploring_meta_tpu_torch.cli maml_ppo --resume \
        results/<run>/model_checkpoints/model_<i>.npz
    python -m exploring_meta_tpu_torch.cli import_reference_ckpt <src> <dst>
    python -m exploring_meta_tpu_torch.cli pack_datasets omniglot --src <dir>
    python -m exploring_meta_tpu_torch.cli sweep maml_trpo --seeds 42,7 \
        [--vmap_seeds --fuse 10]
    EMT_FORCE_CPU=1 python -m exploring_meta_tpu_torch.cli maml_vision ...

Runs go to the card unless ``EMT_FORCE_CPU=1`` asks for the CPU; the two
offline tools run on the host.
"""

from __future__ import annotations

import argparse
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


def _rl_baseline_main(name: str, description: str, argv=None) -> dict:
    from exploring_meta_tpu_torch.trainers import baselines
    from exploring_meta_tpu_torch.utils.config import (
        RLScriptConfig, requested_device, rl_argparser,
    )

    args = rl_argparser(RLScriptConfig(), description).parse_args(argv)
    return getattr(baselines, name)(RLScriptConfig(**vars(args)),
                                    device=requested_device()).run()


def ppo_baseline(argv=None) -> dict:
    """Plain PPO baseline (``scripts/baselines/ppo.py``)."""
    return _rl_baseline_main(
        "PPOBaseline", "Plain PPO baseline (reference baselines/ppo.py).",
        argv)


def trpo_baseline(argv=None) -> dict:
    """Plain TRPO baseline (``scripts/baselines/trpo.py``)."""
    return _rl_baseline_main(
        "TRPOBaseline", "Plain TRPO baseline (reference baselines/trpo.py).",
        argv)


def random_baseline(argv=None) -> dict:
    """Random-policy baseline (``scripts/baselines/random.py``)."""
    return _rl_baseline_main(
        "RandomPolicyBaseline",
        "Random-policy baseline (reference baselines/random.py).", argv)


def vision_baseline(argv=None) -> float:
    """Supervised vision baseline (``scripts/baselines/vision.py``: Adam
    1e-3, 100 iterations by default)."""
    from exploring_meta_tpu_torch.trainers.baselines import VisionBaseline
    from exploring_meta_tpu_torch.utils.config import (
        VisionConfig, requested_device, vision_argparser,
    )

    defaults = VisionConfig(outer_lr=0.001, num_iterations=100)
    args = vision_argparser(defaults, "Vision baseline").parse_args(argv)
    return VisionBaseline(VisionConfig(**vars(args)),
                          device=requested_device()).run()


def eval_vision(argv=None) -> dict:
    """Offline vision evaluation of a run directory (``emt-eval-vision``;
    reference ``misc_scripts/eval_vision.py``)."""
    from exploring_meta_tpu_torch.utils.config import requested_device

    p = argparse.ArgumentParser(description="Evaluate a vision run directory")
    p.add_argument("path", help="run directory (results/<algo>_<dataset>_...)")
    p.add_argument("--no_cl", action="store_true")
    p.add_argument("--no_rc", action="store_true")
    p.add_argument("--synthetic", action="store_true")
    args = p.parse_args(argv)
    from exploring_meta_tpu_torch.analysis import eval_vision as ev
    return ev.run(args.path, run_cl=not args.no_cl, run_rc=not args.no_rc,
                  synthetic=args.synthetic or None, device=requested_device())


def eval_rl(argv=None) -> dict:
    """Offline RL evaluation of a run directory (``emt-eval-rl``; reference
    ``misc_scripts/eval_rl.py``)."""
    from exploring_meta_tpu_torch.utils.config import requested_device

    p = argparse.ArgumentParser(description="Evaluate an RL run directory")
    p.add_argument("path", help="run directory")
    p.add_argument("--cl", action="store_true", help="run CL experiment")
    p.add_argument("--rc", action="store_true",
                   help="run rep-change experiment")
    p.add_argument("--n_eval_tasks", type=int, default=None)
    p.add_argument("--each3", action="store_true",
                   help="3 trials per distinct task (reference eval_rl.py:33)")
    p.add_argument("--task", type=str, default=None,
                   help="explicit ML10 task name to evaluate, e.g. "
                        "'door-close' (reference eval_params['n_tasks'] "
                        "string mode)")
    p.add_argument("--test_on_train", action="store_true",
                   help="meta-test on the benchmark's TRAIN tasks "
                        "(reference eval_rl.py:32)")
    p.add_argument("--checkpoint", type=int, default=None,
                   help="evaluate model_checkpoints/model_<N>.npz instead "
                        "of the final model (reference eval_rl.py:29)")
    p.add_argument("--workers", type=int, default=None,
                   help="host-env episode slots (defaults to "
                        "adapt_batch_size)")
    p.add_argument("--task_batch", action="store_true",
                   help="host envs: adapt+evaluate all tasks in lockstep "
                        "through one n_tasks*episodes vec env")
    p.add_argument("--host_policy", choices=["device", "cpu"],
                   default="device",
                   help="host envs: where per-step policy forwards run "
                        "during collection")
    args = p.parse_args(argv)
    if args.host_policy != "device":
        from exploring_meta_tpu_torch.envs.host import set_host_policy_device
        set_host_policy_device(args.host_policy)
    from exploring_meta_tpu_torch.analysis import eval_rl as er
    return er.run(args.path, run_cl=args.cl, run_rc=args.rc,
                  n_eval_tasks=args.task or args.n_eval_tasks,
                  each3=args.each3, test_on_train=args.test_on_train,
                  checkpoint=args.checkpoint, workers=args.workers,
                  task_batch=args.task_batch, device=requested_device())


def import_reference_ckpt(argv=None) -> str:
    """Import a reference-trained run dir (torch ``state_dict``s) into a
    run dir of the port's contract (``scripts/import_reference_ckpt.py``;
    ``utils/import_torch.py``)."""
    p = argparse.ArgumentParser(
        description="Import a reference run dir (torch state_dict "
                    "checkpoints) into a run dir that evaluation and "
                    "serving read")
    p.add_argument("src", help="reference run dir (holds logger.json + .pt)")
    p.add_argument("dst", help="output run dir")
    p.add_argument("--kind", default=None,
                   choices=["maml_vision", "anil_vision", "maml_rl",
                            "anil_rl"])
    args = p.parse_args(argv)
    from exploring_meta_tpu_torch.utils.import_torch import (
        import_reference_run,
    )
    return import_reference_run(args.src, args.dst, kind=args.kind)


def pack_datasets(argv=None) -> None:
    """One-time host-side packing of real downloads into the sampler's
    arrays (``emt-pack-datasets``; ``tasks/pack.py``)."""
    import os
    p = argparse.ArgumentParser(
        description="Pack original dataset downloads into the on-device "
                    "sampler's [n_classes, n_per_class, H, W, C] arrays")
    p.add_argument("dataset", choices=["omniglot", "mini-imagenet"])
    p.add_argument("--src", required=True, help="original download dir")
    p.add_argument("--out", default=os.path.expanduser(
        "~/data/exploring_meta_tpu"))
    args = p.parse_args(argv)
    from exploring_meta_tpu_torch.tasks.pack import (
        pack_mini_imagenet, pack_omniglot,
    )
    if args.dataset == "omniglot":
        pack_omniglot(args.src, args.out)
    else:
        pack_mini_imagenet(args.src, args.out)


def sweep(argv=None) -> dict:
    """A seed sweep of one trainer configuration, serial or as one
    program (``--vmap_seeds``) (``scripts/sweep.py``; ``sweep.py``)."""
    from exploring_meta_tpu_torch.sweep import main
    return main(argv)


COMMANDS = {"maml_vision": maml_vision, "anil_vision": anil_vision,
            "maml_trpo": maml_trpo, "anil_trpo": anil_trpo,
            "maml_ppo": maml_ppo, "anil_ppo": anil_ppo,
            "maml_vpg": maml_vpg, "anil_vpg": anil_vpg,
            "eval_vision": eval_vision, "eval_rl": eval_rl,
            "ppo_baseline": ppo_baseline, "trpo_baseline": trpo_baseline,
            "random_baseline": random_baseline,
            "vision_baseline": vision_baseline,
            "import_reference_ckpt": import_reference_ckpt,
            "pack_datasets": pack_datasets, "sweep": sweep}

if __name__ == "__main__":
    if len(sys.argv) < 2 or sys.argv[1] not in COMMANDS:
        sys.exit("usage: python -m exploring_meta_tpu_torch.cli "
                 f"{{{','.join(COMMANDS)}}} [flags]")
    COMMANDS[sys.argv[1]](sys.argv[2:])
