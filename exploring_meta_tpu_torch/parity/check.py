"""Accuracy parity of the port against a torch reproduction of the
reference, trained on the same data and task distribution (port of
``scripts/parity_check.py``).

Vision mode (default): the target (``BASELINE.json``) is meta-test
accuracy within 0.5 % of the PyTorch/learn2learn reference. Both sides
train on the same synthetic episodic dataset (the same packed arrays and
split) with the same hyperparameters, and meta-test accuracy is compared
over many tasks. The port's side is its own meta-learning path
(``adapt/vision.py``, ``adapt/maml.py``; on the Omniglot spec the CNN4
CUDA kernels); the reference's side is ``parity/reference_vision.py``.
Prints one JSON line::

    {"dataset": ..., "anil": ..., "port_acc": ..., "torch_acc": ...,
     "diff": ..., "device": {"port": ..., "reference": ...},
     "reference_threads": ...}

RL mode (``--rl trpo|ppo|vpg``): trains the port's MAML-{TRPO,PPO,VPG}
(or ANIL) on Particles2D beside the torch reproduction of the reference
algorithm (``parity/reference_rl.py``) with the same hyperparameters and
independent random streams, then compares the post-adaptation meta-test
reward. Prints one JSON line::

    {"algo": ..., "anil": ..., "mode": ..., "port_rew": ..., "torch_rew":
     ..., "port_pre": ..., "torch_pre": ..., "diff": ..., "rel_diff": ...,
     "cfg": {...}, "device": {...}, "reference_threads": ...}

where ``rel_diff`` is the reward gap divided by the mean improvement over
the untrained policy (the scale that reward parity is read on).

The port's side runs on the card unless ``EMT_FORCE_CPU=1`` asks for the
CPU; with float32 on the card TF32 is off (``set_precision("highest")``).
The vision reference runs on the CPU unless ``--reference_device`` says
otherwise (TF32 off there too); the RL reference always runs on the CPU.
Either reference runs on one intra-op thread, recorded in the line: a
float32 reference's result moves with its thread count, since the order
of its sums does.

    python -m exploring_meta_tpu_torch.cli parity_check [--anil] [--bf16]
    python -m exploring_meta_tpu_torch.cli parity_check --dataset min \\
        --iters 100 --meta_batch 8 --inner_lr 0.1
    python -m exploring_meta_tpu_torch.cli parity_check --rl trpo [--anil]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time

import numpy as np
import torch

from exploring_meta_tpu_torch.adapt.maml import (
    adam, apply_meta_gradient, cast_compute, make_meta_eval, make_meta_step,
)
from exploring_meta_tpu_torch.adapt.vision import make_vision_fast_adapt
from exploring_meta_tpu_torch.cuda import cnn4_cuda, gae_cuda
from exploring_meta_tpu_torch.device import resolve_device
from exploring_meta_tpu_torch.envs.particles2d import Particles2D
from exploring_meta_tpu_torch.models import cnn4
from exploring_meta_tpu_torch.models.layers import (
    set_conv_impl, set_precision,
)
from exploring_meta_tpu_torch.models.policies import (
    DiagNormalPolicy, DiagNormalPolicyANIL,
)
from exploring_meta_tpu_torch.parity import reference_rl, reference_vision
from exploring_meta_tpu_torch.rl.adapt_rl import (
    RLConfig, fast_adapt_ppo, fast_adapt_vpg, make_trpo_collect,
)
from exploring_meta_tpu_torch.rl.evaluate import meta_test
from exploring_meta_tpu_torch.rl.rollout import make_rollout
from exploring_meta_tpu_torch.rl.trpo_meta import (
    TRPOConfig, make_trpo_meta_step,
)
from exploring_meta_tpu_torch.tasks.datasets import (
    load_mini_imagenet, load_omniglot,
)
from exploring_meta_tpu_torch.tasks.sampler import sample_task_batch
from exploring_meta_tpu_torch.utils.tree import tree_map

WAYS, SHOTS = 5, 1
EVAL_BATCH = 32
# The reproductions run on one intra-op thread: a float32 reference's
# trajectory depends on its thread count, since the order of its sums
# does (MAML-TRPO at seed 42 on the card machine's CPU: -24.906 on 1
# thread, -19.584 on 2, -25.178 on 8). The count goes into the line.
REFERENCE_THREADS = 1


def launch_counts() -> dict:
    """The kernel wrappers' launch counters (all zero off the card)."""
    return {**cnn4_cuda.launch_counts(), **gae_cuda.launch_counts()}


def _since(before: dict) -> dict:
    return {k: n - before[k] for k, n in launch_counts().items()}


def device_name(dev: torch.device) -> str:
    return (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else dev.type)


def vision_spec(dataset: str, anil: bool) -> cnn4.CNN4Spec:
    if dataset == "omni":
        return (cnn4.anil_omniglot_spec(ways=WAYS) if anil
                else cnn4.omniglot_spec(ways=WAYS))
    return (cnn4.anil_mini_imagenet_spec(ways=WAYS) if anil
            else cnn4.mini_imagenet_spec(ways=WAYS))


def load_vision_data(dataset: str, device=None):
    """-> (train, test) PackedDatasets of the parity run: the synthetic
    Omniglot of 160 classes or the synthetic Mini-ImageNet, data seed 0."""
    if dataset == "omni":
        train, _, test = load_omniglot(seed=0, synthetic=True,
                                       synthetic_classes=160, device=device)
    else:
        train, _, test = load_mini_imagenet(seed=0, synthetic=True,
                                            device=device)
    return train, test


def run_port(train_ds, test_ds, iters, meta_batch, inner_lr, outer_lr,
             adapt_steps, eval_tasks, seed, bf16=False, dataset="omni",
             anil=False, device=None):
    """Train the port's MAML / ANIL on ``train_ds`` (second order, Adam),
    then -> ``(meta-test accuracy over exactly eval_tasks tasks of test_ds,
    launches)``. ``launches`` holds the kernel launches of each meta-step
    (``"meta_step"``) and of each eval batch (``"eval"``)."""
    dev = resolve_device(device)
    set_conv_impl("fused")
    spec = vision_spec(dataset, anil)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = tree_map(torch.Tensor.requires_grad_,
                      cnn4.init_cnn4(gen, spec, device=dev))
    fa = make_vision_fast_adapt(spec, inner_lr, adapt_steps, SHOTS, WAYS,
                                anil=anil)
    if bf16:  # mixed precision: bf16 compute graph, f32 master params
        fa = cast_compute(fa)
    opt = adam(params, outer_lr)
    step = make_meta_step(fa)
    ev = make_meta_eval(fa)
    launches: dict = {"meta_step": [], "eval": []}
    for _ in range(iters):
        d, l = sample_task_batch(gen, train_ds, WAYS, SHOTS, meta_batch)
        before = launch_counts()
        params, opt, _ = step(params, opt, d, l)
        launches["meta_step"].append(_since(before))
    # Evaluate EXACTLY eval_tasks tasks (in batches of 32 plus one
    # remainder batch) so both implementations average over the same
    # sample size: a rounded count would skew the parity diff.
    accs, weights = [], []
    remaining = eval_tasks
    while remaining > 0:
        b = min(EVAL_BATCH, remaining)
        d, l = sample_task_batch(gen, test_ds, WAYS, SHOTS, b)
        before = launch_counts()
        accs.append(float(ev(params, d, l)["metric"]))
        launches["eval"].append(_since(before))
        weights.append(b)
        remaining -= b
    return float(np.average(accs, weights=weights)), launches


# ---------------------------------------------------------------------------
# RL parity: MAML/ANIL-{TRPO,PPO,VPG} on Particles2D vs the reproduction
# ---------------------------------------------------------------------------

def default_rl_cfg(algo: str) -> dict:
    """Shared hyperparameters for both implementations (Particles2D-scaled
    versions of reference rl/maml_trpo.py:19-40 / rl/maml_ppo.py:19-37)."""
    cfg = {
        "inner_lr": 0.05, "gamma": 0.99, "tau": 1.0,
        "adapt_steps": 1, "adapt_batch_size": 10, "max_path_length": 50,
        "meta_batch_size": 10, "num_iterations": 30, "n_eval_tasks": 40,
        # LinearValue ridge reg: the reference passes env.action_size
        # positionally into cherry's reg parameter (rl/maml_trpo.py:85),
        # so reference-exact runs use 2.0 on Particles2D (PARITY.md D9).
        "value_reg": 2.0,
        # TRPO outer
        "outer_lr": 0.3, "backtrack_factor": 0.5, "ls_max_steps": 15,
        "max_kl": 0.05,
        # PPO inner/outer
        "ppo_epochs": 3, "ppo_clip_ratio": 0.3,
    }
    if algo in ("ppo", "vpg"):
        cfg["outer_lr"] = 3e-3  # Adam
    return cfg


def run_port_rl(algo: str, cfg: dict, seed: int, bf16: bool = False,
                exact: bool = True, anil: bool = False, device=None):
    """Train the port's MAML/ANIL-{TRPO,PPO,VPG} on Particles2D with the
    building blocks of its trainer, then meta-test -> ``(post_reward,
    pre_reward, launches)``; ``launches`` holds the sweep launches of the
    pre-training meta-test, of each iteration and of the final meta-test.

    ``exact=True`` compares under reference-exact semantics (cherry's
    flat-replay-index baseline timestep and the reference's ridge of 2.0,
    PARITY.md D9); ``exact=False`` measures the port's defaults (the
    within-episode timestep and a ridge of 1e-5, the documented
    improvement)."""
    dev = resolve_device(device)
    env = Particles2D()
    if anil:  # tanh body + head/sigma-only inner updates (anil_trpo.py)
        policy = DiagNormalPolicyANIL(input_size=2, output_size=2,
                                      fc_neurons=100)
    else:
        policy = DiagNormalPolicy(input_size=2, output_size=2)
    if bf16:  # bf16 compute graph in every policy application (RL --bf16)
        policy = policy._replace(compute_dtype="bf16")
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = policy.init(gen)
    rl_cfg = RLConfig(
        inner_lr=cfg["inner_lr"], gamma=cfg["gamma"], tau=cfg["tau"],
        adapt_steps=cfg["adapt_steps"],
        adapt_batch_size=cfg["adapt_batch_size"],
        max_path_length=cfg["max_path_length"],
        ppo_epochs=cfg["ppo_epochs"],
        ppo_clip_ratio=cfg["ppo_clip_ratio"],
        anil=anil, flat_timestep=exact,
        value_reg=(cfg.get("value_reg", 2.0) if exact else 1e-5))
    roll = make_rollout(env, policy.sample,
                        episodes=cfg["adapt_batch_size"],
                        horizon=cfg["max_path_length"])
    mb = cfg["meta_batch_size"]

    # Paired evaluation: pre and post start from ONE generator state, so
    # they draw the same tasks and rollout noise, and their difference
    # isolates training.
    eval_gen = torch.Generator(device=dev).manual_seed(seed + 1000)
    eval_state = eval_gen.get_state()

    def paired_eval(p) -> tuple:
        eval_gen.set_state(eval_state)
        before = launch_counts()
        reward = meta_test(algo, "Particles2D-v1", policy, p, rl_cfg,
                           n_tasks=cfg["n_eval_tasks"], gen=eval_gen,
                           seed=seed)["mean_reward"]
        return reward, _since(before)

    pre, pre_launches = paired_eval(params)
    launches: dict = {"pre_eval": pre_launches, "train": []}

    if algo == "trpo":
        trpo_cfg = TRPOConfig(
            outer_lr=cfg["outer_lr"], max_kl=cfg["max_kl"],
            ls_max_steps=cfg["ls_max_steps"],
            backtrack_factor=cfg["backtrack_factor"])
        meta_step = make_trpo_meta_step(policy, rl_cfg, trpo_cfg,
                                        adapt_steps=cfg["adapt_steps"])
        collect = make_trpo_collect(policy, roll, rl_cfg)
        for it in range(cfg["num_iterations"]):
            before = launch_counts()
            tasks = env.sample_tasks(gen, mb)
            old_params, _, replays, m = collect(params, tasks, gen)
            params, _ = meta_step(params, old_params, replays)
            launches["train"].append(_since(before))
            if (it + 1) % 5 == 0:
                print(f"port trpo iter {it + 1}/{cfg['num_iterations']} "
                      f"adapt_reward {float(m['reward'].mean()):.3f}",
                      flush=True)
    else:
        params = tree_map(torch.Tensor.requires_grad_, params)
        opt = adam(params, cfg["outer_lr"])
        fast_adapt = fast_adapt_vpg if algo == "vpg" else fast_adapt_ppo
        for it in range(cfg["num_iterations"]):
            before = launch_counts()
            tasks = env.sample_tasks(gen, mb)
            _, losses, m = fast_adapt(policy, params, roll, tasks, gen,
                                      rl_cfg)
            apply_meta_gradient(opt, losses.mean(), params)
            launches["train"].append(_since(before))
            if (it + 1) % 5 == 0:
                print(f"port {algo} iter {it + 1}/{cfg['num_iterations']} "
                      f"adapt_reward {float(m['reward'].mean()):.3f}",
                      flush=True)

    post, launches["post_eval"] = paired_eval(params)
    return float(post), float(pre), launches


def run_torch_rl(algo: str, cfg: dict, seed: int):
    if algo == "trpo":
        return reference_rl.train_maml_trpo(cfg, seed)
    if algo == "vpg":
        return reference_rl.train_maml_vpg(cfg, seed)
    return reference_rl.train_maml_ppo(cfg, seed)


def rl_cfg(args) -> dict:
    """The RL run's hyperparameters: :func:`default_rl_cfg` with the
    flags' overrides."""
    cfg = default_rl_cfg(args.rl)
    cfg["num_iterations"] = args.iters
    if args.meta_batch:
        cfg["meta_batch_size"] = args.meta_batch
    if args.eval_tasks:
        cfg["n_eval_tasks"] = args.eval_tasks
    if args.inner_lr is not None:
        cfg["inner_lr"] = args.inner_lr
    if args.outer_lr is not None:
        cfg["outer_lr"] = args.outer_lr
    cfg["adapt_steps"] = args.adapt_steps
    cfg["anil"] = args.anil
    return cfg


@contextlib.contextmanager
def intra_op_threads(n: int):
    """Run the body on ``n`` intra-op threads, then restore the count."""
    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def rl_result(args, cfg: dict, port: tuple, reference: tuple, dev) -> dict:
    """The RL line of ``scripts/parity_check.py`` (``jax_`` renamed
    ``port_``) from ``port`` and ``reference``, each ``(post, pre)``, with
    ``device`` and ``reference_threads`` added; printed and returned."""
    (port_rew, port_pre), (torch_rew, torch_pre) = port, reference
    improvement = 0.5 * ((port_rew - port_pre) + (torch_rew - torch_pre))
    diff = abs(port_rew - torch_rew)
    out = {
        "algo": args.rl,
        "anil": args.anil,
        "mode": "improved" if args.improved else "exact",
        "port_rew": round(port_rew, 3), "torch_rew": round(torch_rew, 3),
        "port_pre": round(port_pre, 3), "torch_pre": round(torch_pre, 3),
        "diff": round(diff, 3),
        "rel_diff": round(diff / abs(improvement), 4)
        if improvement else None,
        "cfg": {k: cfg[k] for k in ("inner_lr", "outer_lr", "adapt_steps",
                                    "meta_batch_size", "num_iterations",
                                    "n_eval_tasks", "value_reg")},
        "device": {"port": device_name(dev), "reference": "cpu"},
        "reference_threads": REFERENCE_THREADS,
    }
    print(json.dumps(out), flush=True)
    return out


def rl_parity(args, device=None) -> dict:
    """RL mode: both sides trained and meta-tested -> the printed result,
    with the port's ``launches`` and both sides' wall ``seconds`` added,
    which are not printed."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        set_precision("highest")
    cfg = rl_cfg(args)
    t0 = time.perf_counter()
    port_rew, port_pre, launches = run_port_rl(
        args.rl, cfg, args.seed, bf16=args.bf16, exact=not args.improved,
        anil=args.anil, device=dev)
    print(f"port {args.rl}: pre {port_pre:.3f} -> post {port_rew:.3f}",
          flush=True)
    t1 = time.perf_counter()
    with intra_op_threads(REFERENCE_THREADS):
        torch_rew, torch_pre = run_torch_rl(args.rl, cfg, args.seed)
    print(f"torch {args.rl}: pre {torch_pre:.3f} -> post {torch_rew:.3f}",
          flush=True)
    seconds = {"port": t1 - t0, "reference": time.perf_counter() - t1}
    print(f"seconds: port {seconds['port']:.1f}, reference "
          f"{seconds['reference']:.1f}", flush=True)
    out = rl_result(args, cfg, (port_rew, port_pre), (torch_rew, torch_pre),
                    dev)
    return {**out, "launches": launches, "seconds": seconds}


def vision_parity(args, device=None) -> dict:
    """Vision mode: both sides trained and meta-tested -> the printed
    result, with the port's ``launches`` and both sides' wall ``seconds``
    added, which are not printed."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        set_precision("highest")
    train_ds, test_ds = load_vision_data(args.dataset, dev)
    t0 = time.perf_counter()
    port_acc, launches = run_port(
        train_ds, test_ds, args.iters, args.meta_batch, args.inner_lr,
        args.outer_lr, args.adapt_steps, args.eval_tasks, args.seed,
        bf16=args.bf16, dataset=args.dataset, anil=args.anil, device=dev)
    print(f"port meta-test acc: {port_acc:.4f}", flush=True)

    t1 = time.perf_counter()
    ref_dev = torch.device(args.reference_device)
    with intra_op_threads(REFERENCE_THREADS):
        torch_acc = reference_vision.run_torch(
            train_ds.images.cpu().numpy(), test_ds.images.cpu().numpy(),
            args.iters, args.meta_batch, args.inner_lr, args.outer_lr,
            args.adapt_steps, args.eval_tasks, args.seed,
            dataset=args.dataset, anil=args.anil, device=ref_dev)
    print(f"torch meta-test acc: {torch_acc:.4f}", flush=True)
    seconds = {"port": t1 - t0, "reference": time.perf_counter() - t1}
    print(f"seconds: port {seconds['port']:.1f}, reference "
          f"{seconds['reference']:.1f}", flush=True)

    out = {"dataset": args.dataset, "anil": args.anil,
           "port_acc": round(port_acc, 4),
           "torch_acc": round(torch_acc, 4),
           "diff": round(abs(port_acc - torch_acc), 4),
           "device": {"port": device_name(dev),
                      "reference": device_name(ref_dev)},
           "reference_threads": REFERENCE_THREADS}
    print(json.dumps(out), flush=True)
    return {**out, "launches": launches, "seconds": seconds}


def argparser() -> argparse.ArgumentParser:
    """The flags and defaults of ``scripts/parity_check.py``, plus
    ``--reference_device``."""
    p = argparse.ArgumentParser(
        description="Accuracy parity of the port against a torch "
                    "reproduction of the reference")
    p.add_argument("--iters", type=int, default=None)
    p.add_argument("--meta_batch", type=int, default=None)
    p.add_argument("--inner_lr", type=float, default=None,
                   help="vision default 0.5; RL default 0.05")
    p.add_argument("--outer_lr", type=float, default=None,
                   help="vision default 0.003; RL default 0.3 (TRPO) / "
                        "3e-3 (Adam)")
    p.add_argument("--adapt_steps", type=int, default=1)
    p.add_argument("--eval_tasks", type=int, default=None)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--bf16", action="store_true",
                   help="gate the bf16-compute mode (trainer --bf16)")
    p.add_argument("--rl", choices=["trpo", "ppo", "vpg"], default=None,
                   help="RL parity mode: MAML-{TRPO,PPO,VPG} on "
                        "Particles2D vs the torch reference reproduction")
    p.add_argument("--improved", action="store_true",
                   help="RL mode: use the port's default within-episode "
                        "baseline timestep instead of the reference-exact "
                        "flat replay index (measures the documented "
                        "deviation's gain)")
    p.add_argument("--dataset", choices=["omni", "min"], default="omni",
                   help="vision mode: Omniglot-shaped (28x28x1 stride-2 "
                        "CNN4) or Mini-ImageNet-shaped (84x84x3 maxpool "
                        "CNN4) synthetic data")
    p.add_argument("--anil", action="store_true",
                   help="ANIL: frozen-body head-only inner loop. Vision "
                        "mode (reference vision/anil_vision.py:86-99) and "
                        "RL mode (DiagNormalPolicyANIL, rl/anil_*.py)")
    p.add_argument("--compile_cache", type=str, default="",
                   help="kernel build directory ('' = $EMT_COMPILE_CACHE "
                        "or build/, 'off' = build/)")
    p.add_argument("--reference_device", default="cpu",
                   help="vision mode: where the torch reproduction of the "
                        "reference runs (default cpu; the RL reproduction "
                        "always runs on the CPU)")
    return p


def parse_args(argv=None) -> argparse.Namespace:
    """Parse and fill the mode's defaults, as ``scripts/parity_check.py``
    does."""
    args = argparser().parse_args(argv)
    if args.rl:
        args.iters = args.iters if args.iters is not None else 30
        return args
    args.iters = args.iters if args.iters is not None else 150
    args.meta_batch = args.meta_batch or 16
    args.eval_tasks = args.eval_tasks or 256
    args.inner_lr = 0.5 if args.inner_lr is None else args.inner_lr
    args.outer_lr = 0.003 if args.outer_lr is None else args.outer_lr
    return args


def main(argv=None, device=None) -> dict:
    """Run one parity check -> its result. ``device`` is the port's side
    (``None``: the card)."""
    from exploring_meta_tpu_torch.utils.compile_cache import (
        enable_compile_cache,
    )
    args = parse_args(argv)
    enable_compile_cache(args.compile_cache)
    if args.rl:
        return rl_parity(args, device)
    return vision_parity(args, device)
