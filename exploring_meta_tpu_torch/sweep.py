"""Seed sweeps: one configuration trained over several seeds, aggregated
and plotted (port of ``scripts/sweep.py``).

    python -m exploring_meta_tpu_torch.cli sweep maml_vision --seeds 42,7,123 \\
        [any maml_vision flags: --synthetic --num_iterations 100 ...]
    python -m exploring_meta_tpu_torch.cli sweep maml_trpo --seeds 42,7 \\
        --vmap_seeds --fuse 10 [any RL trainer flags]

Serially (the default) the seeds run one after another in one process,
each as a fresh trainer (``trainers/vision.py``, ``trainers/rl.py``)
whose run dir is the usual one; each seed's trainer, and with it its CUDA
graph, is dropped before the next seed starts. With ``--vmap_seeds`` all
seeds train as one program on one card (``parallel/multiseed.py``): the
seed axis folds into the task axis, so every kernel launches once an
iteration for all seeds, and under ``--fuse N`` one captured iteration is
replayed for all of them. The iterations run in chunks of ``--fuse``
(``--fuse 1``: the whole budget as one chunk), each seed is meta-tested
after training from its own generator, and each seed gets a run dir with
``metrics.json``, ``logger.json`` (``"vmapped_sweep": true``) and
``model.npz`` in JAX's flat layout, which the evaluation tools and the
servers read as any run dir.

Either way the command writes ``<sweep_dir>/<algo>_<seeds>.json`` (each
seed's final metric, their mean and standard deviation, the config), then
the Student-t band of ``--metric`` over the seeds
(``utils/plotter.py:plot_runs_with_confidence``): its last mean goes into
the summary as ``band_final_mean``, and the figure is written beside it
where matplotlib is installed.

Deviations from JAX: each seed's random stream is its solo run's (JAX
splits each seed's key once a chunk and folds ``0x7e57`` for the
meta-test; the port's generators only move forward), so seed ``i`` of a
one-program sweep trains as a solo run of seed ``i`` on the shared
dataset; the seeds share one dataset, sampled with the base ``--seed``, as
in JAX.

``--vmap_seeds --mesh N`` splits the seeds into N contiguous groups
(``parallel/multiseed.py:seed_groups``), one a rank
(``parallel/launch.py``: a card each, or CPU processes under
``EMT_FORCE_CPU=1``); each rank trains its group as one program, with no
collectives, and the launching process gathers the groups' rows and
writes the run dirs and the summary. A serial sweep with ``--mesh N``
runs each seed's trainer over N ranks.
"""

from __future__ import annotations

import datetime
import gc
import json
import os
import sys
from dataclasses import replace

import numpy as np

from exploring_meta_tpu_torch.utils.config import (
    CONV_IMPLS, RLScriptConfig, VisionConfig, anil_vision_defaults,
    requested_device, rl_argparser, vision_argparser,
)
from exploring_meta_tpu_torch.utils.tree import tree_map


def _algos() -> dict:
    """algo -> (config class, parser builder, trainer factory ``(cfg,
    device) -> trainer``, final-metric key, default band metric, default
    config): the table of ``scripts/sweep.py:44-69``."""
    from exploring_meta_tpu_torch.trainers.rl import RLTrainer
    from exploring_meta_tpu_torch.trainers.vision import VisionTrainer

    def vision(anil):
        # per-algo script defaults: an anil sweep launches what N runs of
        # anil_vision would
        return (VisionConfig,
                lambda d: vision_argparser(d, "sweep"),
                lambda cfg, device: VisionTrainer(cfg, anil=anil,
                                                  device=device),
                "test_acc", "valid_acc",
                anil_vision_defaults if anil else VisionConfig)

    def rl(algo, anil):
        return (RLScriptConfig,
                lambda d: rl_argparser(d, "sweep"),
                lambda cfg, device: RLTrainer(cfg, algo=algo, anil=anil,
                                              device=device),
                "eval_reward", "adapt_reward", RLScriptConfig)

    table = {"maml_vision": vision(False), "anil_vision": vision(True)}
    for a in ("trpo", "ppo", "vpg"):
        table[f"maml_{a}"] = rl(a, False)
        table[f"anil_{a}"] = rl(a, True)
    return table


def _seed_run_dirs(sweep_dir, algo, seeds, metrics_per_seed, params_stack,
                   finals, final_key, trainer_algo, dataset, base_cfg):
    """One run dir a seed: ``metrics.json`` (each metric's per-iteration
    values and ``final_key``), ``logger.json`` (the trainer's config with
    the algo and dataset it would stamp, ``"vmapped_sweep": true``) and
    ``model.npz`` (the seed's final params, flat) -> the runs list of the
    summary. A fresh parent a call, as ``scripts/sweep.py:72-108``."""
    from exploring_meta_tpu_torch.parallel.multiseed import seed_params
    from exploring_meta_tpu_torch.utils.experiment import flatten_params

    stamp = datetime.datetime.now().strftime("%d_%m_%Hh%M%S")
    runs = []
    for i, seed in enumerate(seeds):
        d = os.path.join(sweep_dir, f"vmap_{algo}_{stamp}", f"seed{seed}")
        os.makedirs(d, exist_ok=True)
        ms = {k: [float(v) for v in np.asarray(vals[i])]
              for k, vals in metrics_per_seed.items()}
        ms[final_key] = [finals[i]]
        with open(os.path.join(d, "metrics.json"), "w") as f:
            json.dump(ms, f)
        config = {**base_cfg.to_params(), "algo": trainer_algo,
                  "dataset": dataset, "seed": seed}
        with open(os.path.join(d, "logger.json"), "w") as f:
            json.dump({"config": config, "vmapped_sweep": True,
                       final_key: finals[i]}, f, indent=4, default=str)
        np.savez(os.path.join(d, "model.npz"),
                 **flatten_params(seed_params(params_stack, i)))
        runs.append({"seed": seed, "run_dir": d, final_key: finals[i]})
    return runs


def _chunk_sizes(cfg) -> list:
    """``--fuse`` as iterations a chunk of the one-program sweep (``fuse
    <= 1``: the whole budget as one chunk), ``scripts/sweep.py:111-126``."""
    if cfg.num_iterations < 1:
        raise SystemExit("--vmap_seeds needs --num_iterations >= 1")
    chunk = cfg.fuse if cfg.fuse > 1 else cfg.num_iterations
    n_chunks, rem = divmod(cfg.num_iterations, chunk)
    return [chunk] * n_chunks + ([rem] if rem else [])


def _drive_chunks(train, sizes, state, gens):
    """Run the chunk schedule through one seeded train scan (built for
    ``max(sizes)`` iterations: one capture serves every chunk). ``train``
    is called as ``train(*state, gens, n)`` and returns ``(*state,
    metrics)`` with metrics ``[n, S]``; the generators move forward chunk
    after chunk. -> ``(state, {metric: [S, total] numpy})``."""
    from exploring_meta_tpu_torch.trainers.fused import fetch

    chunks = []
    for n in sizes:
        out = train(*state, gens, n)
        state, ms = tuple(out[:-1]), out[-1]
        chunks.append(fetch(ms))
    return state, {k: np.concatenate([c[k] for c in chunks]).T
                   for k in chunks[0]}


def _vmapped_vision(cfg: VisionConfig, anil: bool, seeds, device):
    """All seeds of a vision sweep as one program -> (metrics ``[S,
    num_iterations]``, params ``[S, ...]``, per-seed test accuracies)."""
    from exploring_meta_tpu_torch.adapt.maml import (
        cast_compute, make_meta_eval, make_train_scan,
    )
    from exploring_meta_tpu_torch.adapt.vision import make_vision_fast_adapt
    from exploring_meta_tpu_torch.models.cnn4 import init_cnn4
    from exploring_meta_tpu_torch.models.layers import set_conv_impl
    from exploring_meta_tpu_torch.parallel.multiseed import (
        seed_draws, stack_seed_states,
    )
    from exploring_meta_tpu_torch.tasks.datasets import get_dataset
    from exploring_meta_tpu_torch.tasks.sampler import sample_task_batch
    from exploring_meta_tpu_torch.trainers.vision import _build_spec

    S = len(seeds)
    train_ds, valid_ds, test_ds = get_dataset(
        cfg.dataset, seed=cfg.seed, synthetic=cfg.synthetic or None,
        synth_classes=cfg.synth_classes,
        synth_per_class=cfg.synth_per_class, device=device)
    set_conv_impl(CONV_IMPLS.get(cfg.conv_impl, cfg.conv_impl))
    spec = _build_spec(cfg, anil)
    fast_adapt = make_vision_fast_adapt(
        spec, inner_lr=cfg.inner_lr, adapt_steps=cfg.adapt_steps,
        shots=cfg.shots, ways=cfg.ways, anil=anil,
        remat_body=cfg.remat_body, seeds=S)
    if cfg.bf16:
        fast_adapt = cast_compute(fast_adapt)

    def sampler(ds):
        return lambda g: sample_task_batch(g, ds, cfg.ways, cfg.shots,
                                           cfg.meta_batch_size)

    params, opt, gens = stack_seed_states(
        lambda g: init_cnn4(g, spec, device=device), seeds, device,
        outer_lr=cfg.outer_lr)
    sizes = _chunk_sizes(cfg)
    train = make_train_scan(fast_adapt, sampler(train_ds), max(sizes),
                            eval_sample_fn=sampler(valid_ds), seeds=S)
    (params, opt), ms = _drive_chunks(train, sizes, (params, opt), gens)

    # each seed's meta-test from its own generator, after its training
    # draws, as its solo run's (trainers/vision.py)
    test = make_meta_eval(fast_adapt, seeds=S)(
        params, *seed_draws(sampler(test_ds), gens, S))
    finals = [float(v) for v in test["metric"].cpu()]
    metrics = {"train_loss": ms["loss"], "train_acc": ms["metric"],
               "valid_loss": ms["valid_loss"],
               "valid_acc": ms["valid_metric"]}
    return metrics, params, finals


def _vmapped_rl(cfg: RLScriptConfig, algo: str, anil: bool, seeds, device):
    """All seeds of a device-env RL sweep as one program -> (metrics ``[S,
    num_iterations]``, params ``[S, ...]``, per-seed eval rewards)."""
    from exploring_meta_tpu_torch.envs.particles2d import Particles2D
    from exploring_meta_tpu_torch.parallel.multiseed import (
        seed_params, stack_seed_states,
    )
    from exploring_meta_tpu_torch.rl.evaluate import meta_test
    from exploring_meta_tpu_torch.rl.rollout import make_rollout
    from exploring_meta_tpu_torch.rl.train_scan import (
        make_seeded_adam_train_scan, make_seeded_trpo_train_scan,
    )
    from exploring_meta_tpu_torch.trainers.rl import (
        build_policy, rl_config, trpo_config,
    )

    if not cfg.env.startswith("Particles2D"):
        raise SystemExit(f"--vmap_seeds: {cfg.env!r} is not a device env; "
                         "a host env's sweep runs serially (drop "
                         "--vmap_seeds)")
    S = len(seeds)
    env = Particles2D()
    policy = build_policy(env, anil, fc_neurons=cfg.fc_neurons,
                          activation=cfg.activation)
    if cfg.bf16:
        policy = policy._replace(compute_dtype="bf16")
    rl_cfg = rl_config(cfg, anil)
    roll = make_rollout(env, policy.sample, episodes=cfg.adapt_batch_size,
                        horizon=cfg.max_path_length)
    sizes = _chunk_sizes(cfg)
    if algo == "trpo":
        params, _, gens = stack_seed_states(policy.init, seeds, device)
        train = make_seeded_trpo_train_scan(
            env, policy, roll, rl_cfg, trpo_config(cfg),
            cfg.meta_batch_size, max(sizes), S)
        (params,), ms = _drive_chunks(train, sizes, (params,), gens)
    else:
        params, opt, gens = stack_seed_states(policy.init, seeds, device,
                                              outer_lr=cfg.outer_lr)
        train = make_seeded_adam_train_scan(
            env, policy, roll, rl_cfg, algo, cfg.meta_batch_size,
            max(sizes), S)
        (params, opt), ms = _drive_chunks(train, sizes, (params, opt), gens)

    finals = []
    for i, seed in enumerate(seeds):
        final = meta_test(algo, cfg.env, policy, seed_params(params, i),
                          rl_cfg, n_tasks=cfg.n_eval_tasks, gen=gens[i],
                          seed=seed)
        finals.append(float(final["mean_reward"]))
    return ms, params, finals


def _vmapped(algo: str, base_cfg, seeds, device) -> tuple:
    """One program for ``seeds`` -> (metrics ``[S, num_iterations]``,
    params ``[S, ...]``, finals)."""
    if algo in ("maml_vision", "anil_vision"):
        return _vmapped_vision(base_cfg, algo.startswith("anil"), seeds,
                               device)
    return _vmapped_rl(base_cfg, algo.split("_")[1], algo.startswith("anil"),
                       seeds, device)


def _vmapped_group(algo: str, base_cfg, groups: list) -> tuple:
    """A launched rank's program: its group of seeds, its params moved to
    the host for the launching process."""
    from exploring_meta_tpu_torch.parallel.launch import current_rank
    rank = current_rank()
    metrics, params, finals = _vmapped(algo, base_cfg, groups[rank.rank],
                                       rank.device)
    return metrics, tree_map(lambda t: t.detach().cpu(), params), finals


def run_vmapped(algo: str, base_cfg, seeds, sweep_dir: str, final_key: str,
                device=None) -> list:
    """The one-program sweep (one program a rank under ``--mesh N``) ->
    the runs list of the summary."""
    import torch

    from exploring_meta_tpu_torch.device import resolve_device
    from exploring_meta_tpu_torch.parallel.launch import launch
    from exploring_meta_tpu_torch.parallel.multiseed import seed_groups
    from exploring_meta_tpu_torch.utils.compile_cache import (
        enable_compile_cache,
    )

    for flag in ("resume", "profile", "trace"):
        if getattr(base_cfg, flag, None):
            raise SystemExit(
                f"--vmap_seeds cannot honor --{flag}: the whole sweep is "
                f"one program with no per-seed trainer loop; run the "
                f"serial sweep (drop --vmap_seeds) instead")
    mesh = getattr(base_cfg, "mesh", 1)
    groups = seed_groups(seeds, mesh) if mesh > 1 else None
    device = resolve_device(device)
    # where the kernels build, as a trainer's Experiment sets it
    enable_compile_cache(base_cfg.compile_cache)
    prefix = "anil" if algo.startswith("anil") else "maml"
    if groups is None:
        metrics, params, finals = _vmapped(algo, base_cfg, seeds, device)
    else:
        parts = [o["result"] for o in launch(
            _vmapped_group, mesh, args=(algo, base_cfg, groups),
            device=device)]
        metrics = {k: np.concatenate([p[0][k] for p in parts])
                   for k in parts[0][0]}
        params = tree_map(lambda *xs: torch.cat(xs), *(p[1] for p in parts))
        finals = [f for p in parts for f in p[2]]
    if algo in ("maml_vision", "anil_vision"):
        trainer_algo = f"{prefix}_{base_cfg.ways}w{base_cfg.shots}s"
        dataset = base_cfg.dataset
    else:
        trainer_algo, dataset = algo, base_cfg.env
    for seed, final in zip(seeds, finals):
        print(f"seed {seed}: {final_key} = {final:.4f}")
    return _seed_run_dirs(sweep_dir, algo, seeds, metrics, params, finals,
                          final_key, trainer_algo, dataset, base_cfg)


def _run_serial(make_trainer, base_cfg, seeds, final_key: str,
                device=None) -> list:
    """One fresh trainer a seed, one after another in this process."""
    runs = []
    for seed in seeds:
        print(f"=== sweep seed {seed} ===")
        trainer = make_trainer(replace(base_cfg, seed=seed), device)
        result = trainer.run()
        final = (float(result) if not isinstance(result, dict)
                 else float(result.get("mean_reward",
                                       next(iter(result.values())))))
        runs.append({"seed": seed, "run_dir": trainer.model_path,
                     final_key: final})
        print(f"seed {seed}: {final_key} = {final:.4f}")
        # the next seed starts without this one's graph and tensors
        del trainer, result
        gc.collect()
    return runs


def main(argv=None) -> dict:
    """``sweep <algo> --seeds 42,7,... [--vmap_seeds] [trainer flags]`` ->
    the summary dict (also written to ``<sweep_dir>/<algo>_<seeds>.json``)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    table = _algos()
    if not argv or argv[0].startswith("-"):
        raise SystemExit(
            "usage: sweep <algo> --seeds 42,7,... [trainer flags]\n"
            f"algos: {', '.join(sorted(table))}")
    algo, argv = argv[0], argv[1:]
    if algo not in table:
        raise SystemExit(f"unknown algo {algo!r}; one of {sorted(table)}")
    (cfg_cls, build_parser, make_trainer, final_key, curve_default,
     default_cfg) = table[algo]

    p = build_parser(default_cfg())
    p.add_argument("--seeds", type=str, default="42,7,123",
                   help="comma-separated seeds to sweep")
    p.add_argument("--metric", type=str, default=curve_default,
                   help="per-iteration metric for the confidence band")
    p.add_argument("--sweep_dir", type=str, default="sweeps",
                   help="where the summary and the plot land")
    p.add_argument("--vmap_seeds", action="store_true",
                   help="train all seeds as one program on one card "
                        "(vision and device-env RL; with --mesh N, one "
                        "program for each of N groups of seeds)")
    args = p.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",") if s.strip()]
    if not seeds:
        raise SystemExit(f"--seeds {args.seeds!r}: no seeds given")
    base_cfg = cfg_cls(**{k: v for k, v in vars(args).items()
                          if k not in ("seeds", "metric", "sweep_dir",
                                       "vmap_seeds")})
    device = requested_device()

    if args.vmap_seeds:
        runs = run_vmapped(algo, base_cfg, seeds, args.sweep_dir, final_key,
                           device=device)
    else:
        runs = _run_serial(make_trainer, base_cfg, seeds, final_key,
                           device=device)

    os.makedirs(args.sweep_dir, exist_ok=True)
    tag = f"{algo}_{'-'.join(str(s) for s in seeds)}"
    finals = [r[final_key] for r in runs]
    n = len(finals)
    mean = sum(finals) / n
    std = (sum((f - mean) ** 2 for f in finals) / max(n - 1, 1)) ** 0.5
    summary = {"algo": algo, "metric": final_key, "seeds": seeds,
               "runs": runs, "mean": mean, "std": std,
               "vmapped": bool(args.vmap_seeds),
               "config": base_cfg.to_params()}

    # the aggregate first: the runs must survive any plotting failure
    out = os.path.join(args.sweep_dir, f"{tag}.json")
    with open(out, "w") as f:
        json.dump(summary, f, indent=2)

    from exploring_meta_tpu_torch.utils import plotter
    try:
        band = plotter.plot_runs_with_confidence(
            [r["run_dir"] for r in runs], metric=args.metric,
            save_path=os.path.join(args.sweep_dir, f"{tag}.png"))
        summary["band_metric"] = args.metric
        summary["band_final_mean"] = (band["mean"][-1] if band["mean"]
                                      else None)
        with open(out, "w") as f:
            json.dump(summary, f, indent=2)
    except Exception as e:  # the plot is best-effort; the json landed
        print(f"(no band plot for metric {args.metric!r}: {e})")
    print(f"{algo}: {final_key} mean {mean:.4f} +- {std:.4f} over "
          f"{n} seeds -> {out}")
    return summary
