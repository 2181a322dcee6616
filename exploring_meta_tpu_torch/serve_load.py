"""Serving load tests (port of ``scripts/serve_vision.py`` and
``scripts/serve_rl.py``): the runnable counterparts of the serving
section in ``BASELINE.md``, with their flags and defaults.

``serve_vision`` loads a meta-trained CNN4 (``model.npz`` of either
package, or a fresh init with ``--random_init``), serves synthetic
request batches through :class:`~exploring_meta_tpu_torch.serve.VisionServer`
(bf16 by default, ``--f32``) and prints requests/s and batch latency.

``serve_rl`` loads a meta-trained policy (or a fresh init), collects a
support trajectory per task on Particles2D, adapts the policy to every
task in one batched call of
:class:`~exploring_meta_tpu_torch.serve.PolicyServer` (``--mesh N``
splits the tasks over N cards), and prints adaptation throughput and the
per-step action latency.

Both run on the card unless ``EMT_FORCE_CPU=1`` asks for the CPU. A timed
loop starts and ends with a device synchronize. Before the result lines
each prints the kernel launches of its first served batch (all zero on the
CPU, where the kernels' plain twins run and count nothing). The servers
serve each bucket as a CUDA graph, captured at its first call: on the card
each timed loop's result line follows one with the graph captures and
replays since that first call (the CPU runs eagerly and prints none). The
synthetic inputs come from ``torch.Generator``s seeded as the JAX scripts
seed their keys: 0 for the init, 1 for the requests (and 2 for the
Particles2D goals).

    python -m exploring_meta_tpu_torch.cli serve_vision --random_init
    python -m exploring_meta_tpu_torch.cli serve_rl --random_init --algo trpo
"""

from __future__ import annotations

import argparse
import time

import torch

from exploring_meta_tpu_torch.cuda import cnn4_cuda, gae_cuda
from exploring_meta_tpu_torch.device import resolve_device
from exploring_meta_tpu_torch.utils import graphs
from exploring_meta_tpu_torch.utils.config import requested_device


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _one_batch_launches(counters, fn, device) -> tuple:
    """``fn()`` once with ``counters``' launch counts zeroed just before
    -> (its result, the launches it made, read after a synchronize)."""
    _sync(device)
    counters.reset_launch_counts()
    out = fn()
    _sync(device)
    return out, counters.launch_counts()


def _print_launches(launches: dict) -> None:
    print("kernel launches in one batch: " + ", ".join(
        f"{k} {n}" for k, n in launches.items()), flush=True)


def _graph_counts(device) -> dict:
    """The graph captures and replays since the last
    ``graphs.reset_counts()``, printed on the card."""
    counts = dict(graphs.COUNTS)
    if device.type == "cuda":
        print(f"graphs since the first call: {counts['captures']} "
              f"captures, {counts['replays']} replays", flush=True)
    return counts


def _timed(fn, reps: int, device) -> float:
    """Seconds a call of ``fn`` over ``reps`` calls, between two
    synchronizes."""
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    _sync(device)
    return (time.perf_counter() - t0) / reps


def _compile_cache_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument("--compile_cache", type=str, default="",
                   help="kernel build directory ('' = $EMT_COMPILE_CACHE "
                        "or build/, 'off' = build/)")


def serve_vision(argv=None) -> dict:
    """Few-shot serving load test -> ``{"requests_per_s", "batch_s",
    "launches"}``."""
    p = argparse.ArgumentParser(description="Few-shot serving load test")
    p.add_argument("checkpoint", nargs="?", default=None,
                   help="model.npz / checkpoint (omit with --random_init)")
    p.add_argument("--random_init", action="store_true",
                   help="serve a fresh init (throughput demo without a run)")
    p.add_argument("--dataset", choices=["omni", "min"], default="omni")
    p.add_argument("--ways", type=int, default=5)
    p.add_argument("--shots", type=int, default=5)
    p.add_argument("--queries", type=int, default=15,
                   help="query examples per request")
    p.add_argument("--anil", action="store_true")
    p.add_argument("--inner_lr", type=float, default=0.5)
    p.add_argument("--adapt_steps", type=int, default=1)
    p.add_argument("--batch", type=int, default=64,
                   help="concurrent requests per call")
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--f32", action="store_true",
                   help="serve in f32 (default bf16 compute)")
    _compile_cache_flag(p)
    args = p.parse_args(argv)
    if args.checkpoint is None and not args.random_init:
        p.error("give a checkpoint or pass --random_init")

    from exploring_meta_tpu_torch.models import cnn4
    from exploring_meta_tpu_torch.serve import VisionServer
    from exploring_meta_tpu_torch.utils.compile_cache import (
        enable_compile_cache,
    )
    enable_compile_cache(args.compile_cache)
    dev = resolve_device(requested_device())

    if args.dataset == "omni":
        spec = (cnn4.anil_omniglot_spec(args.ways) if args.anil
                else cnn4.omniglot_spec(args.ways))
        hw, ch = 28, 1
    else:
        spec = (cnn4.anil_mini_imagenet_spec(args.ways) if args.anil
                else cnn4.mini_imagenet_spec(args.ways))
        hw, ch = 84, 3

    kw = dict(inner_lr=args.inner_lr, adapt_steps=args.adapt_steps,
              anil=args.anil,
              compute_dtype=None if args.f32 else torch.bfloat16,
              device=dev)
    if args.random_init:
        params = cnn4.init_cnn4(torch.Generator(device=dev).manual_seed(0),
                                spec, device=dev)
        server = VisionServer(spec, params, **kw)
    else:
        server = VisionServer.from_checkpoint(args.checkpoint, spec, **kw)

    B, S = args.batch, args.shots * args.ways
    gen = torch.Generator(device=dev).manual_seed(1)
    sx = torch.randn((B, S, hw, hw, ch), generator=gen, device=dev)
    sy = torch.arange(args.ways, device=dev).repeat(B, args.shots)
    qx = torch.randn((B, args.queries, hw, hw, ch), generator=gen,
                     device=dev)

    graphs.reset_counts()
    _, launches = _one_batch_launches(cnn4_cuda,
                                      lambda: server.batch(sx, sy, qx), dev)
    _print_launches(launches)
    dt = _timed(lambda: server.batch(sx, sy, qx), args.reps, dev)
    counts = _graph_counts(dev)
    print(f"batch={B} {args.dataset} {args.ways}w{args.shots}s "
          f"{'anil' if args.anil else 'maml'} "
          f"{'f32' if args.f32 else 'bf16'}: "
          f"{B / dt:.0f} requests/sec, "
          f"batch latency {dt * 1e3:.1f} ms "
          f"({dt * 1e3 / B:.3f} ms/request)", flush=True)
    return {"requests_per_s": B / dt, "batch_s": dt, "launches": launches,
            "graphs": counts, "device": str(dev)}


def serve_rl(argv=None) -> dict:
    """Meta-RL serving load test -> ``{"tasks_per_s", "adapt_s",
    "act_s", "launches"}``."""
    p = argparse.ArgumentParser(description="Meta-RL serving load test")
    p.add_argument("checkpoint", nargs="?", default=None,
                   help="model.npz / checkpoint (omit with --random_init)")
    p.add_argument("--random_init", action="store_true",
                   help="serve a fresh init (throughput demo without a run)")
    p.add_argument("--algo", choices=["vpg", "ppo", "trpo"], default="vpg",
                   help="inner-update rule used for adaptation")
    p.add_argument("--activation", choices=["relu", "tanh"], default="relu",
                   help="DiagNormalPolicy hidden activation (must match the "
                        "checkpoint's training config)")
    p.add_argument("--anil", action="store_true",
                   help="ANIL policy (body frozen during adaptation)")
    p.add_argument("--fc_neurons", type=int, default=100,
                   help="ANIL policy head width")
    p.add_argument("--inner_lr", type=float, default=0.05)
    p.add_argument("--adapt_steps", type=int, default=1)
    p.add_argument("--episodes", type=int, default=20,
                   help="support episodes per task")
    p.add_argument("--horizon", type=int, default=100)
    p.add_argument("--tasks", type=int, default=32,
                   help="concurrent adaptation requests per call")
    p.add_argument("--act_steps", type=int, default=200,
                   help="deployment steps to time after adaptation")
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--mesh", type=int, default=0,
                   help="split the request axis over N cards "
                        "(0 = one device)")
    _compile_cache_flag(p)
    args = p.parse_args(argv)
    if args.checkpoint is None and not args.random_init:
        p.error("give a checkpoint or pass --random_init")

    from exploring_meta_tpu_torch.envs.particles2d import Particles2D
    from exploring_meta_tpu_torch.models.policies import (
        DiagNormalPolicy, DiagNormalPolicyANIL,
    )
    from exploring_meta_tpu_torch.rl.adapt_rl import RLConfig
    from exploring_meta_tpu_torch.rl.rollout import make_rollout
    from exploring_meta_tpu_torch.serve import PolicyServer
    from exploring_meta_tpu_torch.utils.compile_cache import (
        enable_compile_cache,
    )
    from exploring_meta_tpu_torch.utils.tree import tree_map
    enable_compile_cache(args.compile_cache)

    env = Particles2D()
    if args.anil:
        policy = DiagNormalPolicyANIL(
            input_size=env.obs_size, output_size=env.action_size,
            fc_neurons=args.fc_neurons, hiddens=(100, args.fc_neurons))
    else:
        policy = DiagNormalPolicy(
            input_size=env.obs_size, output_size=env.action_size,
            activation=args.activation)
    cfg = RLConfig(inner_lr=args.inner_lr, adapt_steps=args.adapt_steps,
                   adapt_batch_size=args.episodes,
                   max_path_length=args.horizon)
    mesh = None
    if args.mesh:
        from exploring_meta_tpu_torch.parallel.mesh import make_task_mesh
        mesh = make_task_mesh(args.mesh, axis="requests")
        dev = mesh.devices[0]
    else:
        dev = resolve_device(requested_device())
    if args.random_init:
        params = policy.init(torch.Generator(device=dev).manual_seed(0))
        server = PolicyServer(policy, params, cfg, algo=args.algo,
                              mesh=mesh, device=dev)
    else:
        server = PolicyServer.from_checkpoint(
            args.checkpoint, policy, cfg, algo=args.algo, mesh=mesh,
            device=dev)

    # Support collection: one rollout of every task (the serving input: in
    # production these arrive from the deployed system's own env steps).
    roll = make_rollout(env, policy.sample, episodes=args.episodes,
                        horizon=args.horizon)
    tasks = env.sample_tasks(torch.Generator(device=dev).manual_seed(2),
                             args.tasks)
    stack = roll(server.params, tasks,
                 torch.Generator(device=dev).manual_seed(1))

    # Batched adaptation throughput: all tasks in one call.
    graphs.reset_counts()
    adapted, launches = _one_batch_launches(
        gae_cuda, lambda: server.adapt_batched(stack), dev)
    _print_launches(launches)
    dt = _timed(lambda: server.adapt_batched(stack), args.reps, dev)
    counts = {"adapt": _graph_counts(dev)}
    print(f"adapt[{args.algo}{'/anil' if args.anil else ''}] "
          f"{args.tasks} tasks x {args.adapt_steps} step(s): "
          f"{args.tasks / dt:.0f} tasks/sec ({dt * 1e3:.1f} ms/batch)",
          flush=True)

    # Deployment action latency on the first task's adapted params.
    one = tree_map(lambda x: x[0], adapted)
    obs = torch.zeros((args.episodes, env.obs_size), device=dev)
    graphs.reset_counts()
    server.act(one, obs)
    act_dt = _timed(lambda: server.act(one, obs), args.act_steps, dev)
    counts["act"] = _graph_counts(dev)
    print(f"act: {act_dt * 1e6:.0f} us/step for {args.episodes} parallel "
          f"envs ({1.0 / act_dt:.0f} steps/sec)", flush=True)
    return {"tasks_per_s": args.tasks / dt, "adapt_s": dt, "act_s": act_dt,
            "launches": launches, "graphs": counts, "device": str(dev)}
