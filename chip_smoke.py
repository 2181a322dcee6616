#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card (H100, sm_90a).

    python3 chip_smoke.py            # from the repository root

Phases, each of which fails the run (non-zero exit) on any error:

1. print the card's name and power limit (``nvidia-smi``);
2. build every CUDA source under ``exploring_meta_tpu_torch/csrc`` with
   ``nvcc``, one process per source, all started together, and print what
   ``ptxas`` reports;
3. serving (slice 1): at each of the four CNN4-Omniglot block shapes (B =
   64 requests, 25 support images each), in float32 and bfloat16, launch
   every fused-block kernel, hold it against its plain PyTorch twin, and
   time kernel, twin and a PyTorch library yardstick with CUDA events;
   then load full-width ``omniglot_spec(ways=5)`` params from ``.npz`` and
   serve 64 synthetic-Omniglot requests through ``VisionServer.batch``
   with the launch counters zeroed just before and read just after, check
   that every kernel ran, that the batch agrees with per-request
   ``__call__`` and with the CPU path, and that the support set is
   labelled above chance; time and profile it;
4. the GAE / discount sweeps (slice 2): at ``[20, 100, 20]``,
   ``[100, 400]`` and ``[100]``, with dones mid-column, all zero and all
   one, hold each kernel against its twin and a float64 CPU reference,
   forward and backward, and time kernel and twin;
5. MAML-TRPO meta-training (slice 2): 3 full-width iterations of
   ``RLTrainer`` on Particles2D in a temporary run dir, with the launch
   counters zeroed just before; check that both sweeps ran in every
   iteration, that the metrics are finite, that the run-dir artifacts
   exist and load, and that the final meta-test is finite; then one
   outer step on identical replays on the card and on the CPU path, which
   must agree; then profile one iteration;
6. print one ``{"kernels": [...]}`` line, the card line again, and last
   ``{"ok": true, "device": {...}}``.

Details go to ``chiprun_out/chip_smoke.json``. The script imports neither
JAX nor the JAX package. Without a card it exits 1 and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

SEED = 0
WAYS, SHOTS, QUERIES, BATCH = 5, 5, 15, 64
INNER_LR, ADAPT_STEPS = 0.5, 1
# (H, Ci) of the four CNN4-Omniglot blocks at hidden 64
BLOCKS = [(28, 1), (14, 64), (7, 64), (4, 64)]
HIDDEN = 64
# H100 SXM data-sheet peaks: HBM bytes/s and f32 FLOP/s outside the
# tensor cores (the kernels do f32 FMAs on the CUDA cores).
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
# Tolerance per dtype: |kernel - twin| <= atol * max|twin| + rtol * |twin|.
# f32: the two differ only in summation order. bf16: both compute in f32
# from the same bf16 inputs, but outputs are rounded to bf16 (8 bits of
# mantissa), so a last-bit f32 difference can move an output by one bf16
# ulp, 2^-7 relative.
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (2e-2, 2e-2)}
# The conv-bias gradient db = sum(dy) is zero in exact arithmetic (BN
# removes dy's mean); both sides hold rounding noise, bounded relative to
# sum(|dy|) per (request, channel).
DB_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# GAE / discount sweeps: the main path's [B, T, E], the [T, lanes] form and
# a single column; the trainer's gamma and tau.
SWEEP_SHAPES = [(20, 100, 20), (100, 400), (100,)]
GAMMA, TAU = 0.99, 1.0
# A sweep output sums up to T = 100 float32 terms, each rounded once
# (2^-24 relative): |kernel - reference| <= 1e-5 * max|reference|.
SWEEP_TOL = 1e-5
# the sweep kernels' names in csrc/gae.cu, as the profiler reports them
KERNEL_NAMES = {"gae_sweep": "sweep_kernel<true>",
                "discount_sweep": "sweep_kernel<false>"}
TRPO_ITERATIONS = 3


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip()


def time_ms(fn, warm: int = 3, iters: int = 20) -> float:
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def conv_macs(b: int, n: int, h: int, ci: int, co: int) -> int:
    """Multiply-adds of the stride-2 3x3 conv over in-range taps only."""
    ho = (h - 1) // 2 + 1
    rows = sum(1 for i in range(ho) for d in range(3) if 0 <= 2 * i + d - 1 < h)
    return b * n * rows * rows * ci * co


def bound(kernel: str, b: int, n: int, h: int, ci: int, co: int,
          item: int) -> tuple[float, float]:
    """(ms if bytes bound, ms if operations bound) for one launch: every
    input read once, every output written once; conv at 2 FLOP per
    multiply-add plus the per-element BN work."""
    ho = (h - 1) // 2 + 1
    xin, w, out, pc = b * n * h * h * ci, b * 9 * ci * co, b * n * ho * ho * co, b * co
    macs = conv_macs(b, n, h, ci, co)
    if kernel == "cnn4_block_fwd":
        nbytes = item * (xin + w + 3 * pc + out)
        flops = 2 * macs + 10 * out
    elif kernel == "cnn4_block_bwd_params":
        # reads x, w, b, scale, bias, g; writes dy (f32), dw, db, dscale, dbias
        nbytes = item * (xin + w + 3 * pc + out) + 4 * out + item * (w + 3 * pc)
        flops = 4 * macs + 20 * out
    else:
        # reads dy (f32) and w; writes dx
        nbytes = 4 * out + item * (w + xin)
        flops = 2 * macs
    return 1e3 * nbytes / PEAK_BYTES, 1e3 * flops / PEAK_F32


def kernel_phase(tc, F, torch) -> dict:
    """Phase 3: every kernel vs its twin at every block shape and dtype."""
    res = {name: {"max_abs_err": {}, "ms": 0.0, "plain_ms": 0.0,
                  "library_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0,
                  "bound_ms": 0.0, "shapes": []}
           for name in tc.KERNELS}
    res["cnn4_block_bwd_params"]["library_ms"] = None
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    dev = torch.device("cuda")
    B, N, co = BATCH, WAYS * SHOTS, HIDDEN

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    for dname, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        rtol, atol = TOL[dname]
        for blk, (h, ci) in enumerate(BLOCKS):
            ho = (h - 1) // 2 + 1
            x = rnd(B, N, h, h, ci).to(dt)
            w = rnd(B, 3, 3, ci, co, scale=(2.0 / (9 * ci)) ** 0.5).to(dt)
            b = rnd(B, co, scale=0.1).to(dt)
            sc = (torch.rand(B, co, generator=gen, device=dev) * 0.9 + 0.1).to(dt)
            be = rnd(B, co, scale=0.1).to(dt)
            # zero the cotangent where the ReLU input lies within 1e-3 of
            # its kink: there the kernel's and the twin's f32 rounding may
            # disagree on the mask, which is a tie, not an error
            xh, _, s_, be_ = tc.bn_stats_plain(x, w, b, sc, be)
            g = (rnd(B, N, ho, ho, co) * ((xh * s_ + be_).abs() > 1e-3)).to(dt)

            def err(got, want, db=None):
                got, want = got.float(), want.float()
                d = (got - want).abs()
                if db is not None:
                    lim = DB_TOL[dname] * db
                else:
                    lim = atol * want.abs().max() + rtol * want.abs()
                check(bool(torch.isfinite(got).all()), "finite kernel output")
                check(bool((d <= lim).all()),
                      f"{dname} block {blk + 1}: max |err| {float(d.max())}")
                return float(d.max())

            a_k = tc.block_fwd(x, w, b, sc, be)
            e_fwd = err(a_k, tc.block_fwd_plain(x, w, b, sc, be))
            got = tc.block_bwd_params(x, w, b, sc, be, g)
            want = tc.block_bwd_params_plain(x, w, b, sc, be, g)
            dy_abs = want[0].abs().sum(dim=(1, 2, 3))
            e_bwp = max(err(got[0], want[0]), err(got[1], want[1]),
                        err(got[2], want[2], db=dy_abs + 1e-30),
                        err(got[3], want[3]), err(got[4], want[4]))
            dy = got[0]
            e_bwi = err(tc.block_bwd_input(dy, w, h, h),
                        tc.block_bwd_input_plain(dy, w, h, h))
            torch.cuda.synchronize()
            for name, e in (("cnn4_block_fwd", e_fwd),
                            ("cnn4_block_bwd_params", e_bwp),
                            ("cnn4_block_bwd_input", e_bwi)):
                prev = res[name]["max_abs_err"].get(dname, 0.0)
                res[name]["max_abs_err"][dname] = max(prev, e)

            # Timing at float32, the served dtype: kernel, twin, yardstick.
            if dt != torch.float32:
                continue
            xg = x.permute(1, 0, 4, 2, 3).reshape(N, B * ci, h, h).contiguous()
            wg = w.permute(0, 4, 3, 1, 2).reshape(B * co, ci, 3, 3).contiguous()
            dyg = dy.permute(1, 0, 4, 2, 3).reshape(N, B * co, ho, ho).contiguous()
            bf, sf, bef = b.reshape(-1), sc.reshape(-1), be.reshape(-1)
            runs = {
                "cnn4_block_fwd": (
                    lambda: tc.block_fwd(x, w, b, sc, be),
                    lambda: tc.block_fwd_plain(x, w, b, sc, be),
                    lambda: torch.relu(F.batch_norm(
                        F.conv2d(xg, wg, bf, stride=2, padding=1, groups=B),
                        None, None, sf, bef, training=True, eps=tc.EPS))),
                "cnn4_block_bwd_params": (
                    lambda: tc.block_bwd_params(x, w, b, sc, be, g),
                    lambda: tc.block_bwd_params_plain(x, w, b, sc, be, g),
                    None),
                "cnn4_block_bwd_input": (
                    lambda: tc.block_bwd_input(dy, w, h, h),
                    lambda: tc.block_bwd_input_plain(dy, w, h, h),
                    lambda: torch.nn.grad.conv2d_input(
                        xg.shape, wg, dyg, stride=2, padding=1, groups=B)),
            }
            for name, (kern, plain, lib) in runs.items():
                on_path = not (name == "cnn4_block_bwd_input" and blk == 0)
                shape = {"block": blk + 1, "x": [B, N, h, h, ci],
                         "on_path": on_path, "ms": time_ms(kern),
                         "plain_ms": time_ms(plain),
                         "library_ms": time_ms(lib) if lib else None}
                bms, oms = bound(name, B, N, h, ci, co, 4)
                shape.update(bytes_ms=bms, ops_ms=oms, bound_ms=max(bms, oms))
                res[name]["shapes"].append(shape)
                if on_path:
                    r = res[name]
                    r["ms"] += shape["ms"]
                    r["plain_ms"] += shape["plain_ms"]
                    if lib:
                        r["library_ms"] += shape["library_ms"]
                    r["bytes_ms"] += bms
                    r["ops_ms"] += oms
                    r["bound_ms"] += max(bms, oms)
    return res


def make_requests(torch, td, ts, device):
    """64 requests from the synthetic Omniglot test split: support 5-way
    5-shot (25), queries 3 per class (15)."""
    _, _, test = td.load_omniglot(seed=SEED, synthetic=True, device=device)
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    data, labels = ts.sample_task_batch(gen, test, WAYS, SHOTS, BATCH)
    (sx, sy), (qx, qy) = ts.split_support_query(data, labels, SHOTS, WAYS)
    sel = (torch.arange(WAYS, device=device)[:, None] * SHOTS
           + torch.arange(QUERIES // WAYS, device=device)).reshape(-1)
    return sx, sy, qx[:, sel], qy[:, sel]


def agree(a, b, atol: float, what: str) -> None:
    """Probabilities within ``atol``; labels equal where the top-2 margin
    of the reference exceeds 1e-3."""
    (pa, qa), (pb, qb) = a, b
    check(float((qa.float().cpu() - qb.float().cpu()).abs().max()) <= atol,
          f"{what}: probabilities differ by more than {atol}")
    top2 = qb.float().cpu().topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > 1e-3
    check(bool((pa.cpu()[clear] == pb.cpu()[clear]).all()),
          f"{what}: predictions differ")


def device_profile(torch, fn, launches: bool = False) -> tuple:
    """Run ``fn`` once under ``torch.profiler`` -> (microseconds the card
    was busy with kernels, the top kernels as (name, us, count)[, the
    number of kernels launched]). Device kernels only: a CPU op that
    launched a kernel reports its time too, so summing every event would
    count it twice."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = sorted((e for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=lambda e: -e.self_device_time_total)
    out = (sum(e.self_device_time_total for e in events),
           [(e.key[:60], e.self_device_time_total, e.count)
            for e in events[:8]])
    return out + (sum(e.count for e in events),) if launches else out


def kernel_device_ms(torch, fn, name: str, calls: int = 50) -> float:
    """Device time of one launch of the kernel whose name holds ``name``:
    the profiler's (CUPTI) kernel time over ``calls`` calls of ``fn``. For
    a kernel of a few microseconds, CUDA events around back-to-back calls
    time the host's dispatch instead, so this is the kernel's own time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and name in e.key]
    count = sum(e.count for e in events)
    check(count == calls, f"profiler saw {count} launches of {name}")
    return sum(e.self_device_time_total for e in events) / count / 1e3


def build_all(build) -> tuple[float, dict]:
    """Build every csrc source at once, one nvcc each -> (seconds,
    {source: ptxas lines})."""
    from concurrent.futures import ThreadPoolExecutor
    sources = sorted(f for f in os.listdir(build.CSRC) if f.endswith(".cu"))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(build.build, sources))
    seconds = time.perf_counter() - t0
    ptxas = {}
    for src in sources:
        with open(build.library_path(src) + ".log") as f:
            ptxas[src] = [ln.strip() for ln in f
                          if "Used" in ln or "spill" in ln]
    return seconds, ptxas


def serve_phase(torch, np, tc, gpu) -> dict:
    """Phase 3's serving half: the main path of slice 1."""
    from exploring_meta_tpu_torch.models.cnn4 import init_cnn4, omniglot_spec
    from exploring_meta_tpu_torch.serve import VisionServer
    from exploring_meta_tpu_torch.tasks import datasets as td
    from exploring_meta_tpu_torch.tasks import sampler as ts
    from exploring_meta_tpu_torch.utils.experiment import flatten_params

    spec = omniglot_spec(ways=WAYS)
    params = init_cnn4(torch.Generator().manual_seed(SEED), spec, device="cpu")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "model.npz")
        np.savez(path, **flatten_params(params))
        kw = dict(inner_lr=INNER_LR, adapt_steps=ADAPT_STEPS)
        server = VisionServer.from_checkpoint(path, spec, device="cuda", **kw)
        cpu_server = VisionServer.from_checkpoint(path, spec, device="cpu",
                                                  **kw)
    sx, sy, qx, qy = make_requests(torch, td, ts, torch.device("cuda"))
    check(tuple(sx.shape) == (BATCH, WAYS * SHOTS, 28, 28, 1)
          and tuple(qx.shape) == (BATCH, QUERIES, 28, 28, 1),
          "request shapes")

    # the main path: one served batch, launch counters zeroed just before
    torch.cuda.synchronize()
    tc.reset_launch_counts()
    preds, probs = server.batch(sx, sy, qx)
    torch.cuda.synchronize()
    launches = tc.launch_counts()
    print(f"launches in one served batch: {launches}", flush=True)
    for name, n in launches.items():
        check(n > 0, f"{name} ran on the served path")
    check(tuple(probs.shape) == (BATCH, QUERIES, WAYS)
          and bool(torch.isfinite(probs).all()), "finite probs [B, Q, ways]")
    check(float((probs.sum(-1) - 1).abs().max()) < 1e-5, "probs sum to 1")

    for i in range(4):
        agree(server(sx[i], sy[i], qx[i]), (preds[i], probs[i]), 1e-4,
              f"__call__ vs batch, request {i}")
    ref = cpu_server.batch(sx[:2].cpu(), sy[:2].cpu(), qx[:2].cpu())
    agree((preds[:2], probs[:2]), ref, 1e-3, "card vs CPU plain path")

    spreds, _ = server.batch(sx, sy, sx)
    support_acc = float((spreds == sy).float().mean())
    query_acc = float((preds == qy).float().mean())
    print(f"support accuracy {support_acc} query accuracy {query_acc} "
          f"(chance {1 / WAYS})", flush=True)
    check(support_acc > 2.0 / WAYS, "support set labelled above chance")

    serve_s = {}
    for dname, dt in (("float32", None), ("bfloat16", torch.bfloat16)):
        srv = server if dt is None else VisionServer(
            spec, server.params, compute_dtype=dt, device="cuda", **kw)
        p, q = srv.batch(sx, sy, qx)
        check(bool(torch.isfinite(q).all()), f"{dname} serving is finite")
        torch.cuda.synchronize()
        reps, t0 = 5, time.perf_counter()
        for _ in range(reps):
            p, q = srv.batch(sx, sy, qx)
        torch.cuda.synchronize()
        serve_s[dname] = (time.perf_counter() - t0) / reps
        print(f"serve {dname}: {BATCH / serve_s[dname]} requests/s, "
              f"{1e3 * serve_s[dname]} ms per batch of {BATCH} [{gpu}]",
              flush=True)

    device_us, top = device_profile(torch, lambda: server.batch(sx, sy, qx))
    print(f"profile of one served batch: kernels busy {device_us} us of "
          f"{1e6 * serve_s['float32']} us wall [{gpu}]")
    for key, us, count in top:
        print(f"  {us:12.1f} us  x{count:4d}  {key}")

    return {"launches": launches, "serve_s": serve_s,
            "support_acc": support_acc, "query_acc": query_acc,
            "profile_top": top, "profile_device_us": device_us}


def sweep_inputs(torch, gen, shape, dones: str):
    r = torch.randn(shape, generator=gen, device="cuda")
    v = torch.randn(shape, generator=gen, device="cuda")
    if dones == "mid":
        d = (torch.rand(shape, generator=gen, device="cuda") < 0.1).float()
    else:
        d = torch.full(shape, float(dones == "ones"), device="cuda")
    return r, d, v


def sweep_phase(torch, gc, gpu) -> dict:
    """Phase 4: each sweep kernel vs its twin and a float64 CPU reference,
    forward and backward, at every shape and kind of dones; timed at each
    shape with dones mid-column."""
    plain = {"gae_sweep": gc.gae_plain, "discount_sweep": gc.discount_plain}
    res = {name: {"max_abs_err": 0.0, "max_abs_err_f64": 0.0,
                  "max_grad_err": 0.0, "shapes": []} for name in gc.KERNELS}
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    for shape in SWEEP_SHAPES:
        for dones in ("mid", "zeros", "ones"):
            r, d, v = sweep_inputs(torch, gen, shape, dones)
            g = torch.randn(shape, generator=gen, device="cuda")
            for name, kern in gc.KERNELS.items():
                args = ((GAMMA, TAU, r, d, v) if name == "gae_sweep"
                        else (GAMMA, r, d))
                got, want = kern(*args), plain[name](*args)
                ref = plain[name](*(a.cpu().double() if torch.is_tensor(a)
                                    else a for a in args))
                lim = SWEEP_TOL * float(ref.abs().max())
                e_twin = float((got - want).abs().max())
                e_ref = float((got.cpu().double() - ref).abs().max())
                check(bool(torch.isfinite(got).all()), f"{name} finite")
                check(e_twin <= lim and e_ref <= lim,
                      f"{name} {shape} dones {dones}: |err| twin {e_twin}, "
                      f"f64 {e_ref}, limit {lim}")

                def grads(fn):
                    ins = [a.detach().clone().requires_grad_()
                           if torch.is_tensor(a) else a for a in args]
                    return torch.autograd.grad(
                        fn(*ins), [a for a in ins if torch.is_tensor(a)], g)

                before = dict(gc.launch_counts())
                gk, gp = grads(kern), grads(plain[name])
                check(gc.launch_counts()[name] == before[name] + 1,
                      f"{name}: the backward check went through the kernel")
                e_grad = max(float((a - b).abs().max())
                             for a, b in zip(gk, gp))
                glim = SWEEP_TOL * max(float(b.abs().max()) for b in gp)
                check(e_grad <= glim, f"{name} {shape} dones {dones}: "
                                      f"grad |err| {e_grad} > {glim}")
                r_ = res[name]
                r_["max_abs_err"] = max(r_["max_abs_err"], e_twin)
                r_["max_abs_err_f64"] = max(r_["max_abs_err_f64"], e_ref)
                r_["max_grad_err"] = max(r_["max_grad_err"], e_grad)
                if dones != "mid":
                    continue
                n = r.numel()
                arrays, flops = (4, 7) if name == "gae_sweep" else (3, 3)
                bytes_ms = 1e3 * 4 * arrays * n / PEAK_BYTES
                ops_ms = 1e3 * flops * n / PEAK_F32
                # ms: the kernel's device time; call_ms and plain_ms: one
                # call of the wrapper and of the twin as the stream sees
                # it (CUDA events), host dispatch included
                r_["shapes"].append({
                    "shape": list(shape),
                    "ms": kernel_device_ms(torch, lambda: kern(*args),
                                           KERNEL_NAMES[name]),
                    "call_ms": time_ms(lambda: kern(*args), warm=10,
                                       iters=200),
                    "plain_ms": time_ms(lambda: plain[name](*args)),
                    "bytes_ms": bytes_ms, "ops_ms": ops_ms,
                    "bound_ms": max(bytes_ms, ops_ms)})
    for name, r_ in res.items():
        # the kernel's numbers are those of the main path's shape
        main = r_["shapes"][0]
        r_.update({k: main[k] for k in ("ms", "call_ms", "plain_ms",
                                        "bytes_ms", "ops_ms", "bound_ms")},
                  library_ms=None)
        print(f"kernel {name}: max_abs_err {r_['max_abs_err']} (f64 "
              f"{r_['max_abs_err_f64']}, grad {r_['max_grad_err']}); "
              + "; ".join(f"{s['shape']}: ms {s['ms']} call_ms "
                          f"{s['call_ms']} plain_ms {s['plain_ms']} "
                          f"bound_ms {s['bound_ms']}"
                          for s in r_["shapes"]) + f" [{gpu}]", flush=True)
    return res


def trpo_configs():
    """The full-width MAML-TRPO configuration: the trainer's defaults."""
    from exploring_meta_tpu_torch.rl.adapt_rl import RLConfig
    from exploring_meta_tpu_torch.rl.trpo_meta import TRPOConfig
    from exploring_meta_tpu_torch.utils.config import RLScriptConfig
    cfg = RLScriptConfig(num_iterations=TRPO_ITERATIONS)
    rl_cfg = RLConfig(inner_lr=cfg.inner_lr, gamma=cfg.gamma, tau=cfg.tau,
                      adapt_steps=cfg.adapt_steps,
                      adapt_batch_size=cfg.adapt_batch_size,
                      max_path_length=cfg.max_path_length)
    trpo_cfg = TRPOConfig(outer_lr=cfg.outer_lr, max_kl=cfg.max_kl,
                          ls_max_steps=cfg.ls_max_steps,
                          backtrack_factor=cfg.backtrack_factor)
    return cfg, rl_cfg, trpo_cfg


def trpo_phase(torch, gc, tc, gpu, tmp) -> dict:
    """Phase 5: the main path of slice 2, ``RLTrainer.run()``."""
    import math
    from exploring_meta_tpu_torch.models.policies import DiagNormalPolicy
    from exploring_meta_tpu_torch.trainers.rl import RLTrainer
    from exploring_meta_tpu_torch.utils.experiment import load_params

    cfg, _, _ = trpo_configs()
    per_iter = []

    class CountingTrainer(RLTrainer):
        """Records each iteration's wall time and sweep launches."""

        def _make_trpo_iteration(self, *args):
            step = super()._make_trpo_iteration(*args)

            def counted(params, state, gen):
                torch.cuda.synchronize()
                before, t0 = gc.launch_counts(), time.perf_counter()
                out = step(params, state, gen)
                torch.cuda.synchronize()
                after = gc.launch_counts()
                per_iter.append({"s": time.perf_counter() - t0,
                                 **{k: after[k] - before[k] for k in after}})
                return out
            return counted

    trainer = CountingTrainer(cfg, algo="trpo", path=tmp + "/")
    torch.cuda.synchronize()
    gc.reset_launch_counts()
    tc.reset_launch_counts()
    final = trainer.run()
    torch.cuda.synchronize()
    launches = gc.launch_counts()
    print(f"launches in {TRPO_ITERATIONS} meta-iterations: {launches}; per "
          f"iteration: {per_iter}", flush=True)
    check(len(per_iter) == TRPO_ITERATIONS, "every iteration ran")
    for i, it in enumerate(per_iter):
        for name in gc.KERNELS:
            check(it[name] > 0, f"{name} ran in iteration {i}")

    run = trainer.model_path
    with open(os.path.join(run, "metrics.json")) as f:
        metrics = json.load(f)
    for key in ("adapt_reward", "meta_loss", "ls_accepted"):
        vals = metrics.get(key, [])
        check(len(vals) == TRPO_ITERATIONS
              and all(v is not None and math.isfinite(v) for v in vals),
              f"metrics.json {key}: {vals}")
    with open(os.path.join(run, "logger.json")) as f:
        logger = json.load(f)
    check(math.isfinite(final["mean_reward"])
          and logger["final_eval"]["mean_reward"] == final["mean_reward"],
          "final_eval.mean_reward is finite and logged")
    template = DiagNormalPolicy(2, 2).init(torch.Generator().manual_seed(0),
                                           device="cpu")
    params = load_params(os.path.join(run, "model.npz"), template)
    ckpt = load_params(os.path.join(run, "model_checkpoints", "model_0.npz"),
                       template)
    for tree in (params, ckpt):
        check(all(bool(torch.isfinite(t).all()) for t in
                  (tree["sigma"], *(v for layer in tree["mean"]
                                    for v in layer.values()))),
              "saved params are finite")
    s_iter = sum(it["s"] for it in per_iter[1:]) / (len(per_iter) - 1)
    print(f"MAML-TRPO Particles2D, full width: {s_iter} s per meta-iteration "
          f"(mean of iterations 2-{TRPO_ITERATIONS}), metrics {metrics}, "
          f"final_eval mean_reward {final['mean_reward']} [{gpu}]",
          flush=True)
    return {"launches": launches, "per_iteration": per_iter,
            "s_per_iteration": s_iter, "metrics": metrics,
            "final_eval": final, "params": params}


def outer_step_phase(torch, params, gpu) -> dict:
    """Phase 5, second part: one outer step on identical replays on the
    card and on the CPU path."""
    from exploring_meta_tpu_torch.envs.particles2d import Particles2D
    from exploring_meta_tpu_torch.models.policies import DiagNormalPolicy
    from exploring_meta_tpu_torch.rl.adapt_rl import make_trpo_collect
    from exploring_meta_tpu_torch.rl.rollout import make_rollout
    from exploring_meta_tpu_torch.rl.trpo_meta import (
        meta_optimize_trpo, meta_surrogate_loss,
    )
    from exploring_meta_tpu_torch.utils.tree import tree_leaves, tree_map

    cfg, rl_cfg, trpo_cfg = trpo_configs()
    env, policy = Particles2D(), DiagNormalPolicy(2, 2)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    roll = make_rollout(env, policy.sample, episodes=cfg.adapt_batch_size,
                        horizon=cfg.max_path_length)
    params = tree_map(lambda t: t.cuda(), params)
    tasks = env.sample_tasks(gen, cfg.meta_batch_size)
    old, _, replays, _ = make_trpo_collect(policy, roll, rl_cfg)(
        params, tasks, gen)
    out, cpu_new = {}, None
    for dev in ("cpu", "cuda"):
        p, o = (tree_map(lambda t: t.to(dev), x) for x in (params, old))
        rep = replays.map(lambda t: t.to(dev))
        t0 = time.perf_counter()
        new, info = meta_optimize_trpo(policy, p, o, rep, rl_cfg, trpo_cfg,
                                       cfg.adapt_steps)
        seconds = time.perf_counter() - t0
        if dev == "cpu":
            cpu_new = new
        # the surrogate and KL at one point, the CPU step's params
        with torch.no_grad():
            loss, kl = meta_surrogate_loss(
                policy, tree_map(lambda t: t.to(dev), cpu_new), o, rep,
                rl_cfg, cfg.adapt_steps)
        out[dev] = {"new": torch.cat([t.reshape(-1).cpu()
                                      for t in tree_leaves(new)]),
                    "old_loss": float(info["old_loss"]),
                    "loss": float(loss), "kl": float(kl),
                    "accepted": info["accepted"], "s": seconds}
    a, b = out["cuda"], out["cpu"]
    step = float((b["new"] - torch.cat([t.reshape(-1).cpu()
                                        for t in tree_leaves(params)])).norm())
    e_params = float((a["new"] - b["new"]).norm())
    # at the old params the surrogate is 0 up to rounding (ratio 1 against
    # zero-mean normalized advantages), so it is held by size; loss and KL
    # at the stepped params are held relatively
    for key in ("old_loss",):
        check(max(abs(a[key]), abs(b[key])) <= 1e-6,
              f"outer step {key} is 0 up to rounding: {a[key]}, {b[key]}")
    for key in ("loss", "kl"):
        check(abs(a[key] - b[key]) <= 1e-4 * abs(b[key]),
              f"outer step {key}: card {a[key]} vs CPU {b[key]}")
    check(a["accepted"] == b["accepted"], "line search accepts alike")
    # float32 CG on a Fisher damped by 1e-5 amplifies last-bit differences
    # of the two paths: the JAX package's own jitted and eager runs of one
    # step differ by 8e-3 of the step (tests/test_torch_rl_trpo.py)
    check(e_params <= 2e-2 * step,
          f"outer step params: |card - CPU| {e_params} vs step {step}")
    summary = {k: {kk: vv for kk, vv in v.items() if kk != "new"}
               for k, v in out.items()}
    summary.update(step_norm=step, param_err_l2=e_params)
    print(f"outer step, card vs CPU: {summary} [{gpu}]", flush=True)
    return summary


def trpo_profile(torch, gpu) -> dict:
    """Phase 5, last part: where one full-width meta-iteration's time goes.
    Its two phases, collection and the outer step, are timed on the host
    clock (synchronized, no profiler), then run once more under the
    profiler for their kernel-busy time and kernel launches."""
    from exploring_meta_tpu_torch.envs.particles2d import Particles2D
    from exploring_meta_tpu_torch.models.policies import DiagNormalPolicy
    from exploring_meta_tpu_torch.rl.adapt_rl import make_trpo_collect
    from exploring_meta_tpu_torch.rl.rollout import make_rollout
    from exploring_meta_tpu_torch.rl.trpo_meta import make_trpo_meta_step

    cfg, rl_cfg, trpo_cfg = trpo_configs()
    env, policy = Particles2D(), DiagNormalPolicy(2, 2)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    params = policy.init(gen)
    roll = make_rollout(env, policy.sample, episodes=cfg.adapt_batch_size,
                        horizon=cfg.max_path_length)
    collect = make_trpo_collect(policy, roll, rl_cfg)
    meta_step = make_trpo_meta_step(policy, rl_cfg, trpo_cfg,
                                    cfg.adapt_steps)
    tasks = env.sample_tasks(gen, cfg.meta_batch_size)
    old, _, replays, _ = collect(params, tasks, gen)
    phases = {"collect": lambda: collect(params, tasks, gen),
              "meta_step": lambda: meta_step(params, old, replays)}
    out = {}
    for name, fn in phases.items():
        fn()
        torch.cuda.synchronize()
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        busy_us, top, launches = device_profile(torch, fn, launches=True)
        wall_us = 1e6 * sum(walls) / len(walls)
        out[name] = {"wall_us": wall_us, "busy_us": busy_us,
                     "kernel_launches": launches, "top": top}
        print(f"{name}: {wall_us} us wall, kernels busy {busy_us} us "
              f"({100 * busy_us / wall_us:.1f} %), {launches} kernel "
              f"launches [{gpu}]")
        for key, us, count in top:
            print(f"  {us:12.1f} us  x{count:5d}  {key}")
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    repo = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, repo)
    import numpy as np
    import torch.nn.functional as F
    from exploring_meta_tpu_torch.cuda import build, cnn4_cuda as tc
    from exploring_meta_tpu_torch.cuda import gae_cuda as gc
    from exploring_meta_tpu_torch.models.layers import (
        get_conv_impl, set_precision,
    )

    set_precision("highest")
    check(get_conv_impl() == "fused", "the served path runs the fused kernels")
    gpu = gpu_line()
    print(f"gpu: {gpu}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    build_s, ptxas = build_all(build)
    print(f"build: {build_s:.1f} s for {sorted(ptxas)}", flush=True)
    for src, lines in ptxas.items():
        for ln in lines:
            print(f"ptxas {src}: {ln}")

    res = kernel_phase(tc, F, torch)
    for name, r in res.items():
        print(f"kernel {name}: max_abs_err {r['max_abs_err']} ms {r['ms']} "
              f"plain_ms {r['plain_ms']} library_ms {r['library_ms']} "
              f"bound_ms {r['bound_ms']} [{gpu}]", flush=True)
    served = serve_phase(torch, np, tc, gpu)
    sweeps = sweep_phase(torch, gc, gpu)
    with tempfile.TemporaryDirectory() as tmp:
        trpo = trpo_phase(torch, gc, tc, gpu, tmp)
        outer = outer_step_phase(torch, trpo.pop("params"), gpu)
    prof = trpo_profile(torch, gpu)

    os.makedirs(os.path.join(repo, "chiprun_out"), exist_ok=True)
    with open(os.path.join(repo, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"gpu": gpu, "build_s": build_s, "ptxas": ptxas,
                   "kernels": {**res, **sweeps}, "serve": served,
                   "trpo": trpo, "outer_step": outer, "trpo_profile": prof},
                  f, indent=1)

    replaces = {
        "cnn4_block_fwd": "exploring_meta_tpu/pallas/cnn4_pallas.py:295",
        "cnn4_block_bwd_params": "exploring_meta_tpu/pallas/cnn4_pallas.py:310",
        "cnn4_block_bwd_input": "exploring_meta_tpu/pallas/cnn4_pallas.py:310",
        "gae_sweep": "exploring_meta_tpu/pallas/gae_pallas.py:62",
        "discount_sweep": "exploring_meta_tpu/pallas/gae_pallas.py:62",
    }
    launches = {**served["launches"], **trpo["launches"]}
    kernels = []
    for name, r in {**res, **sweeps}.items():
        source = "gae.cu" if name in sweeps else "cnn4_block.cu"
        err = r["max_abs_err"]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"exploring_meta_tpu_torch/csrc/{source}",
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": max(err.values()) if isinstance(err, dict) else err,
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": "bytes" if r["bytes_ms"] >= r["ops_ms"] else "operations",
            "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
