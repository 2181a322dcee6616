#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card (H100, sm_90a).

    python3 chip_smoke.py            # from the repository root

Phases, each of which fails the run (non-zero exit) on any error:

1. print the card's name and power limit (``nvidia-smi``);
2. build the fused CNN4 block kernels from ``exploring_meta_tpu_torch/
   csrc`` with ``nvcc`` and print what ``ptxas`` reports for them;
3. at each of the four CNN4-Omniglot block shapes (B = 64 requests, 25
   support images each), in float32 and bfloat16, launch every kernel,
   hold it against its plain PyTorch twin on the same inputs, and time
   kernel, twin and a PyTorch library yardstick with CUDA events;
4. write full-width ``omniglot_spec(ways=5)`` params made from a seed to
   ``.npz`` and load them with ``VisionServer.from_checkpoint``;
5. serve 64 synthetic-Omniglot requests (5-way 5-shot, 15 queries)
   through ``VisionServer.batch`` with the launch counters zeroed just
   before and read just after, check that every kernel ran, that the
   batch agrees with per-request ``__call__`` and with the CPU path on two
   requests, and that the support set is labelled above chance; time it;
6. print one ``{"kernels": [...]}`` line, the card line again, and last
   ``{"ok": true, "device": {...}}``.

Per-shape details go to ``chiprun_out/chip_smoke.json``. The script
imports neither JAX nor the JAX package. Without a card it exits 1 and
prints no result.
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
    from exploring_meta_tpu_torch.models.cnn4 import init_cnn4, omniglot_spec
    from exploring_meta_tpu_torch.models.layers import (
        get_conv_impl, set_precision,
    )
    from exploring_meta_tpu_torch.serve import VisionServer
    from exploring_meta_tpu_torch.tasks import datasets as td
    from exploring_meta_tpu_torch.tasks import sampler as ts
    from exploring_meta_tpu_torch.utils.experiment import flatten_params

    set_precision("highest")
    check(get_conv_impl() == "fused", "the served path runs the fused kernels")
    gpu = gpu_line()
    print(f"gpu: {gpu}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    tc._load()
    build_s = time.perf_counter() - t0
    with open(build.library_path("cnn4_block.cu") + ".log") as f:
        ptxas = [ln.strip() for ln in f if "Used" in ln or "spill" in ln]
    print(f"build: {build_s:.1f} s", flush=True)
    for ln in ptxas:
        print(f"ptxas: {ln}")

    res = kernel_phase(tc, F, torch)
    for name, r in res.items():
        print(f"kernel {name}: max_abs_err {r['max_abs_err']} ms {r['ms']} "
              f"plain_ms {r['plain_ms']} library_ms {r['library_ms']} "
              f"bound_ms {r['bound_ms']} [{gpu}]", flush=True)

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

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        server.batch(sx, sy, qx)
        torch.cuda.synchronize()
    # device kernels only: a CPU op that launched a kernel reports the
    # kernel's time as well, so summing every event would count it twice
    kernel_events = sorted(
        (e for e in prof.key_averages()
         if e.device_type == torch.autograd.DeviceType.CUDA),
        key=lambda e: -e.self_device_time_total)
    device_us = sum(e.self_device_time_total for e in kernel_events)
    top = [(e.key[:60], e.self_device_time_total, e.count)
           for e in kernel_events[:8]]
    print(f"profile of one served batch: kernels busy {device_us} us of "
          f"{1e6 * serve_s['float32']} us wall [{gpu}]")
    for key, us, count in top:
        print(f"  {us:12.1f} us  x{count:4d}  {key}")

    os.makedirs(os.path.join(repo, "chiprun_out"), exist_ok=True)
    with open(os.path.join(repo, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"gpu": gpu, "kernels": res, "launches": launches,
                   "serve_s": serve_s, "support_acc": support_acc,
                   "query_acc": query_acc, "build_s": build_s,
                   "ptxas": ptxas, "profile_top": top,
                   "profile_device_us": device_us}, f, indent=1)

    replaces = {
        "cnn4_block_fwd": "exploring_meta_tpu/pallas/cnn4_pallas.py:295",
        "cnn4_block_bwd_params": "exploring_meta_tpu/pallas/cnn4_pallas.py:310",
        "cnn4_block_bwd_input": "exploring_meta_tpu/pallas/cnn4_pallas.py:310",
    }
    kernels = []
    for name, r in res.items():
        kernels.append({
            "name": name, "route": "cuda",
            "source": "exploring_meta_tpu_torch/csrc/cnn4_block.cu",
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"].values()),
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
