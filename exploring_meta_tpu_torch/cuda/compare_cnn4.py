"""Hold builds of the CNN4 block kernels against their twins, and time them
against each other in turns, on one card.

    python -m exploring_meta_tpu_torch.cuda.compare_cnn4 \\
        [--source NAME=PATH.cu ...] [--variant NAME:CONST=VALUE[,..] ...]
        [--dtypes bfloat16,float32] [--batches 64,1] [--ns 25]
        [--rounds 2] [--profile] [--json PATH]

Every build exposes the C interface of ``csrc/cnn4_block.cu``.
``csrc/cnn4_block.cu`` itself is built as ``new``; each ``--source`` as
NAME (an earlier revision of the file, from ``git show
<rev>:exploring_meta_tpu_torch/csrc/cnn4_block.cu``); each ``--variant`` as
``csrc/cnn4_block.cu`` with the ``constexpr int`` constants it names set to
its values (``kTcStages=3``). All are compiled at once, one ``nvcc``
each, and called through ctypes with a workspace large enough for any of
them.

At each CNN4-Omniglot block shape, for each task count of ``--batches``
(64: a served batch; 1: one request), image count of ``--ns`` and dtype,
each build's three kernels are held against their plain twins as
``chip_smoke.py``'s ``kernel_phase`` holds the port's: float32 within
1e-4 (``chip_smoke.TOL``), the f32 dy too; the bfloat16 outputs of the
forward, of ``bwd_params`` and of ``bwd_input`` against the twin taken in
float64, by :func:`cnn4_cuda.bf16_agreement` and
:func:`cnn4_cuda.bf16_share_holds` (one bf16 ulp plus f32 noise, and at
most ``BF16_SHARE`` of the elements differing); db, rounding noise by
construction, by its magnitude. Beside the builds, two readings of
the share check in bfloat16: the f32 twin's own outputs against the
float64 twin (``twin_f32``: what float32-precision sums give), and a dw
and a dx from dy rounded to one bf16 (:func:`cnn4_cuda.rounded_dy_share`,
:func:`cnn4_cuda.rounded_dy_dx_share`). Then,
unless ``--rounds 0``, each kernel's ms a call, back to back in a CUDA
graph (``utils/profiling.py:graph_ms_per_call``), the builds in turns:
in order, then reversed, ``--rounds`` times; with ``--profile`` also each
kernel's CUDA launches by name (profiler). Prints one line per build,
shape and kernel with the card's name and power limit, and with
``--json PATH`` writes everything there.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
from concurrent.futures import ThreadPoolExecutor

import torch

from exploring_meta_tpu_torch.cuda import build, cnn4_cuda as tc
from exploring_meta_tpu_torch.cuda.compare_sweeps import _compile, substitute
from exploring_meta_tpu_torch.utils.profiling import graph_ms_per_call

BLOCKS = [(28, 1), (14, 64), (7, 64), (4, 64)]
CO = 64
DTYPES = {"float32": (torch.float32, 0), "bfloat16": (torch.bfloat16, 1)}
F32_TOL = 1e-4
DB_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
NAMES = ("dy", "dw", "db", "dscale", "dbias")


def _load(path: str):
    lib = ctypes.CDLL(path)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.cnn4_block_fwd.argtypes = [I] + [P] * 7 + [I] * 6 + [P]
    lib.cnn4_block_bwd_params.argtypes = [I] + [P] * 12 + [I] * 6 + [P]
    lib.cnn4_block_bwd_input.argtypes = [I] + [P] * 3 + [I] * 6 + [P]
    return lib


def block_inputs(gen, b, n, h, ci, dt):
    """cnn4_cuda.block_inputs and a dy for the input gradient."""
    ins = tc.block_inputs(gen, b, n, h, ci, CO, dt)
    ho = tc.out_hw(h)
    return ins + (torch.randn(b, n, ho, ho, CO, generator=gen,
                              device="cuda"),)


def _calls(lib, dname, ins):
    """-> {kernel: (launch fn, outputs)} of one build at one shape."""
    dt, code = DTYPES[dname]
    x, w, bb, sc, be, g, dyin = ins
    B, n, h, _, ci = x.shape
    ho = tc.out_hw(h)
    ws = torch.empty(tc.bwd_params_workspace_floats(B, n, h, h, ci, CO,
                                                    torch.bfloat16)
                     + 2 * B * CO, dtype=torch.float32, device="cuda")
    out = torch.empty(B, n, ho, ho, CO, dtype=dt, device="cuda")
    dy = torch.empty(B, n, ho, ho, CO, dtype=torch.float32, device="cuda")
    grads = [torch.empty_like(t) for t in (w, bb, sc, be)]
    dx = torch.empty_like(x)
    p = [t.data_ptr() for t in (x, w, bb, sc, be)]

    def stream():   # the capturing stream inside a graph capture
        return torch.cuda.current_stream().cuda_stream

    def fwd():
        err = lib.cnn4_block_fwd(code, *p, out.data_ptr(), ws.data_ptr(), B,
                                 n, h, h, ci, CO, stream())
        assert err == 0, f"cnn4_block_fwd: cudaError {err}"

    def bwd_params():
        err = lib.cnn4_block_bwd_params(
            code, *p, g.data_ptr(), dy.data_ptr(),
            *(t.data_ptr() for t in grads), ws.data_ptr(), B, n, h, h, ci,
            CO, stream())
        assert err == 0, f"cnn4_block_bwd_params: cudaError {err}"

    def bwd_input():
        err = lib.cnn4_block_bwd_input(code, dyin.data_ptr(), w.data_ptr(),
                                       dx.data_ptr(), B, n, h, h, ci, CO,
                                       stream())
        assert err == 0, f"cnn4_block_bwd_input: cudaError {err}"

    return {"cnn4_block_fwd": (fwd, [out]),
            "cnn4_block_bwd_params": (bwd_params, [dy] + grads),
            "cnn4_block_bwd_input": (bwd_input, [dx])}


def twins(ins, acc) -> dict:
    """{kernel: its twin's outputs}, each taken in ``acc``."""
    x, w, bb, sc, be, g, dyin = ins
    h = x.shape[2]
    return {"cnn4_block_fwd": [tc.block_fwd_plain(x, w, bb, sc, be, acc)],
            "cnn4_block_bwd_params": list(tc.block_bwd_params_plain(
                x, w, bb, sc, be, g, acc)),
            "cnn4_block_bwd_input": [tc.block_bwd_input_plain(dyin, w, h, h,
                                                              acc)]}


def held(dname, outs, want, want64) -> dict:
    """Each kernel's outputs (``outs``: {kernel: outputs}) against the
    twins' -> per output {"over": its error over its limit} (float32, dy,
    db), or bf16_agreement's ulp ratio and share against the float64 twin
    with whether the share holds."""
    res = {}
    for kernel, got_all in outs.items():
        names = NAMES if kernel == "cnn4_block_bwd_params" else ("out",)
        for i, (name, got) in enumerate(zip(names, got_all)):
            key, ref = f"{kernel}.{name}", want[kernel][i]
            gotf, reff = got.float(), ref.float()
            if not bool(torch.isfinite(gotf).all()):
                res[key] = {"finite": False}
                continue
            d = (gotf - reff).abs()
            if name == "db":
                lim = DB_TOL[dname] * want["cnn4_block_bwd_params"][0].abs(
                    ).sum(dim=(1, 2, 3))
                res[key] = {"over": float((d / lim).max())}
            elif dname == "float32" or name == "dy":
                lim = F32_TOL * reff.abs().max() + F32_TOL * reff.abs()
                res[key] = {"over": float((d / lim).max())}
            else:
                over, share = tc.bf16_agreement(got, want64[kernel][i])
                res[key] = {"over": over, "share": share,
                            "holds": over <= 1.0 and tc.bf16_share_holds(
                                share, got.numel())}
    return res


def _run(fns) -> dict:
    """Call each kernel of one build once -> {kernel: its outputs}."""
    outs = {}
    for kernel, (fn, got) in fns.items():
        fn()
        outs[kernel] = got
    torch.cuda.synchronize()
    return outs


def profile_kernels(fn, calls: int = 10) -> dict:
    """{CUDA kernel name: device us a call} of ``fn`` under the profiler."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {(re.findall(r"\w+_kernel(?:<[^>]*>)?", e.key) or [e.key])[0]:
            e.self_device_time_total / calls
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--source", action="append", default=[],
                   metavar="NAME=PATH")
    p.add_argument("--variant", action="append", default=[],
                   metavar="NAME:CONST=VALUE[,CONST=VALUE]")
    p.add_argument("--dtypes", default="bfloat16,float32")
    p.add_argument("--batches", default="64,1",
                   help="task counts B, comma-separated")
    p.add_argument("--ns", default="25",
                   help="images a task N, comma-separated")
    p.add_argument("--rounds", type=int, default=2,
                   help="timing rounds (0: check only)")
    p.add_argument("--json", metavar="PATH",
                   help="write the checks, times and profiles here")
    p.add_argument("--profile", action="store_true",
                   help="also each kernel's CUDA kernels' device time, "
                        "per build and shape (profiler)")
    args = p.parse_args()
    gpu = subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    with open(os.path.join(build.CSRC, tc._SOURCE)) as f:
        new = f.read()
    texts = {"new": new}
    for spec in args.variant:
        name, consts = spec.split(":", 1)
        texts[name] = substitute(new, consts)
    for spec in args.source:
        name, path = spec.split("=", 1)
        with open(path) as f:
            texts[name] = f.read()
    with ThreadPoolExecutor(len(texts)) as pool:
        built = dict(zip(texts, pool.map(
            lambda kv: _compile(*kv, "compare_cnn4"), texts.items())))
    for name, (_, ptxas) in built.items():
        for ln in ptxas:
            print(f"ptxas {name}: {ln}", flush=True)
    libs = {name: _load(lib) for name, (lib, _) in built.items()}

    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes = [(dname, b, n, blk) for dname in args.dtypes.split(",")
              for b in map(int, args.batches.split(","))
              for n in map(int, args.ns.split(",")) for blk in range(4)]
    inputs, checks, controls = {}, {}, {}
    for dname, b, n, blk in shapes:
        h, ci = BLOCKS[blk]
        key = f"{dname} B {b} N {n} block {blk + 1}"
        ins = block_inputs(gen, b, n, h, ci, DTYPES[dname][0])
        if args.rounds or args.profile:   # kept for the timing
            inputs[key] = ins
        want = twins(ins, torch.float32)
        want64 = twins(ins, torch.float64) if dname == "bfloat16" else None
        runs = {name: _run(_calls(lib, dname, ins))
                for name, lib in libs.items()}
        if dname == "bfloat16":
            runs["twin_f32"] = want
            controls[key] = {
                "dw": tc.rounded_dy_share(*ins[:6]),
                "dx": tc.rounded_dy_dx_share(ins[6], ins[1], h, h)}
            print(f"{key}: dw and dx from a bf16-rounded dy differ from the "
                  f"float64 twin's in shares {controls[key]}", flush=True)
        for name, outs in runs.items():
            checks.setdefault(name, {})[key] = res = held(dname, outs, want,
                                                          want64)
            print(f"{name} {key}: " + " ".join(
                f"{k} {v}" for k, v in res.items()), flush=True)
        del want, want64, runs
    for name, per_shape in checks.items():
        worst = {}
        for res in per_shape.values():
            for k, v in res.items():
                if "share" in v:
                    worst[k] = max(worst.get(k, 0.0), v["share"])
        held_all = all(v.get("holds", True) and v.get("finite", True)
                       for res in per_shape.values() for v in res.values())
        print(f"{name}: largest share per output {worst}; every bf16 check "
              f"held: {held_all} [{gpu}]", flush=True)
    times = {name: {key: {} for key in inputs} for name in libs}
    order = list(libs)
    for _ in range(args.rounds):
        for name in order + order[::-1]:
            for key, ins in inputs.items():
                for kernel, (fn, _) in _calls(libs[name], key.split()[0],
                                              ins).items():
                    times[name][key].setdefault(kernel, []).append(
                        graph_ms_per_call(fn))
    profiles = {}
    if args.profile:
        for name, lib in libs.items():
            for key, ins in inputs.items():
                for kernel, (fn, _) in _calls(lib, key.split()[0],
                                              ins).items():
                    prof = profile_kernels(fn)
                    profiles.setdefault(name, {}).setdefault(key, {})[
                        kernel] = prof
                    print(f"profile {name} {key} {kernel}: " + ", ".join(
                        f"{k} {v:.2f} us" for k, v in prof.items()),
                        flush=True)
    for name, per_shape in times.items():
        for key, per_kernel in per_shape.items():
            for kernel, ms in per_kernel.items():
                print(f"{name} {key} {kernel}: {sum(ms) / len(ms)} ms a "
                      f"call (turns: {ms}) [{gpu}]", flush=True)
    if args.json is None:
        return
    os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
    with open(args.json, "w") as f:
        json.dump({"gpu": gpu, "order": order, "ms": times,
                   "checks": checks, "rounded_dy_share": controls,
                   "profiles": profiles,
                   "ptxas": {k: v[1] for k, v in built.items()}}, f,
                  indent=1)


if __name__ == "__main__":
    main()
