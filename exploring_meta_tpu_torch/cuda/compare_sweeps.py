"""Time builds of the sweep kernels against each other, in turns, on one card.

    python -m exploring_meta_tpu_torch.cuda.compare_sweeps \\
        [--source NAME=PATH.cu ...] [--variant NAME:kSeg=8,kLanes=8 ...]
        [--rounds 2]

Every build exposes the C interface of ``csrc/gae.cu`` (``gae_sweep``,
``discount_sweep``). ``csrc/gae.cu`` itself is built as ``new``; each
``--source`` as NAME (for example an earlier revision of the file, from
``git show <rev>:exploring_meta_tpu_torch/csrc/gae.cu``); each
``--variant`` as ``csrc/gae.cu`` with the ``constexpr int`` constants it
names set to its values. All are compiled at
once (one ``nvcc`` each), each is held against the plain twins at every
shape, then each kernel's device time per launch (profiler, CUPTI) is
taken at every shape, the builds in turns: in order, then reversed,
``--rounds`` times. Prints one line per build, shape and kernel, with the
card's name and power limit, and writes the numbers to
``chiprun_out/compare_sweeps.json``.
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

from exploring_meta_tpu_torch.cuda import build, gae_cuda as gc

SHAPES = [(20, 100, 20), (40, 150, 20), (100, 400), (100,), (1000,)]
GAMMA, TAU = 0.99, 1.0
CALLS = 50


def substitute(text: str, spec: str) -> str:
    """``"kSeg=8,kLanes=8"`` -> ``text`` with those constants set."""
    for item in spec.split(","):
        name, value = item.split("=")
        text, k = re.subn(rf"constexpr int {name} = \d+;",
                          f"constexpr int {name} = {int(value)};", text)
        assert k == 1, f"{name} not found"
    return text


def _compile(name: str, text: str, subdir: str = "compare") -> tuple[str, list]:
    """-> (library path, ptxas lines), built under ``build/<subdir>``."""
    out = os.path.join(build.BUILD_DIR, subdir)
    os.makedirs(out, exist_ok=True)
    src, lib = os.path.join(out, f"{name}.cu"), os.path.join(out, f"{name}.so")
    with open(src, "w") as f:
        f.write(text)
    proc = subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-o", lib,
                           src], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stderr}")
    return lib, [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
                 if "Used" in ln or "spill" in ln or "entry function" in ln]


def _load(path: str):
    lib = ctypes.CDLL(path)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.gae_sweep.argtypes = [P] * 4 + [I] * 3 + [F, F, P]
    lib.discount_sweep.argtypes = [P] * 3 + [I] * 3 + [F, P]
    return lib


def _calls(lib, shape, gen):
    """-> {kernel: (launch fn, output, plain result)} at one shape."""
    r, v = (torch.randn(shape, generator=gen, device="cuda")
            for _ in range(2))
    d = (torch.rand(shape, generator=gen, device="cuda") < 0.1).float()
    G, T, L = gc.sweep_view(r).shape
    stream = torch.cuda.current_stream().cuda_stream
    o_gae, o_disc = torch.empty_like(r), torch.empty_like(r)

    def gae():
        err = lib.gae_sweep(r.data_ptr(), d.data_ptr(), v.data_ptr(),
                            o_gae.data_ptr(), G, T, L, GAMMA, GAMMA * TAU,
                            stream)
        assert err == 0, f"gae_sweep: cudaError {err}"

    def disc():
        err = lib.discount_sweep(r.data_ptr(), d.data_ptr(),
                                 o_disc.data_ptr(), G, T, L, GAMMA, stream)
        assert err == 0, f"discount_sweep: cudaError {err}"

    return {"gae_sweep": (gae, o_gae, gc.gae_plain(GAMMA, TAU, r, d, v)),
            "discount_sweep": (disc, o_disc, gc.discount_plain(GAMMA, r, d))}


def _device_us(fn) -> float:
    """Mean device time of the kernels ``fn`` launches, per call. A
    profiler session that records fewer than nine in ten of them is taken
    again, at most five times (as chip_smoke.py's ``kernel_device_ms``)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(CALLS):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        count = sum(e.count for e in events)
        if count >= 0.9 * CALLS:
            break
    assert count >= 0.9 * CALLS, f"profiler saw {count} of {CALLS} launches"
    return sum(e.self_device_time_total for e in events) / count


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--source", action="append", default=[],
                   metavar="NAME=PATH")
    p.add_argument("--variant", action="append", default=[],
                   metavar="NAME:CONST=VALUE[,CONST=VALUE]")
    p.add_argument("--rounds", type=int, default=2)
    args = p.parse_args()
    gpu = subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    with open(os.path.join(build.CSRC, "gae.cu")) as f:
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
        built = dict(zip(texts, pool.map(lambda kv: _compile(*kv),
                                         texts.items())))
    for name, (_, ptxas) in built.items():
        for ln in ptxas:
            print(f"ptxas {name}: {ln}")

    gen = torch.Generator(device="cuda").manual_seed(0)
    runs = {name: {shape: _calls(_load(lib), shape, gen) for shape in SHAPES}
            for name, (lib, _) in built.items()}
    for name, per_shape in runs.items():
        for shape, calls in per_shape.items():
            for kernel, (fn, out, want) in calls.items():
                fn()
                torch.cuda.synchronize()
                err = float((out - want).abs().max())
                assert err <= 1e-5 * float(want.abs().max()), \
                    f"{name} {kernel} {shape}: |err| {err}"
    times = {name: {f"{s}": {k: [] for k in gc.KERNELS} for s in SHAPES}
             for name in runs}
    order = list(runs)
    for _ in range(args.rounds):
        for name in order + order[::-1]:
            for shape, calls in runs[name].items():
                for kernel, (fn, _, _) in calls.items():
                    times[name][f"{shape}"][kernel].append(_device_us(fn))
    for name, per_shape in times.items():
        for shape, per_kernel in per_shape.items():
            for kernel, us in per_kernel.items():
                print(f"{name} {shape} {kernel}: {sum(us) / len(us)} us a "
                      f"launch (turns: {us}) [{gpu}]")
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "compare_sweeps.json"), "w") as f:
        json.dump({"gpu": gpu, "order": order, "us": times,
                   "ptxas": {k: v[1] for k, v in built.items()}}, f,
                  indent=1)


if __name__ == "__main__":
    main()
