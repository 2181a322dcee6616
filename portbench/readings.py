"""Reads the numbers that decide ``correct`` over many seeds, in one
process: of the program, of the control (the reference in the precision
below the configuration's, in the program's place), of the reference in
another precision (``float32``) and of planted faults (``faults.py``).
The limits in ``limits/<cell>.json`` are set from these readings (PERF.md
gives them).

    python3 portbench/readings.py --workload <cell> --seeds 1,2,3 \\
        --variants program,control,half_batch --seconds 2 \\
        --out chiprun_out/readings.json
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def read(workload: str, seed: int, variant: str, seconds: float,
         device: str = "cuda", overrides: dict | None = None) -> dict:
    """The readings of one run of ``variant`` (program, control, a fault
    kind or a reference precision) -> ``{name: value}``, and its
    ``correct``."""
    import contextlib
    from portbench import faults, harness, registry
    cell = registry.cell(workload, registry.benchmark())
    traffic = registry.traffic(cell["traffic"])
    plant = (faults.plant(variant, traffic["driver"])
             if variant in faults.KINDS else contextlib.nullcontext())
    with plant:
        out = harness.run_cell(
            workload, seed, seconds, False, time.perf_counter(), device,
            variant="program" if variant in faults.KINDS else variant,
            overrides=overrides)
    return {"readings": out["readings"], "correct": out["correct"],
            "attempted": out["attempted"]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--variants", default="program,control")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    rows = []
    for variant in args.variants.split(","):
        for seed in (int(s) for s in args.seeds.split(",")):
            t0 = time.perf_counter()
            row = {"variant": variant, "seed": seed,
                   **read(args.workload, seed, variant, args.seconds),
                   "s": time.perf_counter() - t0}
            rows.append(row)
            print(json.dumps(row), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
