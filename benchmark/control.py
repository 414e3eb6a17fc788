"""Readings that set the limits of ``correct``: the program's sound runs on
many seeds, and the control's.

    python3 -m benchmark.control --workload <name> --seeds 1,2,3 [--control]

For each seed, in one process: the cell's set-up, then its steps up to the
last one its check samples (at the cell's own sizes and load), then the
cell's check, printed as one JSON line (``seed``, ``control``, ``checks``:
each number and its current limit). With ``--control`` the driver's
``control`` first switches the timed path to the control: the program in
the precision below the configuration's, or the reference put in its place
in that precision. With ``--fault <name>`` the driver's ``fault`` plants a
fault of the timed path instead (the training cell's readings of its
faults). The benchmark's own runs never run either.
"""
from __future__ import annotations

import argparse
import json
import sys
import time


def readings(root, name: str, seed: int, control: bool, device, fault: str = "") -> dict:
    import torch

    from . import spec as spec_mod
    from .run import Context
    from .trace import Tracer

    sp = spec_mod.Spec(root)
    cell = sp.cell(name)
    ctx = Context(cell, sp.config(cell), sp.traffic(cell), int(seed), torch.device(device), Tracer(False))
    drv = sp.driver(ctx.traffic["driver"])
    st = drv.setup(ctx)
    if control:
        drv.control(ctx, st)
    if fault:
        drv.fault(ctx, st, fault)
    keep = getattr(st, "keep", ())
    for i in range(max(keep) + 1 if keep else 0):
        drv.step(ctx, st, i)
    checks, failed = drv.check(ctx, st)
    return {"seed": seed, "control": control, "fault": fault, "failed": failed, "info": ctx.info,
            "checks": {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", default="", help="plant the driver's named fault instead (training cells)")
    args = ap.parse_args(argv)
    import torch

    from . import spec as spec_mod

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    for s in args.seeds.split(","):
        t0 = time.perf_counter()
        r = readings(spec_mod.ROOT, args.workload, int(s), args.control, "cuda", args.fault)
        r["seconds"] = time.perf_counter() - t0
        print(json.dumps(r), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
