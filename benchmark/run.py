"""Run one cell of the benchmark of ``sdf_tools_tpu_torch`` once.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell's entry in ``BENCHMARK.json`` names
its configuration and traffic mix; the traffic file names the driver that
plays it (``benchmark/spec.py``). The run:

1. builds the cell's inputs from ``--seed`` on the card and warms up every
   shape it will use (set-up, ``setup_s``: from the process's start to the
   window's, less the seconds a driver spends in the reference making its
   inputs, ``reference_s``);
2. drives the program in a closed loop for ``--seconds``, each step ending
   in a value read back to the host;
3. with ``--trace 1``, profiles the window's last seconds and reads the
   per-layer metrics from them and from the untraced steps before them
   (``benchmark/trace.py``, ``benchmark/metrics/``);
4. reads the peak device memory, then compares a seeded sample of what the
   window produced with the plain reference (``benchmark/reference/``);
5. prints what the host and the card did beside the window
   (``benchmark/host.py``), then each compared number beside its limit as
   the last lines of standard error, and one JSON line last on standard
   output.

It exits with 2, printing no result, without a CUDA card or with fewer
cards than the cell asks for, and with 3 if the process holds JAX or the
JAX package once the window has closed.
"""
from __future__ import annotations

import time

_T0 = time.perf_counter()  # the process's start, as near as Python sees it

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from pathlib import Path  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "sdf_tools_tpu")


def forbidden_modules(names=None) -> list:
    """Top-level names in ``sys.modules`` (or ``names``) that a run may not
    hold, compared whole (``sdf_tools_tpu_torch`` is not ``sdf_tools_tpu``)."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


@dataclass
class Context:
    """What a driver is given: the cell's data files, the seed, the device
    and the spans."""

    cell: dict
    config: dict
    traffic: dict
    seed: int
    device: object
    tracer: object
    info: dict = field(default_factory=dict)  # notes a driver adds to standard error

    def sub_seed(self, *parts: int) -> int:
        from . import scenes

        return scenes.sub_seed(self.seed, *parts)

    def sync(self) -> None:
        if self.device.type == "cuda":
            import torch

            torch.cuda.synchronize(self.device)


@dataclass
class ReadContext:
    """What a per-layer metric's reader is given."""

    trace: object  # trace.TraceSummary
    steps: int  # steps (updates, calls) in the traced part of the window
    config: dict
    untraced_steps: int = 0  # steps of the window before the profiler started
    untraced_s: float = 0.0  # their host seconds
    untraced_lat: list = field(default_factory=list)  # each one's host seconds


def run_cell(root: Path, name: str, seed: int, seconds: float, trace: bool, device, t0: float = None) -> dict:
    """One run of cell ``name`` of the checkout at ``root`` on ``device``:
    the result's dict (``checks`` last)."""
    import torch

    from . import host
    from . import spec as spec_mod
    from .trace import TRACE_SECONDS, Tracer

    t0 = _T0 if t0 is None else t0
    sp = spec_mod.Spec(root)
    cell = sp.cell(name)
    tracer = Tracer(trace)
    ctx = Context(cell, sp.config(cell), sp.traffic(cell), int(seed), torch.device(device), tracer)
    drv = sp.driver(ctx.traffic["driver"])

    state = drv.setup(ctx)
    ctx.sync()
    lat = []
    untraced_steps, t_trace, t_traced = 0, None, None
    t_start = time.perf_counter()
    while True:
        if tracer.enabled and not tracer.active and time.perf_counter() - t_start >= seconds - TRACE_SECONDS:
            # the profiler over the window's last seconds: the steps before it
            # give the host's time a step untouched by it. Its start takes
            # seconds on the card, so the traced steps run TRACE_SECONDS
            # from its start's end, past ``seconds`` if need be
            untraced_steps, t_trace = len(lat), time.perf_counter()
            tracer.start()
            t_traced = time.perf_counter()
        a = time.perf_counter()
        drv.step(ctx, state, len(lat))
        b = time.perf_counter()
        lat.append(b - a)
        if b - t_start >= seconds and (t_traced is None or b - t_traced >= TRACE_SECONDS):
            break
    tracer.stop()
    traced_steps = len(lat) - untraced_steps
    window_s = b - t_start
    reference_s = float(getattr(state, "reference_s", 0.0))
    setup_s = t_start - t0 - reference_s
    ctx.info["host"] = host.window_note(lat, reference_s)
    cuda = ctx.device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(ctx.device) if cuda else 0

    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(ctx.device) if cuda else "cpu",
              "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    if cuda:
        card = host.card_sample()
        device["power_limit"] = card.get("power.limit", "unknown")
        ctx.info["card"] = card
    result = {"correct": False, "attempted": len(lat), "failed": 0, "metrics": {}, "device": device}

    if trace:
        summary = tracer.summary()
        device["busy_s"] = summary.busy_s
        device["window_s"] = summary.window_s
        rc = ReadContext(summary, traced_steps, ctx.config, untraced_steps, t_trace - t_start, lat[:untraced_steps])
        for m in sp.per_layer(name):
            value = sp.reader(m["name"]).read(rc)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
        result["breakdown"] = {"device_ops": summary.device_ops, "idle_gaps": summary.idle_gaps}
        ctx.info["trace"] = (f"{summary.n_device_ops} device ops, {summary.unmatched_s:.6f} s of them "
                             f"with no launch found, spans {sorted(summary.span_s)}; host ms a step "
                             f"{host.ms_per_step(lat[:untraced_steps])} before the profiler, "
                             f"{host.ms_per_step(lat[untraced_steps:])} under it")
    else:
        e2e = drv.end_to_end(ctx, state, lat, window_s)
        e2e["setup_s"] = setup_s
        for m in sp.end_to_end(name):
            result["metrics"][m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}

    checks, failed = drv.check(ctx, state)
    del state
    for key, note in ctx.info.items():
        print(f"{key}: {note}", file=sys.stderr)
    result["failed"] = int(failed)
    result["correct"] = bool(checks) and all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks)
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from . import spec as spec_mod

    root = spec_mod.ROOT
    chips = int(spec_mod.Spec(root).cell(args.workload)["chips"])
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"no result: the cell needs {chips} CUDA card(s), this process sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result = run_cell(root, args.workload, args.seed, args.seconds, bool(args.trace), "cuda")
    found = forbidden_modules()
    if found:
        print(f"no result: the process holds {found} after the window", file=sys.stderr)
        return 3
    for c_name, c in result["checks"].items():
        print(f"check {c_name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
