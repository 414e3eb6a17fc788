"""The port's spans and host-side counters on the card, cell by cell.

    python3 tools/program_spans.py [--cells NAME,...] [--seed N] [--seconds S] [--rounds R] [--out FILE]

For each cell of ``BENCHMARK.json`` (default: every one), set up as
``benchmark/run.py`` sets it up (its driver, configuration, traffic and
seed), then:

1. census: ``--census`` steps, one at a time, under
   ``torch.cuda.set_sync_debug_mode("warn")``: each synchronizing call's
   warning, by the file and line of the Python frame that made it (the
   port's, or the benchmark's own read at the step's end), beside the step's
   ``profiling.COUNTS`` (``sync.*``, ``render.march_rays``);
2. bitwise: one step's outputs with the port's spans off, on (under the
   profiler) and off again (``torch.equal`` on the bits; the training step's
   gradient, which ``index_add_``'s atomics make vary from run to run, is
   also compared off against off);
3. ``--rounds`` rounds of a spans-off and a spans-on window of ``--seconds``
   each, untraced, then under ``torch.profiler``: host ms a step, the
   counters a step; traced, ``busy_s`` (the union of the device's
   operations), the benchmark's spans' device ms a step as
   ``benchmark/trace.py`` reduces them (the port's ``sdf.*`` spans left
   out), the port's spans' inclusive device ms and launches a step
   (``profiling.span_device_times``) and the idle gaps labelled
   ``<benchmark span>/<innermost port span or ->/<host op>``, the port span
   taken on the thread that launched the operation ending the gap.

Prints one JSON line a cell and writes them all to ``--out``; the card's
name and power limit are in each line. Without CUDA it runs on the CPU
(no device operations, no sync warnings), which only checks that it runs.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import warnings
from collections import Counter, defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from benchmark import spec as spec_mod  # noqa: E402
from benchmark import trace as btrace  # noqa: E402
from benchmark.run import Context  # noqa: E402
from sdf_tools_tpu_torch import _build, profiling  # noqa: E402

BIG_STEP = 10**6  # step indices past every check sample the drivers keep
CUDA = torch.cuda.is_available()
TOP = 12


def _activities():
    return [torch.profiler.ProfilerActivity.CPU] + ([torch.profiler.ProfilerActivity.CUDA] if CUDA else [])


def _sync() -> None:
    if CUDA:
        torch.cuda.synchronize()


def _card() -> str:
    if not CUDA:
        return "cpu"
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True)
    return r.stdout.strip()


def _site(filename: str, lineno: int) -> str:
    try:
        return f"{Path(filename).resolve().relative_to(ROOT)}:{lineno}"
    except ValueError:
        return f"{filename}:{lineno}"


def census(drv, ctx, st, steps: int, i0: int) -> list:
    """Each step's synchronizing calls by site, beside its counters."""
    out = []
    for k in range(steps):
        _sync()
        profiling.reset_counts()
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            if CUDA:
                torch.cuda.set_sync_debug_mode("warn")
            try:
                drv.step(ctx, st, i0 + k)
                _sync()
            finally:
                if CUDA:
                    torch.cuda.set_sync_debug_mode("default")
        counts = dict(profiling.COUNTS)
        sites = Counter(_site(w.filename, w.lineno) for w in rec if "synchroniz" in str(w.message))
        port = sum(n for s, n in sites.items() if s.startswith("sdf_tools_tpu_torch/"))
        counted = sum(n for name, n in counts.items() if name.startswith("sync."))
        out.append({"warned_port": port, "warned_all": sum(sites.values()), "counted": counted,
                    "sites": dict(sorted(sites.items())), "counts": dict(sorted(counts.items()))})
    return out


def _same_bits(a, b) -> bool:
    if a.dtype.is_floating_point:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and bool(torch.equal(a, b))


def _outputs(kind, drv, ctx, st, i):
    """One step's output tensors (the training step from the same logits)."""
    if kind == "train":
        loss, new = st.step_fn(ctx, st, st.logits, st.next % len(st.rays))
        return {"loss": loss, "new_logits": new}
    drv.step(ctx, st, i)
    if kind == "render":
        _, depth, hit, _ = st.last
        return {"depth": depth, "hit": hit}
    _, _, values, dist, ok, grad, valid, _ = st.last
    return {"field": values, "dist": dist, "ok": ok, "grad": grad, "valid": valid}


def bitwise(kind, drv, ctx, st, i) -> dict:
    off = _outputs(kind, drv, ctx, st, i)
    prev = profiling.set_spans(True)
    try:
        with torch.profiler.profile(activities=_activities()):
            on = _outputs(kind, drv, ctx, st, i)
        _sync()
    finally:
        profiling.set_spans(prev)
    off2 = _outputs(kind, drv, ctx, st, i)
    out = {}
    for name in off:
        rec = {"on_off": _same_bits(on[name], off[name]), "off_off": _same_bits(off2[name], off[name])}
        if off[name].dtype.is_floating_point:
            rec["max_abs_on_off"] = float((on[name].double() - off[name].double()).abs().max())
            rec["max_abs_off_off"] = float((off2[name].double() - off[name].double()).abs().max())
        out[name] = rec
    return out


def _window(drv, ctx, st, i, seconds, traced):
    """Steps for ``seconds``; (steps, host s, events or None, launches, counts)."""
    launches0 = dict(_build.LAUNCHES)
    profiling.reset_counts()
    _sync()
    prof = None
    if traced:
        prof = torch.profiler.profile(activities=_activities())
        prof.__enter__()
        window = torch.profiler.record_function(btrace.WINDOW)
        window.__enter__()
    n, t0 = 0, time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        drv.step(ctx, st, i + n)
        n += 1
    host_s = time.perf_counter() - t0
    events = None
    if traced:
        window.__exit__(None, None, None)
        _sync()
        prof.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
    launches = {k: v - launches0.get(k, 0) for k, v in _build.LAUNCHES.items() if v != launches0.get(k, 0)}
    return n, host_s, events, launches, dict(profiling.COUNTS)


def idle_gaps(events) -> list:
    """The device's idle gaps in the window, summed by
    ``<benchmark span>/<innermost port span or ->/<host op>``."""
    window = next(e for e in events if e.get("cat") == "user_annotation" and e.get("name") == btrace.WINDOW)
    w0, w1, main = float(window["ts"]), float(window["ts"]) + float(window["dur"]), window.get("tid")
    trees = profiling.span_trees(events)
    bench_spans, host_ops, launches, dev = [], [], {}, []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, ts, te = e.get("cat"), float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))
        if cat == "user_annotation" and e["name"] != btrace.WINDOW and not e["name"].startswith(profiling.SPAN_PREFIX):
            bench_spans.append((ts, te, e["name"]))
        elif cat in profiling.LAUNCH_CATS:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launches[corr] = (ts, e.get("tid"))
            if e.get("tid") == main:
                host_ops.append((ts, te, e.get("name", "?")))
        elif cat == "cpu_op" and e.get("tid") == main:
            host_ops.append((ts, te, e.get("name", "?")))
        elif cat in profiling.DEVICE_CATS:
            dev.append((ts, te, (e.get("args") or {}).get("correlation")))
    dev.sort()
    bench_iv, host_iv = btrace._Intervals(bench_spans), btrace._Intervals(host_ops)
    gaps = defaultdict(float)
    t, k = w0, 0
    while k < len(dev) and t < w1:
        a, b, corr = dev[k]
        if a > t:
            gap_end = min(a, w1)
            launch = launches.get(corr)
            tree = trees.get(launch[1]) if launch is not None else None
            held = tree.holding(t) if tree is not None else []
            label = f"{bench_iv.innermost(t) or 'no span'}/{held[0] if held else '-'}/{host_iv.innermost(t) or 'python'}"
            gaps[label] += gap_end - t
        t = max(t, b)
        k += 1
    if t < w1:
        gaps[f"{bench_iv.innermost(t) or 'no span'}/-/{host_iv.innermost(t) or 'python'}"] += w1 - t
    return [[name[:160], us / 1e6] for name, us in sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]]


def rounds(drv, ctx, st, i, seconds, n_rounds) -> dict:
    out = {"untraced": {"off": [], "on": []}, "traced": {"off": [], "on": []}}
    for _ in range(n_rounds):
        for traced in (False, True):
            for on in (False, True):
                prev = profiling.set_spans(on)
                try:
                    n, host_s, events, launches, counts = _window(drv, ctx, st, i, seconds, traced)
                finally:
                    profiling.set_spans(prev)
                i += n
                rec = {"steps": n, "host_ms_a_step": 1e3 * host_s / n,
                       "counts_a_step": {k: v / n for k, v in sorted(counts.items())},
                       "launches_a_step": {k: v / n for k, v in sorted(launches.items())}}
                if traced:
                    summary = btrace.reduce_events([e for e in events
                                                    if not str(e.get("name", "")).startswith(profiling.SPAN_PREFIX)])
                    rec["busy_s"], rec["window_s"] = summary.busy_s, summary.window_s
                    rec["busy_ms_a_step"] = 1e3 * summary.busy_s / n
                    rec["bench_span_ms_a_step"] = {k: 1e3 * v / n for k, v in sorted(summary.span_s.items())}
                    if on:
                        rec["port_span_a_step"] = {
                            k: {"device_ms": 1e3 * v["device_s"] / n, "launches": v["launches"] / n}
                            for k, v in sorted(profiling.span_device_times(events).items())}
                        rec["idle_gaps"] = idle_gaps(events)
                    else:
                        rec["idle_gaps"] = summary.idle_gaps
                out["traced" if traced else "untraced"]["on" if on else "off"].append(rec)
    return out


def run_cell(name: str, seed: int, seconds: float, n_rounds: int, n_census: int) -> dict:
    sp = spec_mod.Spec(ROOT)
    cell = sp.cell(name)
    ctx = Context(cell, sp.config(cell), sp.traffic(cell), seed, torch.device("cuda" if CUDA else "cpu"),
                  btrace.Tracer(True))
    kind = ctx.traffic["driver"].split("_")[0]  # map, render, train
    drv = sp.driver(ctx.traffic["driver"])
    t0 = time.perf_counter()
    st = drv.setup(ctx)
    _sync()
    rec = {"cell": name, "seed": seed, "card": _card(), "torch": torch.__version__, "setup_s": time.perf_counter() - t0}
    rec["census"] = census(drv, ctx, st, n_census, BIG_STEP)
    rec["bitwise"] = bitwise(kind, drv, ctx, st, BIG_STEP)
    rec["rounds"] = rounds(drv, ctx, st, BIG_STEP + 100, seconds, n_rounds)
    del st
    if CUDA:
        torch.cuda.empty_cache()
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cells", default="")
    ap.add_argument("--seed", type=int, default=7300000001)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--census", type=int, default=3)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    cells = [c for c in args.cells.split(",") if c] or [w["name"] for w in spec_mod.Spec(ROOT).bench["workloads"]]
    recs = []
    for name in cells:
        rec = run_cell(name, args.seed, args.seconds, args.rounds, args.census)
        recs.append(rec)
        print(json.dumps(rec), flush=True)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps(recs, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
