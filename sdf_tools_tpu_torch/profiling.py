"""Profiling and timing helpers (counterpart of ``sdf_tools_tpu/profiling.py``).

``trace`` records a ``torch.profiler`` trace (the host's ops, and the
card's kernels where CUDA is available) and writes it as a Chrome trace
that ``chrome://tracing`` or Perfetto opens. ``timed`` and ``StageTimer``
wait for the card before they read the clock; on the CPU there is nothing
to wait for.

Inside the port, ``span(name)`` marks a stage at a layer's boundary as the
profiler span ``sdf.<name>``. Spans are off, at the cost of one flag check,
until ``set_spans(True)`` switches them on (``trace`` does, for its block).
``count(name, n)`` adds to ``COUNTS``, host-side integers kept always (an
integer add, never a read of the device): ``sync.<layer>.<site>`` counts
each place passed where, on a CUDA device, the host waits for the card (a
boolean-mask gather, a ``bool`` of a device value, ``nonzero``, a copy of
host data to the device), and ``render.march_rays`` the rays the plane
sweep hands to the exact march. ``reset_counts`` clears them.
``span_device_times`` reads a trace's spans: the device time and the
launches of the operations launched inside each.
"""
from __future__ import annotations

import bisect
import contextlib
import json
import os
import time
from typing import Any, Callable, Dict

import torch

SPAN_PREFIX = "sdf."
COUNTS: Dict[str, int] = {}
_spans_on = False
_OFF = contextlib.nullcontext()


def set_spans(on: bool) -> bool:
    """Switch the port's spans on or off; returns the previous setting."""
    global _spans_on
    prev, _spans_on = _spans_on, bool(on)
    return prev


def span(name: str):
    """The profiler span ``sdf.<name>`` around a block while spans are on
    (``torch.profiler.record_function``: its ends sit on the profiler's
    clock, beside the device operations launched inside it), else a shared
    no-op context."""
    if not _spans_on:
        return _OFF
    return torch.profiler.record_function(SPAN_PREFIX + name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to ``COUNTS[name]``."""
    COUNTS[name] = COUNTS.get(name, 0) + n


def count_host_copy(name: str, x, device) -> None:
    """Count ``sync.<name>`` where ``torch.as_tensor(x, device=device)``
    copies host data to a CUDA device: ``x`` is no tensor (a Python number
    or sequence, a numpy array; counted on every device), or a CPU tensor
    and ``device`` is not the CPU."""
    if not isinstance(x, torch.Tensor) or (x.device.type == "cpu" and torch.device(device).type != "cpu"):
        count("sync." + name)


def reset_counts() -> None:
    COUNTS.clear()


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")  # a Chrome trace's device operations
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")  # and the host calls that launch them


class SpanTree:
    """The ``sdf.*`` spans of one host thread (properly nested), for the
    question which of them hold a time: ``holding(t)``, innermost first."""

    def __init__(self, spans):
        self.spans = sorted(spans, key=lambda s: (s[0], -s[1]))  # (start, end, name)
        self.starts = [s[0] for s in self.spans]
        self.parent, stack = [], []
        for i, (a, b, _) in enumerate(self.spans):
            while stack and self.spans[stack[-1]][1] <= a:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(i)

    def holding(self, t: float) -> list:
        # the latest span to start by t, or the nearest of its ancestors, is
        # the innermost that holds t (a span that holds t and started earlier
        # holds that one's start too, so it is an ancestor)
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and not t < self.spans[i][1]:
            i = self.parent[i]
        out = []
        while i >= 0:
            out.append(self.spans[i][2])
            i = self.parent[i]
        return out


def span_trees(events) -> Dict[Any, SpanTree]:
    """Thread id -> ``SpanTree`` of the ``sdf.*`` spans of Chrome-trace
    ``events``."""
    by_tid: Dict[Any, list] = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation" and str(e.get("name", "")).startswith(SPAN_PREFIX):
            ts = float(e["ts"])
            by_tid.setdefault(e.get("tid"), []).append((ts, ts + float(e.get("dur", 0.0)), e["name"]))
    return {tid: SpanTree(spans) for tid, spans in by_tid.items()}


def span_device_times(events) -> Dict[str, Dict[str, float]]:
    """``sdf.*`` span name -> ``{"device_s", "launches"}`` of Chrome-trace
    ``events`` (``trace.json``'s ``traceEvents``): the summed seconds and
    the count of the device operations launched inside the span, nested
    spans included. A launch lies inside a span when the span holds it on
    the launching thread (autograd runs a backward on a thread of its
    own); an operation whose launch is not in the trace counts nowhere."""
    trees = span_trees(events)
    launches, device = {}, []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        if cat in LAUNCH_CATS:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launches[corr] = (float(e["ts"]), e.get("tid"))
        elif cat in DEVICE_CATS:
            device.append((float(e.get("dur", 0.0)), (e.get("args") or {}).get("correlation")))
    out: Dict[str, Dict[str, float]] = {}
    for dur, corr in device:
        launch = launches.get(corr)
        tree = trees.get(launch[1]) if launch is not None else None
        if tree is None:
            continue
        for name in set(tree.holding(launch[0])):
            rec = out.setdefault(name, {"device_s": 0.0, "launches": 0})
            rec["device_s"] += dur / 1e6
            rec["launches"] += 1
    return out


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block with the port's spans on and write
    ``<log_dir>/trace.json`` (Chrome trace format); yields the
    ``torch.profiler.profile`` object."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prev = set_spans(True)
    try:
        with torch.profiler.profile(activities=activities) as prof:
            yield prof
    finally:
        set_spans(prev)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _devices(out: Any) -> set:
    """The CUDA devices of the tensors in ``out`` (nested tuples, lists and
    dicts; a ``torch.device`` stands for itself), which a timer must wait
    for."""
    if isinstance(out, torch.Tensor):
        out = out.device
    if isinstance(out, torch.device):
        return {out} if out.type == "cuda" else set()
    if isinstance(out, (tuple, list)):
        return set().union(*map(_devices, out)) if out else set()
    if isinstance(out, dict):
        return _devices(list(out.values()))
    return set()


def synchronize(out: Any) -> None:
    """Synchronize each CUDA device that ``out``'s tensors lie on; nothing
    for CPU tensors or other values."""
    for device in _devices(out):
        torch.cuda.synchronize(device)


def timed(fn: Callable, *args, repeats: int = 5, warmup: int = 1, **kwargs):
    """Median wall time of ``fn(*args, **kwargs)``, each run ended by a
    synchronize of its output's devices. Returns (median_seconds, last_output)."""
    out = None
    for _ in range(max(warmup, 1)):
        out = fn(*args, **kwargs)
        synchronize(out)
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        synchronize(out)
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2], out


class StageTimer:
    """Accumulates named stage timings; ``report`` gives a one-line JSON."""

    def __init__(self):
        self.stages: Dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str, sync: Any = None):
        """Time the block; before the clock is read, the devices of ``sync``
        (a tensor or a device, or a nested tuple, list or dict of them) are
        synchronized: all the block's work on them, whatever it created,
        is then done."""
        t0 = time.perf_counter()
        yield
        synchronize(sync)
        self.stages[name] = self.stages.get(name, 0.0) + time.perf_counter() - t0

    def report(self) -> str:
        return json.dumps({k: round(v, 4) for k, v in self.stages.items()})
