"""The traced window and its reduction to per-layer numbers.

A ``--trace 1`` run opens ``torch.profiler`` (CPU and CUDA activities) near
the end of the measured window: at the first step that starts after
``seconds - TRACE_SECONDS``, for ``TRACE_SECONDS`` from the moment its
start has returned (past ``seconds`` if need be). The steps before it run
untraced and give the host's time a step: the profiler slows the host's
launches while it runs, and on the card after it has stopped too. The
trace, written out and read back, stays a few hundred thousand device
operations. The drivers open a ``record_function`` span around
each call into a layer of the program (``Tracer.span``); in an untraced
run a span is a no-op. After the window the profiler's trace is written to
a temporary file (under ``TMPDIR``), read back and deleted:

* a span's device time is the summed duration of the device operations
  (kernels, copies, fills) whose launch, on the host, falls inside it;
* ``busy_s`` is the union of all device operations' intervals inside the
  window (one stream: the sum of their durations, as ``chip_smoke.py``'s
  ``device_profile`` counts it), ``window_s`` the window's length; the
  idle share a per-layer metric reports sets the busy time a step against
  the host's time a step before the profiler started (``idle_share``);
* the breakdown: the device operations that took most time, and the idle
  gaps of the device summed by what the host was in at the gap's start (the
  benchmark's span and the innermost operation of the host's thread).
"""
from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
from collections import defaultdict

import torch

TRACE_SECONDS = 5.0  # the traced end of a --trace 1 run's window (its trace is read back whole)
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
WINDOW = "bench.window"
TOP = 10


class Tracer:
    """Spans for the drivers; with ``enabled`` the profiler over the last
    ``TRACE_SECONDS`` of the window (``start``, ``stop``), spans no-ops after."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.prof = None
        self._window = None

    def span(self, name: str):
        return torch.profiler.record_function(name) if self.enabled else contextlib.nullcontext()

    @property
    def active(self) -> bool:
        return self._window is not None

    def start(self) -> None:
        if not self.enabled:
            return
        from torch.profiler import ProfilerActivity, profile

        cuda = torch.cuda.is_available()
        self.prof = profile(activities=[ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else []))
        self.prof.__enter__()
        self._window = torch.profiler.record_function(WINDOW)
        self._window.__enter__()

    def stop(self) -> None:
        if self._window is None:
            return
        self._window.__exit__(None, None, None)
        self._window = None
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)
        self.enabled = False

    def summary(self) -> "TraceSummary":
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        self.prof = None
        return reduce_events(events)


class TraceSummary:
    def __init__(self, span_s, busy_s, window_s, device_ops, idle_gaps, unmatched_s, n_device_ops):
        self.span_s = span_s  # span name -> device seconds launched inside it
        self.busy_s = busy_s
        self.window_s = window_s
        self.device_ops = device_ops  # [[name, seconds]], most first
        self.idle_gaps = idle_gaps  # [[host label, seconds]], most first
        self.unmatched_s = unmatched_s  # device seconds whose launch was not found
        self.n_device_ops = n_device_ops


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class _Intervals:
    """Host intervals (start, end, name) of one kind, for 'which holds t'."""

    def __init__(self, items):
        self.items = sorted(items)
        self.starts = [s for s, _, _ in self.items]

    def innermost(self, t: float, back: int = 64):
        """The latest-starting interval that holds ``t``, or None."""
        i = bisect.bisect_right(self.starts, t) - 1
        stop = max(-1, i - back)
        while i > stop:
            s, e, name = self.items[i]
            if s <= t < e:
                return name
            i -= 1
        return None


def reduce_events(events) -> TraceSummary:
    window = [e for e in events if e.get("cat") == "user_annotation" and e.get("name") == WINDOW]
    if not window:
        raise RuntimeError("the trace holds no window span")
    w0 = float(window[0]["ts"])
    w1 = w0 + float(window[0]["dur"])
    main_tid = window[0].get("tid")

    launches = {}
    spans, host_ops = [], []
    dev = []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        if cat in DEVICE_CATS:
            ts = float(e["ts"])
            dev.append((ts, ts + float(e.get("dur", 0.0)), e.get("name", "?"), (e.get("args") or {}).get("correlation")))
        elif cat in LAUNCH_CATS:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launches[corr] = float(e["ts"])
            if e.get("tid") == main_tid:
                host_ops.append((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e.get("name", "?")))
        elif cat == "user_annotation" and e.get("name") != WINDOW:
            spans.append((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e["name"]))
        elif cat == "cpu_op" and e.get("tid") == main_tid:
            host_ops.append((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e.get("name", "?")))

    span_iv = _Intervals(spans)
    span_us = defaultdict(float)
    by_name = defaultdict(float)
    unmatched = 0.0
    inside = []
    for a, b, name, corr in dev:
        a_c, b_c = max(a, w0), min(b, w1)
        if b_c > a_c:
            inside.append((a_c, b_c))
        by_name[name] += b - a
        launch = launches.get(corr)
        if launch is None:
            unmatched += b - a
            continue
        s = span_iv.innermost(launch)
        if s is not None:
            span_us[s] += b - a

    busy = _merge(inside)
    busy_us = sum(b - a for a, b in busy)
    host_iv = _Intervals(host_ops)
    gaps = defaultdict(float)
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    for k in range(0, len(edges), 2):
        a, b = edges[k], edges[k + 1]
        if b <= a:
            continue
        label = f"{span_iv.innermost(a) or 'no span'}/{host_iv.innermost(a) or 'python'}"
        gaps[label] += b - a

    def top(d):
        return [[name[:120], us / 1e6] for name, us in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]

    return TraceSummary(
        span_s={k: v / 1e6 for k, v in span_us.items()},
        busy_s=busy_us / 1e6,
        window_s=(w1 - w0) / 1e6,
        device_ops=top(by_name),
        idle_gaps=top(gaps),
        unmatched_s=unmatched / 1e6,
        n_device_ops=len(dev),
    )


def span_ms(rc, span: str):
    """Device milliseconds per window step launched inside ``span``, or None
    where the trace holds none (the reader then reports nothing)."""
    s = rc.trace.span_s.get(span)
    return None if not s else 1e3 * s / rc.steps


def idle_share(rc):
    """1 - busy / wall a step: the device's busy seconds a step in the traced
    end of the window over the host's seconds a step before the profiler
    started. The profiler slows the host's launches, not the device's
    operations, so the busy time is read under it and the wall time without
    it; None where the window had no untraced steps."""
    if rc.trace.busy_s <= 0 or rc.steps <= 0 or rc.untraced_steps <= 0 or rc.untraced_s <= 0:
        return None
    return 1.0 - (rc.trace.busy_s / rc.steps) / (rc.untraced_s / rc.untraced_steps)
