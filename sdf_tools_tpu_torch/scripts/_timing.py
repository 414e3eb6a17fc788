"""Timing for the measurement programs: each call between two device
synchronizations on the host's clock (on the CPU the clock alone), the
first call of a process kept apart from the repeats after it; and CUDA-event
timing on the card, of calls back to back (``cuda_timed``) or of the device
alone (``device_ms``)."""
from __future__ import annotations

import functools
import time

import numpy as np
import torch


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def seconds(fn, device: torch.device):
    """(result, seconds) of one call of ``fn``: the device synchronized
    before and after, the host's clock around it."""
    sync(device)
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    return out, time.perf_counter() - t0


def measure(fn, device: torch.device, repeats: int):
    """(result of the last call, timing): ``fn`` once, timed apart as
    ``first``, then ``repeats`` timed calls, their ``median``, ``min``,
    ``max`` and the ``runs`` in order (seconds)."""
    out, first = seconds(fn, device)
    runs = []
    for _ in range(repeats):
        del out
        out, t = seconds(fn, device)
        runs.append(t)
    return out, {"first": first, "median": float(np.median(runs)), "min": min(runs), "max": max(runs), "runs": runs}


def rel_spread(t: dict) -> float:
    """(max - min) / median of a ``measure`` timing."""
    return (t["max"] - t["min"]) / t["median"]


# ---- CUDA-event timing --------------------------------------------------------

QUEUED_CALLS = 20  # calls that device_ms queues behind a sleeping kernel
SLEEP_MARGINS = (4, 16, 64)  # the sleep against the calls' enqueueing, tried in turn
LONG_CALL_MS = 5.0  # a call at least this long is timed over LONG_CALLS calls back to back, without the sleep
LONG_CALLS = 2


def cuda_timed(fn, reps: int = 1):
    """(result of the last call, CUDA-event ms per call) of ``reps`` calls of
    ``fn`` back to back on the current stream: the device's time from the
    first call's start to the last one's end, which for a short kernel is
    its wrapper's launch path on the host."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    stop.record()
    stop.synchronize()
    return out, start.elapsed_time(stop) / reps


@functools.cache
def _sleep_cycles_per_ms(device: torch.device) -> float:
    cycles = 1 << 20
    torch.cuda._sleep(cycles)
    return cycles / cuda_timed(lambda: torch.cuda._sleep(cycles))[1]


def device_ms(fn, device: torch.device) -> float:
    """ms per call of ``fn`` on the device alone: QUEUED_CALLS calls queued
    behind a sleeping kernel that outlasts their enqueueing, so that the
    events around them time the kernels back to back, free of the host's
    launch path. The sleep is SLEEP_MARGINS times the calls' enqueueing
    measured before, the next margin if the host took longer than the
    sleep; raises if it always did. A call of LONG_CALL_MS or more (the
    first, timed apart, which also warms it) needs no sleep: the host
    enqueues the next call while the device runs one, so CUDA events around
    LONG_CALLS calls back to back time the device alone."""
    if cuda_timed(fn)[1] >= LONG_CALL_MS:
        return cuda_timed(fn, LONG_CALLS)[1]
    sync(device)
    t0 = time.perf_counter()
    for _ in range(QUEUED_CALLS):
        fn()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    sync(device)
    for margin in SLEEP_MARGINS:
        sleep_ms = margin * enqueue_ms
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(sleep_ms * _sleep_cycles_per_ms(device)))
        t0 = time.perf_counter()
        start.record()
        for _ in range(QUEUED_CALLS):
            fn()
        stop.record()
        queued_ms = (time.perf_counter() - t0) * 1e3
        stop.synchronize()
        if queued_ms < sleep_ms:
            return start.elapsed_time(stop) / QUEUED_CALLS
    raise RuntimeError(f"device_ms: enqueueing {QUEUED_CALLS} calls outlasted a sleep of {SLEEP_MARGINS[-1]} times"
                       f" its measured {enqueue_ms:.3f} ms")
