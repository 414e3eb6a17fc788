"""The device's idle share: 1 - (the union of the device operations'
intervals a step, in the traced end of the window) / (the host's seconds a
step before the profiler started), so that the profiler's slowing of the
host's launches is not read as idle time (``benchmark/trace.py``)."""
from benchmark.trace import idle_share


def read(rc):
    return idle_share(rc)
