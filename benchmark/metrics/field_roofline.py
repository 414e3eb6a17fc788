"""``field_roofline``: the signed field's share of its roofline, in %: the
least time the work needs (each mask cell read once, 1 B, and each float32
distance written once, 4 B, at the H100's published 3.35 TB/s;
``benchmark/work.py``) over the device time per update under the span
``field``. The count is of the work, not of what today's kernels move."""
from benchmark import work
from benchmark.trace import span_ms


def read(rc):
    ms = span_ms(rc, "field")
    if ms is None:
        return None
    n = rc.config["grid"]
    return 100.0 * work.field_bound_s((n, n, n)) * 1e3 / ms
