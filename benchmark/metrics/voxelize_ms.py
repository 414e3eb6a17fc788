"""``voxelize_ms``: device ms per map update of the front end, the kernels
launched inside the span ``voxelize`` (``voxelize_points`` and the mask)."""
from benchmark.trace import span_ms


def read(rc):
    return span_ms(rc, "voxelize")
