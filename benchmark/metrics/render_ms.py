"""``render_ms``: device ms per render call, the kernels launched inside the
span ``render`` (``render_depth``: the plane sweep's precompute, K8, the
verification tail and the march fallback)."""
from benchmark.trace import span_ms


def read(rc):
    return span_ms(rc, "render")
