"""``render_ms.train``: device ms per training step of the forward render,
the kernels launched inside the span ``render``."""
from benchmark.trace import span_ms


def read(rc):
    return span_ms(rc, "render")
