"""``query_ms``: device ms per map update of the queries, the kernels
launched inside the span ``query`` (``estimate_distance`` and ``gradient``)."""
from benchmark.trace import span_ms


def read(rc):
    return span_ms(rc, "query")
