"""``query_ms.cloud``: ``query_ms`` in the cloud map cell (device ms per
update under the span ``query``), moving that cell's own update rate."""
from benchmark.trace import span_ms


def read(rc):
    return span_ms(rc, "query")
