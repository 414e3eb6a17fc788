"""``field_ms.cloud``: ``field_ms`` in the cloud map cell (device ms per
update under the span ``field``), moving that cell's own update rate."""
from benchmark.trace import span_ms


def read(rc):
    return span_ms(rc, "field")
