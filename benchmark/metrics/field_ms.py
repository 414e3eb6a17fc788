"""``field_ms``: device ms per map update of the signed field, the kernels
launched inside the span ``field`` (``extract_signed_distance_field``: K1,
K2, K3 and the field's extrema)."""
from benchmark.trace import span_ms


def read(rc):
    return span_ms(rc, "field")
