"""``ft_field_ms.train``: device ms per training step of the occupancy's
signed field with its feature transform (``sigmoid`` and
``sdf_from_occupancy_ft``'s forward: the line seeds and K6), the kernels
launched inside the span ``ft_field``."""
from benchmark.trace import span_ms


def read(rc):
    return span_ms(rc, "ft_field")
