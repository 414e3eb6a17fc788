"""The yardstick's arithmetic: the card's published peaks and the work a
call needs, counted from its shapes, whatever the implementation does.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, at the full
700 W power limit): 3.35 TB/s of HBM3 and 67 TFLOP/s of float32 outside the
tensor cores. A share of a roofline is stated against these, with the
card's power limit beside it in the result's ``device``.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12

MASK_BYTES = 1  # a bool cell of the occupancy mask, read once
FIELD_BYTES = 4  # a float32 cell of the signed field, written once


def field_bytes(shape) -> int:
    """The signed field's least traffic: each mask cell read once (1 B) and
    each float32 distance written once (4 B)."""
    cells = 1
    for s in shape:
        cells *= int(s)
    return (MASK_BYTES + FIELD_BYTES) * cells


def field_bound_s(shape) -> float:
    """The least time the card could take for the field: its bytes at the
    peak memory rate (its arithmetic is far below the compute bound)."""
    return field_bytes(shape) / HBM_BYTES_PER_S
