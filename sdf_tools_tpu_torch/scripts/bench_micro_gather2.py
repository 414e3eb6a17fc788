"""The port's counterpart of ``scripts/bench_micro_gather2.py``: gather and
one-hot costs for the Meijster kernel, each looped in one launch, measured
on the card.

    python -m sdf_tools_tpu_torch.scripts.bench_micro_gather2 [--device cuda|cpu]

Probes (int32, N = STEPS = 512; ``csrc/micro_gather.cu``):
  G1  x (N, 128) gathered along axis 0 at (q + i) % N, q (8, 128), summed
  G2  the same with q (1, 128)
  G3  x (8, 128) gathered along the lanes at (q + i) % 128
  G4  one-hot select from (64, 128) at (q + i) % 64, summed
  G5  one-hot write of i into a (64, 128) scratch at (q + i) % 64; row 0
  G6  the row scan o_i = min(o_{i-1} + 1, x_i) over (N, 128)
  G7  the same over (N, 8, 128)
  G8  acc = min(2 acc + 1, x + i) on (8, 128): the baseline op cost

Each prints one line in the JAX script's order and naming, its time per
step beside its time per launch (see ``bench_micro_gather``).
"""
from __future__ import annotations

import numpy as np

from . import _micro

STEPS = 512
N = 512
D = 64
SRC = "scripts/bench_micro_gather2.py"


def _arange(*shape) -> np.ndarray:
    return np.arange(np.prod(shape), dtype=np.int32).reshape(shape)


def g1_inputs():
    return _arange(N, 128), (_arange(8, 128) * 13) % N


def g2_inputs():
    return _arange(N, 128), (_arange(1, 128) * 13) % N


def g3_inputs():
    return _arange(8, 128), (_arange(8, 128) * 13) % 128


def g4_inputs():
    return _arange(D, 128), (_arange(1, 128) * 13) % D


def g5_inputs():
    return _arange(D, 128), (_arange(1, 128) * 13) % D


def g6_inputs():
    return (_arange(N, 128),)


def g7_inputs():
    return (_arange(N, 8, 128),)


def g8_inputs():
    return (_arange(8, 128),)


G1 = _micro.gather("G1", "G1 gather (512,128)ax0 idx(8,128)", f"{SRC}:41 g1 (call :55)", g1_inputs, axis=0,
                   steps=STEPS, mod=N, library="sum")
G2 = _micro.gather("G2", "G2 gather (512,128)ax0 idx(1,128)", f"{SRC}:67 g2 (call :81)", g2_inputs, axis=0,
                   steps=STEPS, mod=N, out_shape=(128,), library="sum")
G3 = _micro.gather("G3", "G3 gather (8,128)ax1 idx(8,128)", f"{SRC}:93 g3 (call :107)", g3_inputs, axis=1,
                   steps=STEPS, mod=128)
G4 = _micro.onehot_min("G4", "G4 one-hot select (64,128)", f"{SRC}:119 g4 (call :138)", g4_inputs, steps=STEPS,
                       mod=D)
G5 = _micro.onehot_write("G5", "G5 one-hot write (64,128)", f"{SRC}:150 g5 (call :169)", g5_inputs, steps=STEPS,
                         mod=D, first_row=True)
G6 = _micro.row_scan("G6", "G6 dyn row store (512,128)", f"{SRC}:182 g6 (call :195)", g6_inputs, axis=0)
G7 = _micro.row_scan("G7", "G7 row scan (512,8,128)", f"{SRC}:206 g7 (call :219)", g7_inputs, axis=0)
G8 = _micro.ops("G8", "G8 baseline 2 vec ops (8,128)", f"{SRC}:230 g8 (call :242)", g8_inputs, steps=STEPS)

# the JAX script's order
PROBES = (G8, G1, G2, G3, G4, G5, G6, G7)


def main(argv=None) -> dict:
    return _micro.main(PROBES, __doc__.split("\n\n")[0], argv)


if __name__ == "__main__":
    main()
