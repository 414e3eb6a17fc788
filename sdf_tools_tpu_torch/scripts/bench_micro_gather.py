"""The port's counterpart of ``scripts/bench_micro_gather.py``: the probes
that decided the O(N) envelope kernel's design, measured on the card.

    python -m sdf_tools_tpu_torch.scripts.bench_micro_gather [--device cuda|cpu]

Probes (int32, N = 512; ``csrc/micro_gather.cu``):
  E1  out = x[q] along axis 0 of [N, 8, 128], q [1, 8, 128] (the
      lockstep-Meijster stack access)
  E1b the same 512 times in one launch at (q + i) % N, summed
  E2  the same along axis 1 of [8, N, 128]
  E3  a per-element select along the lanes of (8, 128)
  E4  the row scan o_i = min(o_{i-1} + 1, x_i) along axis 1 of [8, N, 128]
  E4b the same along axis 0 of [N, 8, 128]
  E5  64 one-hot masked-min selects from [64, 8, 128] (the gather fallback)
  E6  a one-hot write (the stack write) along axis 0 of [N, 8, 128]

Each prints one line in the JAX script's order and naming: its kernel's
time per launch at B = 1 (the TPU probe's call) and at B_fill instances
(4 blocks on every SM), per step and per instance-element-step, its bound
and the memory it reads, on the card; on the CPU (``--device cpu``) the
plain versions run and every time reads "not measured".
"""
from __future__ import annotations

import numpy as np

from . import _micro

N = 512
SRC = "scripts/bench_micro_gather.py"


def _arange(*shape) -> np.ndarray:
    return np.arange(np.prod(shape), dtype=np.int32).reshape(shape)


def e1_inputs():
    return _arange(N, 8, 128), np.ones((1, 8, 128), np.int32) * 77


def e1b_inputs():
    return _arange(N, 8, 128), np.ones((1, 8, 128), np.int32) * 3


def e2_inputs():
    return _arange(8, N, 128), np.ones((8, 1, 128), np.int32) * 77


def e3_inputs():
    return _arange(8, 128), (_arange(8, 128) * 7) % 128


def e4_inputs():
    return (_arange(8, N, 128),)


def e4b_inputs():
    return (_arange(N, 8, 128),)


def e5_inputs():
    return _arange(64, 8, 128), np.ones((1, 8, 128), np.int32) * 7


def e6_inputs():
    return _arange(N, 8, 128), np.ones((1, 8, 128), np.int32) * 77, np.ones((1, 8, 128), np.int32)


E1 = _micro.gather("E1", "E1 major-gather [N,8,128] axis=0", f"{SRC}:52 e1 (call :60)", e1_inputs, axis=0,
                   out_shape=(8, 128), library="gather")
E1B = _micro.gather("E1b", "E1b 512x major-gather in fori", f"{SRC}:74 e1b (call :87)", e1b_inputs, axis=0,
                    steps=512, mod=N, out_shape=(8, 128), library="sum")
E2 = _micro.gather("E2", "E2 sublane-gather [8,N,128] axis=1", f"{SRC}:101 e2 (call :109)", e2_inputs, axis=1,
                   out_shape=(8, 128), library="gather")
E3 = _micro.gather("E3", "E3 lane-select (8,128)", f"{SRC}:123 e3 (call :131)", e3_inputs, axis=1,
                   library="gather")
E4 = _micro.row_scan("E4", "E4 row-scan [8,N,128] 512 steps", f"{SRC}:145 e4 (call :157)", e4_inputs, axis=1)
E4B = _micro.row_scan("E4b", "E4b row-scan [N,8,128] 512 steps", f"{SRC}:170 e4b (call :182)", e4b_inputs, axis=0)
E5 = _micro.onehot_min("E5", "E5 64x one-hot min-select D=64", f"{SRC}:195 e5 (call :211)", e5_inputs, steps=64)
E6 = _micro.onehot_write("E6", "E6 one-hot scatter [N,8,128]", f"{SRC}:225 e6 (call :235)", e6_inputs,
                         library=True)

# the JAX script's order
PROBES = (E3, E2, E1, E1B, E4, E4B, E5, E6)


def main(argv=None) -> dict:
    return _micro.main(PROBES, __doc__.split("\n\n")[0], argv)


if __name__ == "__main__":
    main()
