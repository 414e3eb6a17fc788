"""The port's counterpart of ``scripts/bench_micro_gather3.py``: which 2-D
gather shapes cost what, each looped in one launch, measured on the card.

    python -m sdf_tools_tpu_torch.scripts.bench_micro_gather3 [--device cuda|cpu]

Each probe sums STEPS = 256 gathers ``take_along_axis(x, (q + i) % mod,
axis)`` with ``x = arange`` and ``q = (arange * 13) % mod`` in the index's
shape (the JAX script's one function, ``make``):
  H1-H3  along axis 0 of (8, 128), (64, 128), (512, 128), q x's shape
  H4-H5  along axis 1 of (8, 512), (8, 256)
  H6     along axis 1 of (8, 128) with q (8, 1)
  H7-H8  along axis 1 of (64, 128), (512, 128)

Each prints one line in the JAX script's order and naming (see
``bench_micro_gather``).
"""
from __future__ import annotations

from functools import partial

import numpy as np

from . import _micro

STEPS = 256
SRC = "scripts/bench_micro_gather3.py"


def make_inputs(shape_x, shape_idx, mod: int):
    """The inputs of the JAX script's ``make``."""
    x = np.arange(np.prod(shape_x), dtype=np.int32).reshape(shape_x)
    q = (np.arange(np.prod(shape_idx), dtype=np.int32).reshape(shape_idx) * 13) % mod
    return x, q


def make(key: str, label: str, shape_x, shape_idx, axis: int, mod: int, line: int, library=None) -> _micro.Probe:
    return _micro.gather(key, label, f"{SRC}:36 make (call :54), called at :{line}",
                         partial(make_inputs, shape_x, shape_idx, mod), axis=axis, steps=STEPS, mod=mod,
                         library=library)


# the JAX script's order
PROBES = (
    make("H1", "H1 x(8,128) idx(8,128) ax0", (8, 128), (8, 128), 0, 8, 75),
    make("H2", "H2 x(64,128) idx(64,128) ax0", (64, 128), (64, 128), 0, 64, 76),
    make("H3", "H3 x(512,128) idx(512,128) ax0", (512, 128), (512, 128), 0, 512, 77),
    make("H4", "H4 x(8,512) idx(8,512) ax1", (8, 512), (8, 512), 1, 512, 79),
    make("H5", "H5 x(8,256) idx(8,256) ax1", (8, 256), (8, 256), 1, 256, 80, library="sum"),
    make("H6", "H6 x(8,128) idx(8,1) ax1", (8, 128), (8, 1), 1, 128, 82),
    make("H7", "H7 x(64,128) idx(64,128) ax1", (64, 128), (64, 128), 1, 128, 84),
    make("H8", "H8 x(512,128) idx(512,128) ax1", (512, 128), (512, 128), 1, 128, 85),
)


def main(argv=None) -> dict:
    return _micro.main(PROBES, __doc__.split("\n\n")[0], argv)


if __name__ == "__main__":
    main()
