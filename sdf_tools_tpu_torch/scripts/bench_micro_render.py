"""The port's counterpart of ``scripts/bench_micro_render.py``: the
plane-sweep renderer's primitive step, the bilinear sample of a row of 128
rays from a (16, 256) band of a (512, 512) float32 plane at the row's own
base, measured on the card.

    python -m sdf_tools_tpu_torch.scripts.bench_micro_render [--device cuda|cpu]

Probe (``csrc/micro_render.cu``, ``micro_sampler``; one warp-group a ray
row, one thread a ray):
  row-step  (R1) ROWS = 128 ray rows x STEPS = 256 steps; each row-step
            samples its rays (y in [10, 410), z in [10, 310): a ray with
            z >= 255 past its base reads the clipped column 254, as the JAX
            probe does) and adds their sum to the step's chain, each step's
            chain to the total

It prints one line with its kernel's time (per row-step), bound and memory
on the card; on the CPU (``--device cpu``) the plain version runs and every
time reads "not measured".
"""
from __future__ import annotations

import functools

import numpy as np

from . import _micro, _sampler

ROWS = 128
STEPS = 256
SRC = "scripts/bench_micro_render.py"


@functools.cache
def inputs(rows: int = ROWS):
    """The script's plane and ray positions (drawn at ROWS rows), the
    first ``rows`` rows."""
    rng = np.random.default_rng(0)
    plane = rng.random((512, 512)).astype(np.float32)
    y = (10 + 400 * rng.random((ROWS, 128))).astype(np.float32)
    z = (10 + 300 * rng.random((ROWS, 128))).astype(np.float32)
    return plane, y[:rows], z[:rows]


def probe(rows: int = ROWS, steps: int = STEPS) -> _micro.Probe:
    return _sampler.sampler("R1", "row-step", f"{SRC}:33 kernel (call :72)", functools.partial(inputs, rows),
                            ("data", "y", "z"), "full", steps, rows, shapes=[(512, 512), (rows, 128), (rows, 128)])


def probes():
    return (probe(ROWS, STEPS),)


PROBES = probes()


def main(argv=None) -> dict:
    return _micro.main(probes(), __doc__.split("\n\n")[0], argv)


if __name__ == "__main__":
    main()
