"""The port's counterpart of ``scripts/bench_micro_render3.py``: which
flavour of the dynamic band load costs what, measured on the card.

    python -m sdf_tools_tpu_torch.scripts.bench_micro_render3 [--device cuda|cpu]

Variants (``csrc/micro_render.cu``, ``micro_band_sum``), each over ROWS =
128 ray rows x STEPS = 128 steps of a (512, 512) float32 plane (y in
[10, 410), z in [10, 210)), the row's band summed and chained:
  scalars   no band: the row's y then z base, as floats
  static    the (16, 256) band at (0, 0), the y base added to each element
  smalldyn  the (8, 128) band at the row's base
  dyn2d     the (16, 256) band at the row's base
  dynrow    the 16 rows at the row's y base, all 512 lanes
  dyncol    rows 0:16 at the row's z base
  dynrot    the 16 rows at the y base rolled by +zbase modulo 512 (lane j
            reads lane (j - zbase) mod 512, `jnp.roll`'s direction, as the
            JAX probe in interpret mode), lanes 0:256; on these inputs
            every zbase is 0, so it equals dyn2d
  unroll8   dyn2d with the row loop unrolled by 8 (``make_unroll_kernel``):
            the same adds in the same order, so it equals dyn2d

Each prints one line in the JAX script's order and naming (see
``bench_micro_render``).
"""
from __future__ import annotations

import functools

import numpy as np

from . import _micro, _sampler
from ._sampler import BandSum

ROWS = 128
STEPS = 128
SRC = "scripts/bench_micro_render3.py"
VARIANTS = ("scalars", "static", "smalldyn", "dyn2d", "dynrow", "dyncol", "dynrot", "unroll8")
SPECS = {
    "scalars": BandSum("rays", extra="y,z"),
    "static": BandSum("rays", 16, 256, row_base=False, cols="zero", add_y=True),
    "smalldyn": BandSum("rays", 8, 128),
    "dyn2d": BandSum("rays", 16, 256),
    "dynrow": BandSum("rays", 16, 512, cols="zero"),
    "dyncol": BandSum("rays", 16, 256, row_base=False),
    "dynrot": BandSum("rays", 16, 256, cols="roll"),
    "unroll8": BandSum("rays", 16, 256),
}


@functools.cache
def inputs(rows: int = ROWS):
    """The script's plane and ray positions (drawn at ROWS rows; z in
    [10, 210)), the first ``rows`` rows."""
    rng = np.random.default_rng(0)
    plane = rng.random((512, 512)).astype(np.float32)
    y = (10 + 400 * rng.random((ROWS, 128))).astype(np.float32)
    z = (10 + 200 * rng.random((ROWS, 128))).astype(np.float32)
    return plane, y[:rows], z[:rows]


def probe(variant: str, rows: int = ROWS, steps: int = STEPS, build=None) -> _micro.Probe:
    where = f"{SRC}:67 make_unroll_kernel (call :96)" if variant == "unroll8" else f"{SRC}:22 make_kernel (call :96)"
    return _sampler.band_sum(f"R3-{variant}", variant, where, build or functools.partial(inputs, rows),
                             ("data", "y", "z"), SPECS[variant], steps, rows,
                             shapes=[(512, 512), (rows, 128), (rows, 128)])


def probes():
    return tuple(probe(v, ROWS, STEPS) for v in VARIANTS)


PROBES = probes()


def main(argv=None) -> dict:
    return _micro.main(probes(), __doc__.split("\n\n")[0], argv)


if __name__ == "__main__":
    main()
