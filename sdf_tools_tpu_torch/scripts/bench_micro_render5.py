"""The port's counterpart of ``scripts/bench_micro_render5.py``: the
sampler's primitives one at a time, each a chain of ``iters`` iterations
whose band bases come from (32768,) int32 tables, measured on the card.

    python -m sdf_tools_tpu_torch.scripts.bench_micro_render5 [--device cuda|cpu]

Each variant is timed on the device at ITERS_LO and ITERS_HI iterations;
its line gives both and the slope between them, ns an iteration (the
JAX script's own number; it timed a slope because of a host fetch on its
device, which the port does not have). Variants (``csrc/micro_render.cu``):
  fori       (micro_band_sum) the loop alone, adding 1.0
  smem       (micro_band_sum) two table reads: the y and z bases
  load_s     (micro_band_sum) the static (24, 256) band of the (512, 512)
             plane, summed, then the bases
  load_d0    (micro_band_sum) the (3, 8, 512) block of the (64, 8, 512) cube
             at the y base / 8, summed, then the z base
  load_dsub  (micro_band_sum) the plane's 24 rows at the y base, summed,
             then the z base
  load_d2d   (micro_band_sum) the plane's (24, 256) band at the bases
  sample     (micro_sampler) load_d0's block as (24, 512), then the sampler
             of ray row i & 127 over its 512 lanes

Each prints one line in the JAX script's order and naming (see
``bench_micro_render``).
"""
from __future__ import annotations

import functools

import numpy as np

from . import _micro, _sampler
from ._sampler import BandSum

ITERS_LO = 4096
ITERS_HI = 32768
TABLE = 32768  # the tables' entries (the script's ITERS_HI, which its main draws)
SRC = "scripts/bench_micro_render5.py"
REPLACES = f"{SRC}:46 make_kernel (call :100)"
VARIANTS = ("fori", "smem", "load_s", "load_d0", "load_dsub", "load_d2d", "sample")
SPECS = {
    "fori": (BandSum(None, extra="one"), "plane"),
    "smem": (BandSum("table", extra="y+z"), "plane"),
    "load_s": (BandSum("table", 24, 256, row_base=False, cols="zero", extra="y+z"), "plane"),
    "load_d0": (BandSum("table", 24, 512, cols="zero", extra="z"), "cube"),
    "load_dsub": (BandSum("table", 24, 512, cols="zero", extra="z"), "plane"),
    "load_d2d": (BandSum("table", 24, 256), "plane"),
}
ROLES = ("ytab", "ztab", "plane", "cube", "y", "z")
SHAPES = [(TABLE,), (TABLE,), (512, 512), (64, 8, 512), (128, 128), (128, 128)]


@functools.cache
def inputs():
    """The script's tables, plane, cube and rays, drawn as it draws them."""
    rng = np.random.default_rng(0)
    plane = rng.random((512, 512)).astype(np.float32)
    cube = rng.random((64, 8, 512)).astype(np.float32)
    y = (10 + 400 * rng.random((128, 128))).astype(np.float32)
    z = (10 + 200 * rng.random((128, 128))).astype(np.float32)
    ytab = rng.integers(0, 512 - 32, TABLE).astype(np.int32)
    ztab = rng.integers(0, 512 - 256, TABLE).astype(np.int32)
    return ytab, ztab, plane, cube, y, z


def probe(variant: str, iters: int = ITERS_HI, lo: int | None = ITERS_LO, build=inputs) -> _micro.Probe:
    low = probe(variant, lo, None, build) if lo else None
    shapes = [tuple(a.shape) for a in build()] if build is not inputs else SHAPES
    if variant == "sample":
        return _sampler.sampler("R5-sample", "sample", REPLACES, build, ROLES, "sample512", 1, iters,
                                data_role="cube", unit="iteration", shapes=shapes, lo=low)
    spec, data = SPECS[variant]
    return _sampler.band_sum(f"R5-{variant}", variant, REPLACES, build, ROLES, spec, 1, iters, data_role=data,
                             unit="iteration", shapes=shapes, lo=low)


def probes():
    return tuple(probe(v, ITERS_HI, ITERS_LO) for v in VARIANTS)


PROBES = probes()


def main(argv=None) -> dict:
    return _micro.main(probes(), __doc__.split("\n\n")[0], argv)


if __name__ == "__main__":
    main()
