"""The port's counterpart of ``scripts/bench_micro_render6.py``: the
group-skipping renderer's primitives over a 512^3 bfloat16 volume, each a
chain of ``iters`` iterations whose copy offsets come from a packed int32
table (xb * 65536 + yb8 * 4 + zb128), measured on the card.

    python -m sdf_tools_tpu_torch.scripts.bench_micro_render6 [--device cuda|cpu]

Each variant is timed on the device at ITERS_LO and ITERS_HI iterations;
its line gives both and the slope between them, ns an iteration. Variants
(``csrc/micro_render.cu``):
  smem_rw  (micro_band_copy) 128 per-row counters in shared memory, read
           and incremented each iteration, the value read added to every
           lane; the port zero-fills the counters, which the TPU probe never
           initialises, so its output is the sum over i of i // 128
  dma      (micro_band_copy) each iteration copies its (9, 32, 256) band
           into shared memory (288 bulk copies of 512 B on one mbarrier),
           waits, and adds band[0, 0, 0:128] to the 128 lanes
  dma_ovl  (micro_band_copy) dma's copies streamed through a ring of four
           stages of three planes, so that the next band is in flight while
           the current one lands (two bands do not fit in a block's shared
           memory); it equals dma bit for bit
  sample9  (micro_sampler) dma, then one sampler step on plane 3 of the
           band for ray row i & 127, the z + 1 gather stood in for by the z
           gather as in the TPU probe; one chain a ray

Each prints one line in the JAX script's order and naming (see
``bench_micro_render``).
"""
from __future__ import annotations

import functools

import numpy as np

from . import _micro, _sampler

ITERS_LO = 2048
ITERS_HI = 16384
TABLE = 16384 + 2  # the table's entries (the script's ITERS_HI + 2, which its main draws)
NB = _sampler.R6_BAND  # band planes, y, z
N = 512  # the volume's side
NX = N  # planes of the volume built (fewer only to cut the probe; the draws stay the script's)
SRC = "scripts/bench_micro_render6.py"
REPLACES = f"{SRC}:25 make_kernel (call :151)"
VARIANTS = ("smem_rw", "dma", "dma_ovl", "sample9")
ROLES = ("tab", "vol16", "y", "z")
DRAW_PLANES = 32  # planes of the volume drawn at a time


@functools.cache
def inputs(nx: int = N):
    """The script's table, volume (float32, made bfloat16 by the probe's
    dtype), and rays, drawn as it draws them. With ``nx`` < 512 only the
    volume's first ``nx`` planes are kept (the rest of its draws skipped)
    and each table x-base is taken modulo nx - 9, so that every band lies
    in the cut volume."""
    rng = np.random.default_rng(0)
    vol = np.empty((nx, N, N), np.float32)
    for x in range(0, nx, DRAW_PLANES):
        vol[x : x + DRAW_PLANES] = rng.random((min(DRAW_PLANES, nx - x), N, N))
    rng.bit_generator.advance((N - nx) * N * N)  # one 64-bit draw a double
    y = (10 + 400 * rng.random((128, 128))).astype(np.float32)
    z = (10 + 200 * rng.random((128, 128))).astype(np.float32)
    xb = rng.integers(0, 512 - 9, TABLE).astype(np.int64)
    yb8 = rng.integers(0, 60, TABLE).astype(np.int64)
    zb128 = rng.integers(0, 2, TABLE).astype(np.int64)
    if nx < N:
        xb = xb % (nx - NB[0])
    tab = (xb * 65536 + yb8 * 4 + zb128).astype(np.int32)
    return tab, vol, y, z


def probe(variant: str, iters: int = ITERS_HI, lo: int | None = ITERS_LO, nx: int | None = None) -> _micro.Probe:
    nx = NX if nx is None else nx
    low = probe(variant, lo, None, nx) if lo else None
    build = functools.partial(inputs, nx)
    shapes = [(TABLE,), (nx, N, N), (128, 128), (128, 128)]
    if variant == "sample9":
        return _sampler.sampler("R6-sample9", "sample9", REPLACES, build, ROLES, "sample9", 1, iters,
                                unit="iteration", shapes=shapes, lo=low)
    copied = iters * int(np.prod(NB)) * 2 if variant != "smem_rw" else 0
    return _sampler.band_copy(f"R6-{variant}", variant, REPLACES, build, ROLES, variant, band=NB, iters=iters,
                              out_shape=(1, 128), copied=copied, shapes=shapes, lo=low)


def probes():
    return tuple(probe(v, ITERS_HI, ITERS_LO) for v in VARIANTS)


PROBES = probes()


def main(argv=None) -> dict:
    return _micro.main(probes(), __doc__.split("\n\n")[0], argv)


if __name__ == "__main__":
    main()
