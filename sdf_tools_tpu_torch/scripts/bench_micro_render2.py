"""The port's counterpart of ``scripts/bench_micro_render2.py``: which part
of the sampler's row-step costs what, measured on the card.

    python -m sdf_tools_tpu_torch.scripts.bench_micro_render2 [--device cuda|cpu]

Variants (``csrc/micro_render.cu``), each over ROWS = 128 ray rows x
STEPS = 128 steps of a (512, 512) float32 plane (y in [10, 410), z in
[10, 310)):
  load     (micro_band_sum) the row's dynamic (16, 256) band, summed
  loadtaa  (micro_sampler) the band's two per-lane column gathers, each
           summed
  full     (micro_sampler) the sampler (gathers, one-hot row selects,
           bilinear combine)
  static   (micro_sampler) full with the band base fixed at (0, 0)
  mxu      (micro_sampler) full with the column gathers as one-hot
           products in fp32 FMAs; it equals full bit for bit (the JAX
           probe's `pltpu.roll(sel, shift=-1)` does not trace, and in
           `jnp.roll`'s direction would gather z - 1; the port follows the
           script's docstring, "full, but column gathers via one-hot
           matmul")

Each prints one line in the JAX script's order and naming (see
``bench_micro_render``).
"""
from __future__ import annotations

import functools

from . import _micro, _sampler
from .bench_micro_render import inputs

ROWS = 128
STEPS = 128
SRC = "scripts/bench_micro_render2.py"
REPLACES = f"{SRC}:45 make_kernel (call :99)"
VARIANTS = ("load", "loadtaa", "full", "static", "mxu")


def probe(variant: str, rows: int = ROWS, steps: int = STEPS) -> _micro.Probe:
    build = functools.partial(inputs, rows)  # the same draws as bench_micro_render.py's
    shapes = [(512, 512), (rows, 128), (rows, 128)]
    roles = ("data", "y", "z")
    if variant == "load":
        return _sampler.band_sum("R2-load", "load", REPLACES, build, roles, _sampler.BandSum("rays", 16, 256),
                                 steps, rows, shapes=shapes)
    return _sampler.sampler(f"R2-{variant}", variant, REPLACES, build, roles, variant, steps, rows, shapes=shapes)


def probes():
    return tuple(probe(v, ROWS, STEPS) for v in VARIANTS)


PROBES = probes()


def main(argv=None) -> dict:
    return _micro.main(probes(), __doc__.split("\n\n")[0], argv)


if __name__ == "__main__":
    main()
