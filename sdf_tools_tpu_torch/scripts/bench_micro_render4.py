"""The port's counterpart of ``scripts/bench_micro_render4.py``: the
sampler with its band bases read from tables computed outside the kernel,
measured on the card.

    python -m sdf_tools_tpu_torch.scripts.bench_micro_render4 [--device cuda|cpu]

Variants (``csrc/micro_render.cu``), over ROWS = 128 ray rows x G = 16
groups of a (512, 512) float32 plane, the bases from (128, 16) int32
tables (each row's least y and z rounded down to 8 and 128, clipped), one
chain over rows, then groups, then k:
  tab_load  (micro_band_sum) the (24, 256) band of each row and group,
            summed
  tab_full  (micro_sampler) K = 8 sampler steps on each band, the rays at
            y + float32(0.01) * k and z + float32(0.017) * k (each product
            rounded in float32)

Each prints one line in the JAX script's order and naming (see
``bench_micro_render``).
"""
from __future__ import annotations

import functools

import numpy as np

from . import _micro, _sampler
from .bench_micro_render3 import inputs as plane_and_rays

ROWS = 128
STEPS = 128
K = 8  # steps per base-table group
G = STEPS // K
SRC = "scripts/bench_micro_render4.py"
REPLACES = f"{SRC}:31 make_kernel (call :81)"
VARIANTS = ("tab_load", "tab_full")


@functools.cache
def inputs(rows: int = ROWS, groups: int = G):
    """The script's tables, plane and rays (its draws are
    bench_micro_render3.py's), the first ``rows`` rows and ``groups``
    groups."""
    plane, y, z = plane_and_rays(ROWS)
    ytab = np.clip((y.min(axis=1, keepdims=True) // 8 * 8).astype(np.int32), 0, 512 - 24) * np.ones((1, G), np.int32)
    ztab = np.clip((z.min(axis=1, keepdims=True) // 128 * 128).astype(np.int32), 0, 512 - 256) * np.ones((1, G),
                                                                                                       np.int32)
    return ytab[:rows, :groups], ztab[:rows, :groups], plane, y[:rows], z[:rows]


def probe(variant: str, rows: int = ROWS, groups: int = G) -> _micro.Probe:
    build = functools.partial(inputs, rows, groups)
    roles = ("ytab", "ztab", "data", "y", "z")
    shapes = [(rows, groups), (rows, groups), (512, 512), (rows, 128), (rows, 128)]
    if variant == "tab_load":
        return _sampler.band_sum("R4-tab_load", "tab_load", REPLACES, build, roles,
                                 _sampler.BandSum("table", 24, 256), 1, rows * groups, unit="band", shapes=shapes)
    return _sampler.sampler("R4-tab_full", "tab_full", REPLACES, build, roles, "tab_full", 1, rows * groups * K,
                            G=groups, K=K, unit="ray-row-plane-step", shapes=shapes)


def probes():
    return tuple(probe(v) for v in VARIANTS)


PROBES = probes()


def main(argv=None) -> dict:
    return _micro.main(probes(), __doc__.split("\n\n")[0], argv)


if __name__ == "__main__":
    main()
