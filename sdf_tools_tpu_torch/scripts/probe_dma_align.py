"""The port's counterpart of ``scripts/probe_dma_align.py``: does a
dynamic-offset copy whose lane offset is a multiple of 8 elements (not
128) come out right? Asked of the card's bulk asynchronous copy, whose
addresses and sizes must be multiples of 16 bytes (8 float32 lanes are
32).

    python -m sdf_tools_tpu_torch.scripts.probe_dma_align [--device cuda|cpu]

Probe (``csrc/micro_render.cu``, ``micro_band_copy``; one block an
instance's table row):
  zb%8 DMA  (D1) each of 8 rows copies the (4, 16, 128) band at
            (xb, 8 yb, 8 zb) of a (32, 64, 512) float32 volume into shared
            memory (64 bulk copies of 512 B at 32-byte offsets, on one
            mbarrier) and writes it out as (64, 128)

It prints one line with the JAX script's name, OK where every row equals
the numpy band bit for bit, its kernel's time, bound and copy rate, and
the time of ``torch.take`` of the bands' flat indices (one PyTorch call of
the same function; a clone of one band view would copy one of the eight);
on the CPU (``--device cpu``) the plain version runs and every time reads
"not measured".
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from . import _micro, _sampler

NX, NY, NZ = 32, 64, 512
P, BY, BZ = 4, 16, 128
R = 8
SRC = "scripts/probe_dma_align.py"


@functools.cache
def inputs():
    """The script's offsets table and volume, drawn as it draws them."""
    rng = np.random.default_rng(0)
    vol = rng.random((NX, NY, NZ)).astype(np.float32)
    offs = np.zeros((R, 1, 8), np.int32)
    for r in range(R):
        offs[r, 0, 0] = rng.integers(0, NX - P)
        offs[r, 0, 1] = rng.integers(0, (NY - BY) // 8)
        offs[r, 0, 2] = rng.integers(0, (NZ - BZ) // 8)
    return offs, vol


def check(arrays, out) -> bool:
    """The script's check: every row's band equal to numpy's."""
    offs, vol = arrays
    return all(np.array_equal(out[r], vol[x : x + P, y : y + BY, z : z + BZ].reshape(P * BY, BZ))
               for r, (x, y, z) in enumerate(zip(offs[:, 0, 0], offs[:, 0, 1] * 8, offs[:, 0, 2] * 8)))


def band_indices(tab: torch.Tensor, vol: torch.Tensor) -> list[torch.Tensor]:
    """``torch.take``'s arguments: the volume and the bands' flat indices
    [B, R, P * BY, BZ] (computed apart, so that its time is one call's)."""
    idx = torch.arange(vol[0].numel(), device=vol.device).view(vol.shape[1:])
    return [vol[0], _sampler.band_copy_plain("copyout", tab.reshape(tab.shape[0], R, -1), idx, (P, BY, BZ), 0)]


def probes():
    return (
        _sampler.band_copy("D1", "zb%8 DMA", f"{SRC}:17 kernel (call :38)", inputs, ("tab", "vol"), "copyout",
                           band=(P, BY, BZ), out_shape=(R, P * BY, BZ), unit="band", steps=R,
                           copied=R * P * BY * BZ * 4, shapes=[(R, 1, 8), (NX, NY, NZ)], check=check,
                           prepare=band_indices, library=torch.take),
    )


PROBES = probes()


def main(argv=None) -> dict:
    return _micro.main(probes(), __doc__.split("\n\n")[0], argv)


if __name__ == "__main__":
    main()
