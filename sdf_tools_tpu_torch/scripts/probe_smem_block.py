"""The port's counterpart of ``scripts/probe_smem_block.py``: the two
capabilities the plane-sweep renderer needed of a TPU, asked of the card
and timed there.

    python -m sdf_tools_tpu_torch.scripts.probe_smem_block [--device cuda|cpu]

Probes (``csrc/micro_render.cu``, ``micro_band_copy``; one block an
instance's table row, as the TPU grid's steps):
  smem_block    (S1) each of 64 rows sums its (1, 16) block of a (64, 1, 16)
                int32 table as float32, staged in shared memory by one bulk
                copy, and writes the sum across 128 lanes
  dyn_fori_dma  (S2) each row reads a trip count n <= 14 and n x-bases from
                its table row; each trip copies the (2, 32, 256) float32
                slab vol[xb : xb + 2] of a (64, 32, 256) volume into shared
                memory (one bulk copy of 64 KiB, waited for) and adds its
                [0, 0, 0:128] to the row's 128 sums

Each prints one line in the JAX script's order and naming, OK where the
script's own check against numpy holds (here exactly, on all 128 lanes),
with its kernel's time, bound and copy rate on the card; on the CPU
(``--device cpu``) the plain versions run and every time reads "not
measured".
"""
from __future__ import annotations

import functools

import numpy as np

from . import _micro, _sampler

R, S = 64, 16
NX, NY, NZ = 64, 32, 256
SRC = "scripts/probe_smem_block.py"


def s1_inputs():
    """probe1's table."""
    return (np.arange(R * S, dtype=np.int32).reshape(R, 1, S),)


@functools.cache
def s2_inputs():
    """probe2's table and volume, drawn as the script draws them."""
    rng = np.random.default_rng(0)
    vol = rng.random((NX, NY, NZ)).astype(np.float32)
    tab = np.zeros((R, S), np.int32)
    counts = rng.integers(0, S - 1, R)
    for r in range(R):
        tab[r, 0] = counts[r]
        tab[r, 1 : 1 + counts[r]] = rng.integers(0, NX - 2, counts[r])
    return tab.reshape(R, 1, S), vol


def s1_check(arrays, out) -> bool:
    """probe1's check, exact: each row's float64 sum on every lane."""
    (tab,) = arrays
    want = tab.sum(axis=(1, 2), dtype=np.float64)
    return bool(np.array_equal(out[:, 0, :], np.repeat(want[:, None], out.shape[-1], 1)))


def s2_check(arrays, out) -> bool:
    """probe2's check, exact: each row's float32 sum of vol[xb, 0, lane] over
    its trips, in trip order, on every lane."""
    tab, vol = arrays
    want = np.zeros((R, out.shape[-1]), np.float32)
    for r in range(R):
        for i in range(tab[r, 0, 0]):
            want[r] = want[r] + vol[tab[r, 0, 1 + i], 0, : out.shape[-1]]
    return bool(np.array_equal(out[:, 0, :], want))


def probes():
    trips = int(s2_inputs()[0][:, 0, 0].sum())
    return (
        _sampler.band_copy("S1", "smem_block", f"{SRC}:24 probe1 (call :32)", s1_inputs, ("tab",), "rowsum",
                           out_shape=(R, 1, 128), unit="row", steps=R, shapes=[(R, 1, S)], check=s1_check),
        _sampler.band_copy("S2", "dyn_fori_dma", f"{SRC}:44 probe2 (call :67)", s2_inputs, ("tab", "vol"), "trips",
                           band=(2, NY, NZ), out_shape=(R, 1, 128), unit="trip", steps=trips,
                           copied=trips * 2 * NY * NZ * 4, shapes=[(R, 1, S), (NX, NY, NZ)], check=s2_check),
    )


PROBES = probes()


def main(argv=None) -> dict:
    return _micro.main(probes(), __doc__.split("\n\n")[0], argv)


if __name__ == "__main__":
    main()
