"""The plane precompute's int32 arithmetic at the largest layout the sweep
admits (``render_plane._axis_supported``), on the CPU, from the coarse table
alone: no volume is built.

The largest marching layout is nx = 262143 * 16 (``_MAX_SLABS`` slabs),
ny = BY + ``_MAX_YB`` = 2096 and nz = BZ + ``_MAX_ZB`` = 4224, so the coarse
table of 16^3 blocks is at most 262143 x 131 x 264. Pinned here:

- a plane's summed-area table sums at most 131 * 264 block values of at most
  8193 (``_coarse_activity``): 283,346,712 fits int32;
- the flat index of a table entry reaches 262143 * 132 * 265 - 1 =
  9,169,762,139, past 2^31 (for a volume of about 5.3e12 cells or more): the
  port forms it in int64, where the JAX package's int32 would wrap;
- the slot pack is at most (262142 * 256 + 255) * 32 + 31 = 2,147,475,455,
  under 2^31 by the construction of the ``_MAX_`` limits, and decodes back.
"""
import torch

from sdf_tools_tpu_torch.ops import render_plane as rp

I32 = torch.int32


def _largest_layout():
    return rp._MAX_SLABS * rp.SLAB, rp.BY + rp._MAX_YB, rp.BZ + rp._MAX_ZB


def _coarse(n: int) -> int:
    return -(-n // rp.SLAB)


def test_largest_layout_is_the_limit():
    nx, ny, nz = _largest_layout()
    assert rp._axis_supported((nx, ny, nz))
    for grown in ((nx + 1, ny, nz), (nx, ny + 1, nz), (nx, ny, nz + 1)):
        assert not rp._axis_supported(grown)
    assert (_coarse(nx), _coarse(ny), _coarse(nz)) == (262143, 131, 264)


def test_sat_sums_fit_int32():
    """The sums run along y and z only, so one x-plane of the largest
    coarse table, every block at 8193, is the worst case."""
    _, ny, nz = _largest_layout()
    cy, cz = _coarse(ny), _coarse(nz)
    sat = rp._plane_sat(torch.full((1, cy, cz), 8193, dtype=I32))
    want = torch.full((1, cy, cz), 8193, dtype=torch.int64).cumsum(1).cumsum(2)
    assert sat.dtype == I32 and sat.shape == (1, cy + 1, cz + 1)
    assert torch.equal(sat[:, 1:, 1:].to(torch.int64), want)
    assert int(sat.max()) == 8193 * cy * cz == 283_346_712 < 2**31
    # the precompute's box count over the whole plane
    flat = sat.reshape(-1)

    def q(yy, zz):
        return flat[rp._sat_index(torch.zeros(1, dtype=I32), torch.tensor([yy], dtype=I32),
                                  torch.tensor([zz], dtype=I32), cy + 1, cz + 1)]

    assert int(q(cy, cz) - q(0, cz) - q(cy, 0) + q(0, 0)) == 283_346_712


def test_sat_flat_index_is_int64_past_2_31():
    nx, ny, nz = _largest_layout()
    cx, cya, cza = _coarse(nx), _coarse(ny) + 1, _coarse(nz) + 1
    sc, yy, zz = (torch.tensor([v], dtype=I32) for v in (cx - 1, cya - 1, cza - 1))
    idx = rp._sat_index(sc, yy, zz, cya, cza)
    assert idx.dtype == torch.int64
    assert int(idx) == cx * cya * cza - 1 == 9_169_762_139 > 2**31
    assert int((sc * cya + yy) * cza + zz) != int(idx)  # what int32 would give


def test_slot_pack_fits_int32_and_decodes():
    slab, yb, zb = (torch.tensor([v], dtype=I32) for v in (rp._MAX_SLABS - 1, rp._MAX_YB, rp._MAX_ZB))
    pack = rp._slot_pack(slab, yb, zb)
    assert pack.dtype == I32 and int(pack) == (262142 * 256 + 255) * 32 + 31 == 2_147_475_455 < 2**31 - 1
    assert int(pack // (256 * 32)) == rp._MAX_SLABS - 1
    assert int(pack // 32 % 256) * 8 == rp._MAX_YB and int(pack % 32) * 128 == rp._MAX_ZB
