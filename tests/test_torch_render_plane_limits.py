"""The plane precompute's int32 arithmetic at the largest layout the sweep
admits (``render_plane._axis_supported``), on the CPU, from the coarse table
alone: no volume is built.

The largest marching layout is nx = 262143 * 16 (``_MAX_SLABS`` slabs),
ny = BY + ``_MAX_YB`` = 2096 and nz = BZ + ``_MAX_ZB`` = 4224, so the coarse
table of 16^3 blocks is at most 262143 x 131 x 264. Pinned here:

- a plane's summed-area table sums at most 131 * 264 block bits
  (``_coarse_activity`` gives the near and interior bits a table each):
  34,584 fits int32;
- the flat index of a table entry reaches 262143 * 132 * 265 - 1 =
  9,169,762,139, past 2^31 (for a volume of about 5.3e12 cells or more): the
  port forms it in int64, where the JAX package's int32 would wrap;
- the slot pack is at most (262142 * 256 + 255) * 32 + 31 = 2,147,475,455,
  under 2^31 by the construction of the ``_MAX_`` limits, and decodes back.

And the activity pack of the JAX package (near 1 plus interior 8192 in one
int32, near read as the count mod 8192) at a supported layout: a footprint
of 8192 near blocks reads as no near block there, so a slab holding a
surface is skipped by a row that overflows its band. The port sums the two
bits in separate tables. Both packages' precomputes run on the same wall and
rays: JAX's (``_plane_sweep_core`` run eagerly up to its ``pallas_call``,
whose kernel is not run) leaves the row with no active slab and resolved,
the port's marks it unresolved (its rays go to the exact march).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from sdf_tools_tpu.grid import GridMeta as JaxGridMeta
from sdf_tools_tpu.ops import render_plane as jrp
from sdf_tools_tpu_torch import GridMeta
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


def _whole_plane_count(sat, cy, cz):
    """The precompute's box count over the whole of x-plane 0."""
    i = lambda v: torch.tensor([v], dtype=I32)  # noqa: E731
    return int(rp._box_count(sat, i(0), i(0), i(cy), i(0), i(cz)))


def test_sat_sums_fit_int32():
    """The sums run along y and z only, so one x-plane of the largest
    coarse table, every block's bit set, is the worst case."""
    _, ny, nz = _largest_layout()
    cy, cz = _coarse(ny), _coarse(nz)
    sat = rp._plane_sat(torch.ones((1, cy, cz), dtype=I32))
    want = torch.ones((1, cy, cz), dtype=torch.int64).cumsum(1).cumsum(2)
    assert sat.dtype == I32 and sat.shape == (1, cy + 1, cz + 1)
    assert torch.equal(sat[:, 1:, 1:].to(torch.int64), want)
    assert int(sat.max()) == cy * cz == 34_584 < 2**31
    assert _whole_plane_count(sat, cy, cz) == 34_584


def _jax_precompute(values, res, origins, directions, t_max):
    """JAX's ``_plane_sweep_core`` run eagerly up to its ``pallas_call``:
    the slot table handed to the kernel, [R, HDR + smax], and the rays it
    leaves unresolved (the kernel not run: its outputs are zeros and the
    tail is off)."""
    captured = {}

    def spy(kernel, *, out_shape, **kw):
        def run(*args):
            captured["tab"] = np.asarray(args[0])
            return [jnp.zeros(o.shape, o.dtype) for o in out_shape]

        return run

    meta = JaxGridMeta.create(origin_transform=jnp.eye(4), resolution=res, shape=values.shape)
    with pytest.MonkeyPatch.context() as mp, jax.disable_jit():
        mp.setattr(jrp.pl, "pallas_call", spy)
        mp.setenv("PS_TAIL", "0")
        out = jrp._plane_sweep_core(
            jnp.asarray(values), meta.inv_origin_transform, meta.resolution, jnp.asarray(origins),
            jnp.asarray(directions), 0.0, t_max, 1e-3,
        )
    tab = captured["tab"]
    return tab.reshape(tab.shape[0], -1), np.asarray(out[3])


def test_near_count_does_not_wrap_at_8192_blocks():
    """A wall of near cells across a 1024 x 2048 plane: 64 x 128 = 8192
    near blocks in the footprint of a row whose 128 rays, along +x, spread
    over the plane (it overflows the band, so an active slab makes it
    unresolved; a slab read as inactive is skipped instead). The wall is the
    last plane of x length 33, in slab 2, past the entry slab and the one
    after it, which the entry rule activates by their interior bit."""
    shape, res = (33, 1024, 2048), 0.1
    assert rp._axis_supported(shape)
    assert 1024 - 1 > rp._Y_SPAN  # the row's footprint cannot fit the band
    cy, cz = _coarse(shape[1]), _coarse(shape[2])
    assert cy * cz == 8192
    values = np.ones(shape, np.float32)
    values[32] = 0.0  # |v| < 1.5 res and v < 1.5 res in every block of slab 2
    coarse = rp._coarse_activity(torch.as_tensor(values), torch.tensor(res))
    assert coarse.shape == (2, 3, cy, cz) and bool((coarse[:, 2] == 1).all()) and not bool(coarse[:, :2].any())
    near, interior = (_whole_plane_count(rp._plane_sat(c[2:]), cy, cz) for c in coarse)
    assert near == interior == 8192  # the port: near and interior blocks

    # one row of rays along +x from half a cell before the grid, on an
    # 8 x 16 lattice spanning every block of the plane
    yc, zc = np.meshgrid(8 + 144 * np.arange(8), 8 + 135 * np.arange(16), indexing="ij")
    origins = np.stack([np.full(128, -0.5), yc.ravel() + 0.5, zc.ravel() + 0.5], -1).astype(np.float32) * res
    directions = np.tile(np.float32([1.0, 0.0, 0.0]), (128, 1))
    t_max = 5.0
    meta = GridMeta.create(torch.eye(4), res, shape, device="cpu")
    port = rp.plane_sweep_tables(
        torch.as_tensor(values), meta, torch.as_tensor(origins), torch.as_tensor(directions), 0.0, t_max
    )
    assert int(port.tab[0, 0]) == 0 and bool(port.unresolved_row[0])  # slab 2 active, the band overflowed
    # the JAX package: the count 8193 * 8192 reads as no near block, and the
    # row is left resolved with no slab to march (its rays would miss the wall)
    tab, unresolved = _jax_precompute(values, res, origins, directions, t_max)
    assert tab.shape == tuple(port.tab.shape)
    assert int(tab[0, 0]) == 0 and not unresolved.any()
    assert np.array_equal(tab[0, 1:rp.HDR], port.tab[0, 1:rp.HDR].numpy())  # the same row: axis and extents
    # one block less of the wall: the count no longer wraps, and JAX agrees
    values[32, :16, :16] = 1.0
    tab, unresolved = _jax_precompute(values, res, origins, directions, t_max)
    assert unresolved.all()


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
