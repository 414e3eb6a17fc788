"""Tile-coherent plane-sweep renderer (counterpart of ``sdf_tools_tpu/ops/render_plane.py``).

Rays are grouped into 128-ray rows (an image bundle is regrouped into 8x16
pixel tiles first). Each row marches its dominant axis plane by plane over
the field transposed so that axis is major, in slabs of 16 planes. At a
plane crossing the center-corrected trilinear of the reference collapses to
a center-corrected bilinear on that plane, so one sample costs four corner
reads. Empty space is skipped at slab granularity: a precompute marks the
(row, slab) pairs whose footprint box meets a near-surface or interior
16^3 block and compacts them into per-row slot tables in marching order.

Three stages, as in the JAX package:

1. ``plane_sweep_tables`` (plain PyTorch): grid-frame rays, AABB windows,
   the per-row marching axis and footprints (``_row_tables``), the activity
   bits and their summed-area tables, the slot tables, the per-ray
   channels, and the transposed volumes.
2. ``plane_sweep_rows``: the sweep itself, kernel K8
   (``csrc/render_plane.cu``) on a CUDA tensor, ``plane_sweep_rows_plain``
   on a CPU tensor. Outputs per ray: depth, hit, steps, model bits (which
   hits a frozen-corner model proposed), tnear (the first near-miss t) and
   the row's executed-slab count.
3. ``verify_tail`` (plain PyTorch): model-proposed hits and near misses are
   re-checked with exact trilinear samples; rays demoted there are traced
   again by the exact march from ``t_min``.

Rows the sweep cannot take (mixed marching direction, slope over the cap,
a footprint outside the band) are "unresolved"; ``plane_sweep_depth``
traces those rays with the exact march (``render._trace_depth``), as the
JAX package does under its ``lax.cond``.

The band geometry (``SLAB``, ``BY``, ``BZ``) and the pack caps decide which
rows the sweep takes and which fall back to the march, so they are part of
the function's result and are kept as the JAX package has them, although
the CUDA kernel has no band buffer: it reads the field through L1
(``slab_footprints`` gives the cells each executed slab reads).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from .. import _build, profiling
from ..grid import SdfGrid, float_to_int32, floor_to_int32, rotate_points
from . import query

LANES = 128  # rays per row
SLAB = 16  # planes per slab
PB = SLAB + 1  # planes per band (pair p needs planes p and p+1)
BY = 56  # band extent along the row's second axis (cells)
BZ = 256  # band extent along the row's third axis (cells)
HDR = 8  # header ints per row: [n_active, axis, nx, ny, nz, 0, 0, 0]
NCH = 16  # channel rows per ray row (9 used)
BIGF = 1e30
SLOPE_CAP = 3.5  # max |dy/dx| the footprint boxes are sized for

# a corner pair's upper index must lie in [yb, yb + BY - 1] and [zb, zb + BZ - 1]
_Y_SPAN = BY - 1
_Z_SPAN = BZ - 1

# a slot packs (slab*256 + yb//8)*32 + zb//128: yb//8 has 8 bits, zb//128 5
# bits and the slab the rest of the int32; larger extents would wrap, so an
# axis that could overflow is unsupported
_MAX_YB = 255 * 8
_MAX_ZB = 31 * 128
_MAX_SLABS = (1 << 31) // (256 * 32) - 1

# the exact verification window: 25 samples across t +- 1.25 plane spacings.
# The offsets are the JAX package's jnp.linspace(-1.25, 1.25, 25) in float32
# as XLA computes it (by a reciprocal and fused multiply-adds; a plain
# linspace differs in the last bit on 9-19 of the 25 values)
_WINDOW_OFFSETS = (
    -1.25, -1.1458333, -1.0416667, -0.9375, -0.83333325, -0.72916657, -0.625,
    -0.52083325, -0.41666657, -0.31249997, -0.20833327, -0.10416656, 0.000000029802322,
    0.10416674, 0.20833345, 0.31250003, 0.41666675, 0.52083343, 0.62500006,
    0.72916675, 0.83333343, 0.93750006, 1.0416667, 1.1458335, 1.25,
)
# budgets of the tail's three passes (rays): model-hit verification,
# near-miss verification, resume march
KR = 1024
KN = 8192
KD = 512


def _axis_supported(sh: Tuple[int, int, int]) -> bool:
    """Band geometry and pack-encoding limits for one marching-axis layout."""
    return (
        sh[0] >= PB
        and sh[1] >= BY
        and sh[2] >= BZ
        and sh[1] - BY <= _MAX_YB
        and sh[2] - BZ <= _MAX_ZB
        and (sh[0] + SLAB - 1) // SLAB <= _MAX_SLABS
    )


def _perm(axis: int) -> Tuple[int, int, int]:
    return (axis, (axis + 1) % 3, (axis + 2) % 3)


def plane_sweep_supported(shape: Tuple[int, int, int]) -> bool:
    """True if at least one marching axis fits the band geometry and the
    slot-pack encoding."""
    return any(_axis_supported(tuple(shape[i] for i in _perm(a))) for a in range(3))


# ---- tile regrouping of image bundles --------------------------------------


def tile_regroup(x: torch.Tensor, h: int, w: int, th: int = 8, tw: int = 16) -> torch.Tensor:
    """Apply ``tile_perm``'s row permutation to [N, ...] as reshape+transpose."""
    trail = x.shape[1:]
    nimg = x.shape[0] // (h * w)
    y = x.reshape((nimg, h // th, th, w // tw, tw) + trail)
    return y.movedim(2, 3).reshape((x.shape[0],) + trail)


def tile_ungroup(x: torch.Tensor, h: int, w: int, th: int = 8, tw: int = 16) -> torch.Tensor:
    """Inverse of :func:`tile_regroup`."""
    trail = x.shape[1:]
    nimg = x.shape[0] // (h * w)
    y = x.reshape((nimg, h // th, w // tw, th, tw) + trail)
    return y.movedim(3, 2).reshape((x.shape[0],) + trail)


def tile_perm(h: int, w: int, n_rays: int, th: int = 8, tw: int = 16):
    """Ray permutation regrouping an (h, w) image into th x tw pixel tiles
    (th*tw == LANES), plus its inverse; int64 tensors on the CPU. n_rays may
    cover several stacked images of h*w rays each."""
    base = torch.arange(h * w).reshape(h // th, th, w // tw, tw).permute(0, 2, 1, 3).reshape(-1)
    nimg = n_rays // (h * w)
    perm = (base[None, :] + (torch.arange(nimg) * h * w)[:, None]).reshape(-1)
    return perm, torch.argsort(perm)


# ---- precompute --------------------------------------------------------------


def _row_tables(shapes_by_axis, supported, u0, vg, t_start, t_end, smax):
    """Per-row marching axis, per-ray marching parameters and per-(row,
    slab) footprints. u0, vg: [R, 128, 3] grid-frame positions (cells) and
    directions (cells per world unit); t_start/t_end: [R, 128] world-unit
    windows (empty window = miss). Same keys as the JAX package's."""
    f32, i32 = torch.float32, torch.int32
    dev = u0.device

    mean_v = vg.abs().mean(dim=1)  # [R, 3]
    scores = torch.stack([mean_v[:, a] if supported[a] else torch.full_like(mean_v[:, a], -1.0) for a in range(3)], 1)
    axis_r = scores.argmax(dim=1).to(i32)

    def pick(arr3, a_idx):
        return arr3.gather(-1, a_idx.long()[:, None, None].expand(arr3.shape[:-1] + (1,)))[..., 0]

    ux0, uy0, uz0 = (pick(u0, (axis_r + k) % 3) for k in range(3))
    vx, vy, vz = (pick(vg, (axis_r + k) % 3) for k in range(3))
    profiling.count("sync.render.tables_shape")  # the shapes copied to the device
    dims = torch.tensor(shapes_by_axis, dtype=i32, device=dev)
    nx_r, ny_r, nz_r = (dims[axis_r.long(), k] for k in range(3))

    # ---- per-ray marching parameters: y(ux) = y0c + sy*ux, t(ux) = tc0 + tc1*ux
    safe_vx = torch.where(vx.abs() > 1e-12, vx, 1e-12)
    sy = vy / safe_vx
    sz = vz / safe_vx
    tc1 = torch.reciprocal(safe_vx)
    tc0 = -ux0 * tc1
    y0c = uy0 - ux0 * sy
    z0c = uz0 - ux0 * sz

    ray_live = t_start <= t_end
    pos_ok = (ray_live & (vx > 0)).sum(1, dtype=i32)
    neg_ok = (ray_live & (vx < 0)).sum(1, dtype=i32)
    n_live = ray_live.sum(1, dtype=i32)
    mixed = (pos_ok > 0) & (neg_ok > 0)
    slope_bad = (ray_live & ~((sy.abs() <= SLOPE_CAP) & (sz.abs() <= SLOPE_CAP))).any(1)
    dir_row = pos_ok >= neg_ok

    # ---- footprints at slab boundaries (a linear family's extrema over a
    # slab lie at its ends)
    bounds = torch.arange(smax + 1, dtype=f32, device=dev) * SLAB + 0.5
    live = ray_live[:, :, None]
    big = 1e9

    def lane_min(a):
        return torch.where(live, a, big).amin(1)

    def lane_max(a):
        return torch.where(live, a, -big).amax(1)

    yb_v = y0c[:, :, None] + sy[:, :, None] * bounds
    ymin_b, ymax_b = lane_min(yb_v), lane_max(yb_v)
    del yb_v
    zb_v = z0c[:, :, None] + sz[:, :, None] * bounds
    zmin_b, zmax_b = lane_min(zb_v), lane_max(zb_v)
    del zb_v
    t_bv = tc0[:, :, None] + tc1[:, :, None] * bounds
    tmin_b, tmax_b = lane_min(t_bv), lane_max(t_bv)
    del t_bv

    def pairmin(a):
        return torch.minimum(a[:, :-1], a[:, 1:])

    def pairmax(a):
        return torch.maximum(a[:, :-1], a[:, 1:])

    ymin_s, ymax_s = pairmin(ymin_b), pairmax(ymax_b)  # [R, S]
    zmin_s, zmax_s = pairmin(zmin_b), pairmax(zmax_b)
    tmin_s, tmax_s = pairmin(tmin_b), pairmax(tmax_b)

    row_t_lo = torch.where(ray_live, t_start, big).amin(1)
    row_t_hi = torch.where(ray_live, t_end, -big).amax(1)
    relevant = (tmax_s >= row_t_lo[:, None]) & (tmin_s <= row_t_hi[:, None])
    s_ids = torch.arange(smax, dtype=i32, device=dev)[None, :]
    relevant &= s_ids < (nx_r[:, None] + SLAB - 1) // SLAB

    # band bases (corner-cell index range, as the sweep clips it)
    ny_c, nz_c = ny_r[:, None], nz_r[:, None]

    def corner_lo(a, n):
        return torch.clamp(floor_to_int32(a - 0.5), min=torch.zeros_like(n), max=n - 2)

    rlo_y, rhi_y = corner_lo(ymin_s, ny_c), corner_lo(ymax_s, ny_c) + 1
    rlo_z, rhi_z = corner_lo(zmin_s, nz_c), corner_lo(zmax_s, nz_c) + 1
    # a slot packs the band base as a multiple of 8 (y) and of 128 (z), so
    # the base is clamped to the last such multiple inside the volume; a
    # footprint past that band does not fit, and its row goes to the march.
    # (The JAX package clamps to ny - BY and nz - BZ and the pack drops the
    # remainder, so where those are not multiples the kernel reads a band
    # short of the face and loses the samples near it: ROADMAP.md C.)
    zero = torch.zeros_like(ny_c)
    yb_s = torch.clamp((rlo_y // 8) * 8, min=zero, max=torch.clamp(ny_c - BY, min=0) // 8 * 8)
    zb_s = torch.clamp((rlo_z // 128) * 128, min=zero, max=torch.clamp(nz_c - BZ, min=0) // 128 * 128)
    fit = (rhi_y <= yb_s + _Y_SPAN) & (rhi_z <= zb_s + _Z_SPAN)

    return dict(
        axis_r=axis_r, nx_r=nx_r, ny_r=ny_r, nz_r=nz_r, dir_row=dir_row, mixed=mixed,
        slope_bad=slope_bad, n_live=n_live, relevant=relevant, fit=fit, yb_s=yb_s, zb_s=zb_s,
        rlo_y=rlo_y, rhi_y=rhi_y, rlo_z=rlo_z, rhi_z=rhi_z, sy=sy, sz=sz, tc0=tc0, tc1=tc1,
        y0c=y0c, z0c=z0c, ux0=ux0, ray_live=ray_live, s_ids=s_ids,
    )


def _coarse_activity(values: torch.Tensor, res: torch.Tensor) -> torch.Tensor:
    """[2, cx, cy, cz] int32 per 16^3 block: [0] is 1 if some cell has
    |v| < 1.5 res (a crossing sample's corner cell is such a cell), [1] is 1
    if some cell has v < 1.5 res (obstacle interior; gates the entry slabs).
    Each bit gets its own summed-area table. (The JAX package packs both
    into one int32, near 1 plus interior 8192, and reads near as the count
    mod 8192, which is 0 for a footprint of 8192 near blocks: a departure,
    pinned by tests/test_torch_render_plane_limits.py.)"""
    thr = 1.5 * res
    # near implies interior, so each cell packs to 0, 2 or 3 and the max
    # over a block is the OR of its bits
    packed = (values < thr).to(torch.uint8).mul_(2).add_(values.abs() < thr)
    cs = [(s + SLAB - 1) // SLAB for s in values.shape]
    pad = [0] * 6  # F.pad order: last axis first
    for ax in range(3):
        pad[2 * (2 - ax) + 1] = cs[ax] * SLAB - values.shape[ax]
    packed = torch.nn.functional.pad(packed, pad)
    coarse = packed.reshape(cs[0], SLAB, cs[1], SLAB, cs[2], SLAB).amax(dim=(1, 3, 5))
    return torch.stack([coarse & 1, coarse >> 1]).to(torch.int32)


# The int32 arithmetic of the activity tables and the slot packs, at the
# largest layout _axis_supported admits (ny <= BY + _MAX_YB = 2096, nz <=
# BZ + _MAX_ZB = 4224, ceil(nx / SLAB) <= _MAX_SLABS = 262143; coarse blocks
# cy <= 131, cz <= 264, cx <= 262143), pinned by
# tests/test_torch_render_plane_limits.py without building a volume:
# - a plane SAT entry sums at most cy * cz block bits: 34,584, and a box
#   count adds and subtracts four: int32 holds both;
# - the flat SAT index reaches cx * (cy + 1) * (cz + 1) - 1 = 9,169,762,139,
#   past 2^31 (from about 5.3e12 cells on), so it is formed in int64 (the
#   JAX package forms it in int32);
# - a slot pack is at most (262142 * 256 + 255) * 32 + 31 = 2,147,475,455,
#   under 2^31 by construction of the _MAX_ limits.


def _plane_sat(ca: torch.Tensor) -> torch.Tensor:
    """[cx, cy + 1, cz + 1] int32 summed-area tables of each x-plane of the
    coarse table ``ca`` (marching axis first), zero-padded at the low y and
    z edges."""
    sat = torch.cumsum(torch.cumsum(ca, dim=1, dtype=torch.int32), dim=2, dtype=torch.int32)
    return torch.nn.functional.pad(sat, (1, 0, 1, 0))


def _sat_index(sc, yy, zz, cya: int, cza: int) -> torch.Tensor:
    """Flat int64 index of entry (sc, yy, zz) of a [cx, cya, cza] table."""
    return (sc.to(torch.int64) * cya + yy) * cza + zz


def _box_count(sat: torch.Tensor, sc, ylo, yhi, zlo, zhi) -> torch.Tensor:
    """Blocks set in the box [ylo, yhi) x [zlo, zhi) of x-plane ``sc`` of the
    summed-area tables ``sat`` [cx, cya, cza]."""
    cya, cza = sat.shape[1], sat.shape[2]
    flat = sat.reshape(-1)

    def q(yy, zz):
        return flat[_sat_index(sc, yy, zz, cya, cza)]

    return q(yhi, zhi) - q(ylo, zhi) - q(yhi, zlo) + q(ylo, zlo)


def _slot_pack(slab, yb, zb) -> torch.Tensor:
    """A slot's int32 code: (slab * 256 + yb // 8) * 32 + zb // 128."""
    return (slab * 256 + yb // 8) * 32 + zb // 128


class PlaneTables(NamedTuple):
    tab: torch.Tensor  # [R, HDR + smax] int32: header and packed slots
    ch: torch.Tensor  # [R, NCH, 128] float32 per-ray channels
    vols: tuple  # per marching axis: the field with that axis major, or None
    unresolved_row: torch.Tensor  # [R] bool
    info: dict  # _row_tables' output


def _grid_rays(shape, meta, origins, directions, t_min: float, t_max: float):
    """(u0, vg, t_start, t_end): padded rays [N, 3] as [R, 128, 3] grid-frame
    positions (cells) and directions (cells per world unit), by
    rotate_points (elementwise, never a reduced-precision matmul), and
    their [R, 128] AABB windows in world units (unit-norm directions; an
    empty window, t_end < t_start, is a miss)."""
    res = meta.resolution.to(origins.device)
    R = origins.shape[0] // LANES
    u0w = rotate_points(meta.inv_origin_transform[:3, :3], origins) + meta.inv_origin_transform[:3, 3]
    vgw = rotate_points(meta.inv_origin_transform[:3, :3], directions)
    u0 = (u0w / res).reshape(R, LANES, 3)
    vg = (vgw / res).reshape(R, LANES, 3)
    profiling.count("sync.render.tables_shape")
    sizes = torch.tensor(tuple(shape), dtype=torch.float32, device=origins.device)
    safe_v = torch.where(vg.abs() > 1e-12, vg, 1e-12)
    t_a = (0.0 - u0) / safe_v
    t_b = (sizes - u0) / safe_v
    t_entry = torch.minimum(t_a, t_b).amax(-1)
    t_exit = torch.maximum(t_a, t_b).amin(-1)
    t_start = torch.clamp(t_entry, min=t_min)
    t_end = torch.clamp(t_exit, max=t_max)
    t_end = torch.where(t_entry > t_exit, t_start - 1.0, t_end)  # box miss
    return u0, vg, t_start, t_end


def plane_sweep_tables(values, meta, origins, directions, t_min: float, t_max: float) -> PlaneTables:
    """The XLA-side precompute of the JAX package's ``_plane_sweep_core``,
    for padded rays [N, 3] (N % 128 == 0)."""
    nxyz = tuple(values.shape)
    res = meta.resolution.to(values.device)
    R = origins.shape[0] // LANES
    u0, vg, t_start, t_end = _grid_rays(nxyz, meta, origins, directions, t_min, t_max)

    shapes_by_axis = [tuple(nxyz[i] for i in _perm(a)) for a in range(3)]
    supported = [_axis_supported(sh) for sh in shapes_by_axis]
    if not any(supported):
        raise ValueError(f"grid {nxyz} too small for the plane-sweep renderer")
    smax = max((sh[0] + SLAB - 1) // SLAB for sh, ok in zip(shapes_by_axis, supported) if ok)
    info = _row_tables(shapes_by_axis, supported, u0, vg, t_start, t_end, smax)

    # ---- activity per (row, slab): box counts on summed-area tables ----
    coarse = _coarse_activity(values, res)
    s_ids = info["s_ids"]
    y0c8 = info["rlo_y"] // SLAB
    y1c8 = info["rhi_y"] // SLAB
    z0c8 = info["rlo_z"] // SLAB
    z1c8 = info["rhi_z"] // SLAB
    near_act = torch.zeros(y0c8.shape, dtype=torch.bool, device=values.device)
    interior_act = torch.zeros_like(near_act)
    for a in range(3):
        if not supported[a]:
            continue
        sat_near, sat_int = (_plane_sat(c.permute(_perm(a))) for c in coarse)
        cya, cza = sat_near.shape[1], sat_near.shape[2]
        box = (
            s_ids.clamp(0, sat_near.shape[0] - 1),
            y0c8.clamp(0, cya - 1), (y1c8 + 1).clamp(0, cya - 1),
            z0c8.clamp(0, cza - 1), (z1c8 + 1).clamp(0, cza - 1),
        )
        on_axis = info["axis_r"][:, None] == a
        near_act = torch.where(on_axis, _box_count(sat_near, *box) > 0, near_act)
        interior_act = torch.where(on_axis, _box_count(sat_int, *box) > 0, interior_act)

    # entry slabs (and the next along the marching direction, where the first
    # sampled plane may fall) are active for rays starting inside an obstacle
    ray_live = info["ray_live"]
    ux_entry = (torch.where(ray_live, t_start, 0.0) - info["tc0"]) / info["tc1"]
    se = float_to_int32((ux_entry / SLAB).clamp(-1.0, float(smax))).clamp(0, smax - 1)
    entry_cnt = torch.zeros((R, smax), dtype=torch.int32, device=values.device)
    entry_cnt.scatter_add_(1, se.long(), ray_live.to(torch.int32))
    entry_act = entry_cnt > 0
    fwd = torch.where(
        info["dir_row"][:, None],
        torch.nn.functional.pad(entry_act[:, :-1], (1, 0)),
        torch.nn.functional.pad(entry_act[:, 1:], (0, 1)),
    )
    entry_act = (entry_act | fwd) & interior_act

    active = info["relevant"] & (near_act | entry_act)
    unresolved_row = (info["mixed"] | info["slope_bad"] | (active & ~info["fit"]).any(1)) & (info["n_live"] > 0)
    active &= ~unresolved_row[:, None]

    # ---- slot tables in marching order ----------------------------------
    order = torch.where(info["dir_row"][:, None], s_ids, smax - 1 - s_ids)
    key = torch.where(active, order, 1 << 20)
    sort_idx = torch.argsort(key, dim=1, stable=True)
    act_sorted = active.gather(1, sort_idx)
    n_act = active.sum(1, dtype=torch.int32)
    slab_sorted = s_ids.expand(active.shape).gather(1, sort_idx)
    yb_sorted = info["yb_s"].gather(1, sort_idx)
    zb_sorted = info["zb_s"].gather(1, sort_idx)
    pack = torch.where(act_sorted, _slot_pack(slab_sorted, yb_sorted, zb_sorted), 0)
    zeros = torch.zeros_like(n_act)
    header = torch.stack([n_act, info["axis_r"], info["nx_r"], info["ny_r"], info["nz_r"], zeros, zeros, zeros], 1)
    tab = torch.cat([header, pack.to(torch.int32)], 1).contiguous()

    half = (res * 0.5).expand(R, LANES)
    used = [info["y0c"], info["sy"], info["z0c"], info["sz"], info["tc0"], info["tc1"], t_start, t_end, half]
    ch = torch.stack(used + [torch.zeros_like(t_start)] * (NCH - len(used)), 1).contiguous()

    # transposed volumes, made only for an axis some live row marches
    vols = []
    profiling.count("sync.render.tables_axis_any", sum(supported))
    for a in range(3):
        needed = supported[a] and bool(((info["axis_r"] == a) & (info["n_live"] > 0)).any())
        vols.append(values.permute(_perm(a)).contiguous() if needed else None)
    return PlaneTables(tab, ch, tuple(vols), unresolved_row, info)


# ---- K8: the sweep over the slot tables -------------------------------------


def plane_sweep_rows_plain(tab, ch, vols, eps: float, t_max: float):
    """The plain version of K8: the TPU kernel body (``_make_kernel``) in its
    production setting (secant refinement, graze probes, entry/exit
    virtual samples, early row exit), vectorised over the running rows with
    a loop over slot index s.

    Per row r (``tab[r]`` = header + slots, ``ch[r]`` = the 128 rays'
    channels), walk the active slabs in table order while some lane is not
    dead (hit, or past its window), sampling each slab's 17 plane crossings
    with a center-corrected bilinear of the 4 corner cells. Per pair of
    planes: a sign crossing, or a graze (a deep dip of the pair's
    frozen-corner model at three probes between two samples above eps); the
    first candidate along the marching direction gives the hit, refined by
    a secant. The first sample of a ray (immediate hit), its window's entry
    and exit (the first/last pair's model extrapolated) are checked too,
    with priority entry < immediate < in-slab < exit. Model bits: 1 entry
    hit without an exact witness, 2 graze hit, 4 exit hit. tnear: the
    smallest pair start (clamped >= 0) whose samples or probes dipped below
    eps + res/2. Returns (depth f32, hit i32, steps i32, model i32, tnear
    f32, exec i32), each [R, 128]; exec is the row's executed-slab count.

    Not carried over from the TPU kernel: the band DMAs, their semaphores
    and double buffering, and the lane-gather workarounds (``_taa_lanes``,
    ``_corner_gather``): corners are read from the field directly; the
    ``_out_struct`` shard_map plumbing; the ``PS_PROBES``, ``PS_EE``,
    ``PS_NOSEL``, ``PS_TAIL`` and ``PS_REFINE_MODE`` measurement knobs; the
    ``"bisect"`` cubic refinement, which production does not use."""
    R = tab.shape[0]
    dev = ch.device
    f32, i32 = torch.float32, torch.int32
    n_act = tab[:, 0]
    depth = torch.full((R, LANES), t_max, dtype=f32, device=dev)
    hitm = torch.zeros((R, LANES), dtype=i32, device=dev)
    steps = torch.zeros_like(hitm)
    sampled = torch.zeros_like(hitm)
    modelm = torch.zeros_like(hitm)
    tnear = torch.full((R, LANES), BIGF, dtype=f32, device=dev)
    dead = torch.zeros_like(hitm)
    exec_n = torch.zeros(R, dtype=i32, device=dev)
    p9 = torch.arange(PB, dtype=i32, device=dev)[None, :, None]
    p8 = p9[:, :SLAB]
    vol_flat = [None if v is None else v.reshape(-1) for v in vols]

    for s in range(int(n_act.max()) if R else 0):
        running = (s < n_act) & (dead == 0).any(1)
        rows = running.nonzero()[:, 0]
        if rows.numel() == 0:
            break
        exec_n[rows] += 1
        t = tab[rows]
        axis = t[:, 1]
        nx, ny, nz = (t[:, k, None, None] for k in (2, 3, 4))
        c = ch[rows]
        y0, sy, z0, sz, tc0, tc1, t_start, t_end, half = (c[:, k, None, :] for k in range(9))
        hm, dp, sm, mm, tn, dd = (x[rows][:, None, :] for x in (hitm, depth, sampled, modelm, tnear, dead))
        dirpos = tc1 > 0.0

        pack = t[:, HDR + s, None, None]
        zb = (pack % 32) * 128
        yb = ((pack // 32) % 256) * 8
        slab = pack // (32 * 256)
        xb = torch.minimum(slab * SLAB, nx - PB)

        # ---- the 17 plane crossings ------------------------------------
        gx = xb + p9  # [r, 17, 1]
        ux = gx.to(f32) + 0.5
        ty = tc0 + tc1 * ux
        uy = y0 + sy * ux
        uz = z0 + sz * ux
        valid = (
            (ty >= t_start) & (ty <= t_end) & (gx >= 0) & (gx <= nx - 1)
            & (uy >= 0.0) & (uy < ny.to(f32)) & (uz >= 0.0) & (uz < nz.to(f32))
        )
        zero = torch.zeros_like(ny)
        loy = torch.clamp(floor_to_int32(uy - 0.5), min=zero, max=ny - 2)
        loz = torch.clamp(floor_to_int32(uz - 0.5), min=zero, max=nz - 2)
        wy = uy - 0.5 - loy.to(f32)
        wz = uz - 0.5 - loz.to(f32)
        ryb = loy - yb
        rzb = loz - zb
        valid = valid & (ryb >= 0) & (ryb <= BY - 2) & (rzb >= 0) & (rzb <= BZ - 2)
        # corner cells, clipped into the band as the TPU gathers them (a
        # clipped corner belongs to an invalid plane, whose value is unused)
        yc = yb + ryb.clamp(0, BY - 2)
        zc = zb + rzb.clamp(0, BZ - 2)
        base = ((gx * ny + yc) * nz + zc).long()
        corners = []
        for off in (0, 1, nz, nz + 1):
            idx = base + off
            v = torch.zeros(idx.shape, dtype=f32, device=dev)
            for a in range(3):
                on = (axis == a)[:, None, None]
                if vol_flat[a] is not None:
                    v = torch.where(on, vol_flat[a].take(torch.where(on, idx, 0)), v)
            corners.append(torch.where(v >= 0.0, v - half, v + half))
        c00, c01, c10, c11 = corners
        d9 = c00 * (1 - wy) * (1 - wz) + c01 * (1 - wy) * wz + c10 * wy * (1 - wz) + c11 * wy * wz
        d9 = torch.where(valid, d9, BIGF)

        # ---- pairs (plane q, plane q+1) ---------------------------------
        dlow, dhigh = d9[:, :SLAB], d9[:, 1:]
        tlow, thigh = ty[:, :SLAB], ty[:, 1:]
        vlow, vhigh = valid[:, :SLAB], valid[:, 1:]
        gxq = gx[:, :SLAB]
        own = (gxq >= slab * SLAB) & (gxq < slab * SLAB + SLAB)
        din = torch.where(dirpos, dlow, dhigh)
        dout = torch.where(dirpos, dhigh, dlow)
        ta = torch.where(dirpos, tlow, thigh)
        tb = torch.where(dirpos, thigh, tlow)
        pair_valid = own & vlow & vhigh
        cross = pair_valid & (din >= eps) & (dout < eps)
        gxq_f = gxq.to(f32)
        planes = (c00, c01, c10, c11, loy.to(f32), loz.to(f32))

        def bil(cs, ly, lz, uym, uzm):
            wy_ = uym - 0.5 - ly
            wz_ = uzm - 0.5 - lz
            return cs[0] * (1 - wy_) * (1 - wz_) + cs[1] * (1 - wy_) * wz_ + cs[2] * wy_ * (1 - wz_) + cs[3] * wy_ * wz_

        def model(a_planes, b_planes, gxa, tt):
            """Frozen-corner model of the pair (A = lower plane, B = upper)
            at t: (1 - wx) * bilinear_A + wx * bilinear_B."""
            uxm = (tt - tc0) / tc1
            uym = y0 + sy * uxm
            uzm = z0 + sz * uxm
            wxm = uxm - (gxa + 0.5)
            return (1 - wxm) * bil(a_planes[:4], *a_planes[4:], uym, uzm) + wxm * bil(b_planes[:4], *b_planes[4:], uym, uzm)

        a_all = [x[:, :SLAB] for x in planes]
        b_all = [x[:, 1:] for x in planes]
        spacing = tc1.abs()
        tq1 = ta + 0.25 * (tb - ta)
        tmid = 0.5 * (ta + tb)
        tq3 = ta + 0.75 * (tb - ta)
        dq1 = model(a_all, b_all, gxq_f, tq1)
        dmid = model(a_all, b_all, gxq_f, tmid)
        dq3 = model(a_all, b_all, gxq_f, tq3)
        dip_t = torch.where(dq1 < eps, tq1, torch.where(dmid < eps, tmid, torch.where(dq3 < eps, tq3, BIGF)))
        dip_min = torch.minimum(dq1, torch.minimum(dmid, dq3))
        # graze: only a deep dip (model below eps - res) between two samples
        # above eps; shallow dips are left to tnear and the tail
        deep = dip_min < eps - 2.0 * half
        graze = (
            pair_valid & ~cross & (din >= eps) & (dout >= eps)
            & (torch.minimum(din, dout) < 1.1 * spacing) & (dip_t < BIGF) & deep
        )
        nm_thresh = eps + 0.5 * (2.0 * half)
        dmin_pair = torch.minimum(torch.minimum(din, dout), dip_min)
        near_c = torch.where(pair_valid & (dmin_pair < nm_thresh), torch.clamp(ta, min=0.0), BIGF)
        new_tnear = torch.minimum(tn, near_c.amin(1, keepdim=True))
        cand = cross | graze
        tb_eff = torch.where(graze, dip_t, tb)

        # first candidate pair along the marching direction, secant to eps
        rank = torch.where(dirpos, p8, SLAB - 1 - p8)
        minkey = torch.where(cand, rank, 99).amin(1, keepdim=True)
        found = (minkey < 99) & (hm == 0)
        q_sel = torch.where(dirpos, minkey, SLAB - 1 - minkey).clamp(0, SLAB - 1).long()
        d_eff = torch.where(graze, dip_min, dout)
        den = torch.clamp(din - d_eff, min=1e-20)
        t_sec = ta + (tb_eff - ta) * (din - eps) / den
        t_hit = t_sec.gather(1, q_sel)
        graze_sel = graze.gather(1, q_sel) & (minkey < 99)

        # first / last valid plane along the marching direction
        rank9 = torch.where(dirpos, p9, PB - 1 - p9)
        mk9 = torch.where(valid, rank9, 99).amin(1, keepdim=True)
        mx9 = torch.where(valid, rank9, -1).amax(1, keepdim=True)
        has_sample = mk9 < 99
        pf = torch.where(dirpos, mk9, PB - 1 - mk9).clamp(0, PB - 1)
        pl = torch.where(dirpos, mx9, PB - 1 - mx9).clamp(0, PB - 1)
        firstd = torch.where(has_sample, d9.gather(1, pf.long()), 0.0)
        firstt = torch.where(has_sample, ty.gather(1, pf.long()), 0.0)
        lastd = torch.where(has_sample, d9.gather(1, pl.long()), 0.0)
        lastt = torch.where(has_sample, ty.gather(1, pl.long()), 0.0)
        pfv = torch.where(has_sample, pf, 0)
        plv = torch.where(has_sample, pl, 0)

        def t_at_eps(t0, d0, t1, d1):
            dd_ = torch.where((d0 - d1).abs() > 1e-20, d0 - d1, 1e-20)
            return t0 + (t1 - t0) * (d0 - eps) / dd_

        def pair_model(pair):
            """The model of pair ``pair`` [r, 1, 128] as a function of t."""
            ia, ib = pair.long(), pair.long() + 1
            pa = [x.gather(1, ia) for x in planes]
            pb = [x.gather(1, ib) for x in planes]
            gxa = (xb + pair).to(f32)
            return lambda tt: model(pa, pb, gxa, tt)

        pv8 = vlow & vhigh

        # ---- entry / exit virtual samples -----------------------------
        fresh = (sm == 0) & has_sample & (hm == 0)
        near_entry = (firstt - t_start) <= 1.5 * spacing
        pair_e = torch.where(dirpos, pfv, pfv - 1).clamp(0, SLAB - 1)
        e_ok = fresh & near_entry & pv8.gather(1, pair_e.long())
        dh_e = pair_model(pair_e)
        d_entry = dh_e(t_start)
        t_mid_e = 0.5 * (t_start + firstt)
        d_mid_e = dh_e(t_mid_e)
        entry_hit = e_ok & (d_entry < eps)
        entry_graze = e_ok & ~entry_hit & (firstd >= eps) & (d_mid_e < eps)
        t_entry_hit = torch.where(entry_hit, t_start, t_at_eps(t_start, d_entry, t_mid_e, d_mid_e))

        pair_x = torch.where(dirpos, plv - 1, plv).clamp(0, SLAB - 1)
        exiting = has_sample & (hm == 0) & (t_end < lastt + spacing) & pv8.gather(1, pair_x.long())
        dh_x = pair_model(pair_x)
        d_exit = dh_x(t_end)
        t_mid_x = 0.5 * (lastt + t_end)
        d_mid_x = dh_x(t_mid_x)
        exit_cross = exiting & (lastd >= eps) & (d_exit < eps)
        exit_graze = exiting & (lastd >= eps) & (d_exit >= eps) & (d_mid_x < eps)
        t_exit_hit = torch.where(
            exit_cross, t_at_eps(lastt, lastd, t_end, d_exit), t_at_eps(lastt, lastd, t_mid_x, d_mid_x)
        )

        imm = fresh & (firstd < eps)
        any_entry = entry_hit | entry_graze
        any_exit = exit_cross | exit_graze
        new_depth = torch.where(
            any_entry, t_entry_hit,
            torch.where(imm, firstt, torch.where(found, t_hit, torch.where(any_exit, t_exit_hit, dp))),
        )
        new_hit = hm | (any_entry | imm | found | any_exit).to(i32)
        unhit = hm == 0
        new_model = (
            mm
            | torch.where(unhit & any_entry & ~imm, 1, 0)
            | torch.where(unhit & found & graze_sel, 2, 0)
            | torch.where(unhit & any_exit, 4, 0)
        )
        new_steps = steps[rows][:, None, :] + (valid & unhit).sum(1, keepdim=True, dtype=i32)
        xbf = xb.to(f32)
        t_reach = torch.where(dirpos, tc0 + tc1 * (xbf + (PB - 0.5)), tc0 + tc1 * (xbf + 0.5))
        new_dead = dd | new_hit | (t_reach >= t_end).to(i32)

        depth[rows] = new_depth[:, 0]
        hitm[rows] = new_hit[:, 0]
        steps[rows] = new_steps[:, 0]
        sampled[rows] = (sm | has_sample.to(i32))[:, 0]
        modelm[rows] = new_model[:, 0].to(i32)
        tnear[rows] = new_tnear[:, 0]
        dead[rows] = new_dead[:, 0]
    return depth, hitm, steps, modelm, tnear, exec_n[:, None].expand(R, LANES).contiguous()


def slab_footprints(tab, ch, vols, exec_rows, chunk: int = 2048) -> dict:
    """What K8 reads and computes in each slab a row executed (``s <
    exec_rows[r]``, in table order). Returns [E] int64 tensors over the E
    executed (row, slot) pairs: ``row``, ``slot``, ``xb`` (the slab's first
    plane); ``p0``/``p1`` (first and last plane with a valid sample; p1 < p0
    when none) and ``y0``/``y1``, ``z0``/``z1`` (the corner cells read,
    inclusive: every read of the slab, the entry and exit models' re-reads
    included, lies in this box); ``samples`` (valid lane-planes) and
    ``pairs`` (valid lane-pairs, each of which runs three model probes)."""
    dev = tab.device
    f32, i64 = torch.float32, torch.int64
    R, width = tab.shape
    slot = torch.arange(width - HDR, device=dev)[None, :]
    rows, slots = (slot < exec_rows.to(dev)[:, None]).nonzero(as_tuple=True)
    keys = ("xb", "p0", "p1", "y0", "y1", "z0", "z1", "samples", "pairs")
    out = {k: [] for k in keys}
    big = 1 << 30
    p9 = torch.arange(PB, device=dev)[None, :, None]
    for lo in range(0, rows.numel(), chunk):
        r, s = rows[lo : lo + chunk], slots[lo : lo + chunk]
        t = tab[r].to(i64)
        nx, ny, nz = (t[:, k, None, None] for k in (2, 3, 4))
        pack = t.gather(1, (HDR + s)[:, None])[:, :, None]
        zb = (pack % 32) * 128
        yb = ((pack // 32) % 256) * 8
        slab = pack // (32 * 256)
        xb = torch.minimum(slab * SLAB, nx - PB)
        c = ch[r]
        y0, sy, z0, sz, tc0, tc1, t_start, t_end = (c[:, k, None, :] for k in range(8))
        gx = xb + p9  # [e, 17, 1]
        ux = gx.to(f32) + 0.5
        ty = tc0 + tc1 * ux
        uy = y0 + sy * ux
        uz = z0 + sz * ux
        valid = (
            (ty >= t_start) & (ty <= t_end) & (gx >= 0) & (gx <= nx - 1)
            & (uy >= 0.0) & (uy < ny.to(f32)) & (uz >= 0.0) & (uz < nz.to(f32))
        )
        zero = torch.zeros_like(ny)
        loy = torch.clamp(floor_to_int32(uy - 0.5).to(i64), min=zero, max=ny - 2)
        loz = torch.clamp(floor_to_int32(uz - 0.5).to(i64), min=zero, max=nz - 2)
        valid &= (loy - yb >= 0) & (loy - yb <= BY - 2) & (loz - zb >= 0) & (loz - zb <= BZ - 2)
        own = (gx[:, :SLAB] >= slab * SLAB) & (gx[:, :SLAB] < slab * SLAB + SLAB)
        out["xb"].append(xb[:, 0, 0])
        out["p0"].append(torch.where(valid, p9, big).amin(dim=(1, 2)))
        out["p1"].append(torch.where(valid, p9, -1).amax(dim=(1, 2)))
        out["y0"].append(torch.where(valid, loy, big).amin(dim=(1, 2)))
        out["y1"].append(torch.where(valid, loy + 1, -1).amax(dim=(1, 2)))
        out["z0"].append(torch.where(valid, loz, big).amin(dim=(1, 2)))
        out["z1"].append(torch.where(valid, loz + 1, -1).amax(dim=(1, 2)))
        out["samples"].append(valid.sum(dim=(1, 2)))
        out["pairs"].append((own & valid[:, :SLAB] & valid[:, 1:]).sum(dim=(1, 2)))
    res = {k: torch.cat(v) if v else torch.zeros(0, dtype=i64, device=dev) for k, v in out.items()}
    res["row"], res["slot"] = rows, slots
    return res


def _check_rows_inputs(tab, ch, vols) -> None:
    if tab.dtype != torch.int32 or tab.ndim != 2 or tab.shape[1] <= HDR or not tab.is_contiguous():
        raise ValueError(f"plane_sweep_rows: tab must be contiguous int32 [R, {HDR} + smax], got {tab.dtype} {tuple(tab.shape)}")
    if ch.dtype != torch.float32 or tuple(ch.shape) != (tab.shape[0], NCH, LANES) or not ch.is_contiguous():
        raise ValueError(f"plane_sweep_rows: ch must be contiguous float32 [R, {NCH}, {LANES}], got {ch.dtype} {tuple(ch.shape)}")
    if ch.device != tab.device:
        raise ValueError(f"plane_sweep_rows: tab on {tab.device}, ch on {ch.device}")
    if len(vols) != 3:
        raise ValueError("plane_sweep_rows: vols must hold one entry per marching axis")
    for v in vols:
        if v is not None and (v.dtype != torch.float32 or v.ndim != 3 or not v.is_contiguous() or v.device != tab.device):
            raise ValueError("plane_sweep_rows: each volume must be a contiguous float32 [X, Y, Z] tensor on tab's device")


def plane_sweep_rows(tab, ch, vols, eps: float, t_max: float):
    """K8: the sweep of ``plane_sweep_rows_plain`` for every row. On a CPU
    tensor the plain version; on a CUDA tensor the kernel
    ``csrc/render_plane.cu`` (one block of 128 threads per row, the rows
    launched most slots first, the field read through L1), which raises if
    the launch fails. ``vols[a]`` must be given for every axis a that a row
    with active slots marches (``plane_sweep_tables`` does so)."""
    _check_rows_inputs(tab, ch, vols)
    if tab.device.type == "cpu":
        return plane_sweep_rows_plain(tab, ch, vols, eps, t_max)
    R, width = tab.shape
    if width * 4 > 48 * 1024:
        raise ValueError(f"plane_sweep_rows: {width - HDR} slots per row exceed the kernel's shared-memory table")
    depth = torch.empty((R, LANES), dtype=torch.float32, device=tab.device)
    outs = [depth] + [torch.empty((R, LANES), dtype=torch.int32, device=tab.device) for _ in range(3)]
    outs += [torch.empty_like(depth), torch.empty((R, LANES), dtype=torch.int32, device=tab.device)]
    if R:
        # scratch for the kernel's row order (most slots first: the longest
        # rows start early instead of finishing the launch alone)
        order = torch.empty(R, dtype=torch.int32, device=tab.device)
        _build.launch(
            "plane_sweep", tab.device, "sdf_plane_sweep",
            tab.data_ptr(), width, ch.data_ptr(), *[None if v is None else v.data_ptr() for v in vols],
            float(eps), float(t_max), R, order.data_ptr(), *[o.data_ptr() for o in outs],
        )
    return tuple(outs)


# ---- the exact verification tail -------------------------------------------


def _compact_indices(mask: torch.Tensor, K: int, priority=None):
    """First-K (or two-class priority-ranked) true indices of ``mask``: an
    exclusive cumsum gives each true element its slot, a scatter into K + 1
    slots with the last dropped makes the list. With ``priority`` (>= 2 is
    the high class), high-class elements fill first. Returns (idxs [K]
    int64, sel [K] bool, overflow [N] bool); unfilled slots hold index 0."""
    N = mask.shape[0]
    if priority is None:
        m = mask.to(torch.int32)
        pos = torch.cumsum(m, 0, dtype=torch.int32) - m
        ok = mask & (pos < K)
    else:
        hi = priority >= 2
        lo = mask & ~hi
        mh = hi.to(torch.int32)
        ph = torch.cumsum(mh, 0, dtype=torch.int32) - mh
        n_hi = torch.clamp(mh.sum(dtype=torch.int32), max=K)
        ml = lo.to(torch.int32)
        plo = torch.cumsum(ml, 0, dtype=torch.int32) - ml + n_hi
        pos = torch.where(hi, ph, plo)
        ok = (hi & (ph < K)) | (lo & (plo < K))
    slot = torch.where(ok, pos, K).long()
    profiling.count("sync.render.compact_gather", 3)  # three boolean-mask gathers
    profiling.count("sync.render.compact_fill")  # and ``True`` copied from the host to fill ``sel``
    idxs = torch.zeros(K + 1, dtype=torch.int64, device=mask.device)
    idxs[slot[ok]] = torch.arange(N, device=mask.device)[ok]
    sel = torch.zeros(K + 1, dtype=torch.bool, device=mask.device)
    sel[slot[ok]] = True
    return idxs[:K], sel[:K], mask & ~ok


class TailResult(NamedTuple):
    depth: torch.Tensor  # [N] f32
    hit: torch.Tensor  # [N] bool
    unresolved: torch.Tensor  # [N] bool: unresolved rows and resume-budget overflow
    n_flagged: torch.Tensor
    n_near: torch.Tensor
    n_resumed: torch.Tensor


def verify_tail(values, meta, origins, directions, tc1, unresolved, kernel_out, t_min, t_max, eps, max_steps, min_step):
    """The exact verification and recovery passes after the sweep, on padded
    rays [N, 3] (the JAX package's ``_plane_sweep_core`` tail):

    1. hits a frozen-corner model proposed (model bits) are re-checked with
       25 exact trilinear samples across depth +- 1.25 spacings: confirmed
       at the first sample below eps, or demoted to a miss (KR rays);
    2. near misses (tnear set, no hit) and hits with a near dip clearly
       before their depth are re-checked the same way around tnear (KN
       rays, misses first);
    3. demoted rays and both passes' budget overflows are traced again by
       the exact march from t_min (KD rays; beyond that they join the
       unresolved rays). When no ray needs it the march is skipped: its
       result would be discarded.

    Only the selected slots write back. (The JAX package also scatters its
    unfilled slots, which hold index 0, with ray 0's old value; XLA applies
    duplicates in no stated order, so ray 0 could lose its update there.)"""
    from . import render

    depth_k, hit_k, _, model_k, tnear_k, _ = kernel_out
    N = origins.shape[0]
    f32 = torch.float32
    depth_f = depth_k.reshape(N).clone()
    hit_f = hit_k.reshape(N) > 0
    model_bits = model_k.reshape(N)
    tnear_f = tnear_k.reshape(N)
    res = meta.resolution.to(values.device)
    profiling.count("sync.render.tail_consts", 3)  # three host constants copied to the device
    spacing_f = torch.clamp(tc1.reshape(N).abs(), min=torch.sqrt(torch.tensor(3.0, device=values.device)) * res)
    sdf_v = SdfGrid(values, meta, torch.tensor(math.inf, dtype=f32, device=values.device))
    offs = torch.tensor(_WINDOW_OFFSETS, dtype=f32, device=values.device)

    def exact_window(idxs, t_center, active):
        """(any exact sample below eps, the first such t) over the window's
        samples across t_center +- 1.25 spacings, for the selected rays."""
        o_s, v_s = origins[idxs], directions[idxs]
        tsmp = t_center[:, None] + offs[None, :] * spacing_f[idxs][:, None]
        pts = o_s[:, None, :] + tsmp[..., None] * v_s[:, None, :]
        dsm, oksm = query._distance_at(sdf_v, pts)
        below = active[:, None] & oksm & (dsm < eps) & (tsmp >= t_min) & (tsmp <= t_max)
        first = below.to(torch.int8).argmax(1)
        return below.any(1), tsmp.gather(1, first[:, None])[:, 0]

    # -- pass 1: verify model-proposed hits
    flagged = hit_f & (model_bits > 0)
    idxs, f_sel, kr_overflow = _compact_indices(flagged, min(KR, N))
    anyb, t_ver = exact_window(idxs, depth_f[idxs], f_sel)
    confirmed = f_sel & anyb
    profiling.count("sync.render.tail_gather", 4)  # pass 1's boolean-mask gathers
    w = idxs[f_sel]
    hit_f[w] = confirmed[f_sel]
    depth_f[w] = torch.where(confirmed, t_ver, t_max)[f_sel]
    demoted = torch.zeros(N, dtype=torch.bool, device=values.device)
    demoted[w] = ~anyb[f_sel]

    # -- pass 2: verify near misses (and early near dips of hits)
    has_near = tnear_f < 0.5 * BIGF
    nm_miss = has_near & ~hit_f & ~unresolved
    nm_redate = has_near & hit_f & (tnear_f < depth_f - 4.0 * spacing_f) & ~unresolved
    nm_mask = nm_miss | nm_redate
    prio = 2 * nm_miss.to(torch.int32) + nm_redate.to(torch.int32)
    nm_idxs, nm_sel, nm_overflow_all = _compact_indices(nm_mask, min(KN, N), prio)
    nm_overflow = nm_overflow_all & ~hit_f
    nm_anyb, nm_t = exact_window(nm_idxs, tnear_f[nm_idxs], nm_sel)
    nm_conf = nm_sel & nm_anyb
    profiling.count("sync.render.tail_gather", 5)  # pass 2's
    w = nm_idxs[nm_sel]
    old_depth = depth_f[w]
    hit_f[w] = hit_f[w] | nm_conf[nm_sel]
    depth_f[w] = torch.where(nm_conf[nm_sel], torch.minimum(old_depth, nm_t[nm_sel]), old_depth)
    nm_confirmed = torch.zeros(N, dtype=torch.bool, device=values.device)
    nm_confirmed[w] = nm_conf[nm_sel]

    # -- pass 3: exact march from t_min for demoted / overflow rays
    march_mask = (demoted & ~nm_confirmed) | kr_overflow | nm_overflow
    md_idxs, md_sel, md_overflow = _compact_indices(march_mask, min(KD, N))
    unresolved = unresolved | md_overflow
    n_resumed = march_mask.sum()
    profiling.count("sync.render.tail_resume_any")
    if bool(md_sel.any()):
        profiling.count("sync.render.tail_gather")
        w = md_idxs[md_sel]
        profiling.count("render.march_rays", w.shape[0])
        d_m, h_m, _ = render._trace_depth(
            sdf_v, origins[w], directions[w], t_min, t_max, eps, max_steps, min_step, coarse=False
        )
        hit_f[w] = h_m
        depth_f[w] = torch.where(h_m, d_m, t_max)
    return TailResult(depth_f, hit_f, unresolved, flagged.sum(), nm_mask.sum(), n_resumed)


# ---- the whole path ----------------------------------------------------------


class PlaneRays(NamedTuple):
    origins: torch.Tensor  # [Np, 3] f32, tile-regrouped and padded
    directions: torch.Tensor
    batch_shape: tuple
    tiled: bool  # regrouped into 8x16 tiles
    n: int  # rays before padding


def prepare_rays(origins, directions) -> PlaneRays:
    """Flatten, regroup (h, w, 3) bundles with h % 8 == 0 and w % 16 == 0
    into 8x16 pixel tiles (a 1x128 scanline diverges far more than a tile
    and overflows the band), and pad to a multiple of 128 rays with rays
    that miss the grid."""
    o = origins.to(torch.float32)
    v = directions.to(torch.float32)
    batch_shape = tuple(o.shape[:-1])
    of = o.reshape(-1, 3)
    vf = v.reshape(-1, 3)
    n = of.shape[0]
    tiled = len(batch_shape) >= 2 and batch_shape[-2] % 8 == 0 and batch_shape[-1] % 16 == 0
    if tiled:
        of = tile_regroup(of, *batch_shape[-2:])
        vf = tile_regroup(vf, *batch_shape[-2:])
    pad = -n % LANES
    if pad:
        profiling.count("sync.render.pad", 2)  # two host rows copied to the device
        of = torch.cat([of, of.new_tensor([-1e6, -1e6, -1e6]).expand(pad, 3)])
        vf = torch.cat([vf, vf.new_tensor([1.0, 0.0, 0.0]).expand(pad, 3)])
    return PlaneRays(of.contiguous(), vf.contiguous(), batch_shape, tiled, n)


def _restore(x: torch.Tensor, rays: PlaneRays) -> torch.Tensor:
    x = x[: rays.n]
    if rays.tiled:
        x = tile_ungroup(x, *rays.batch_shape[-2:])
    return x.reshape(rays.batch_shape)


def plane_sweep_depth(
    sdf: SdfGrid,
    origins: torch.Tensor,
    directions: torch.Tensor,
    t_min: float,
    t_max: float,
    eps: float,
    max_steps: int,
    min_step,
    diag: bool = False,
):
    """Plane-sweep depth with the exact march for unresolved rays. Same
    contract as ``render._trace_depth``: (depth, hit, steps) shaped like the
    rays; steps are the sweep's valid samples (or the march's advances for
    unresolved rays). With ``diag=True`` a dict of counts is appended (the
    JAX package's keys)."""
    from . import render

    values, meta = sdf.values, sdf.meta
    rays = prepare_rays(origins, directions)
    of, vf = rays.origins, rays.directions
    with profiling.span("render.plane.tables"):
        tables = plane_sweep_tables(values, meta, of, vf, t_min, t_max)
    with profiling.span("render.plane.sweep"):
        kernel_out = plane_sweep_rows(tables.tab, tables.ch, tables.vols, eps, t_max)
    with profiling.span("render.plane.tail"):
        unresolved = tables.unresolved_row[:, None].expand(-1, LANES).reshape(-1)
        tail = verify_tail(
            values, meta, of, vf, tables.info["tc1"], unresolved, kernel_out, t_min, t_max, eps, max_steps, min_step
        )
        depth, hit, unresolved = tail.depth, tail.hit, tail.unresolved
        steps = kernel_out[2].reshape(-1).clone()

    # the exact march for unresolved rays (the JAX package's lax.cond); each
    # ray's march is independent of the others, so only those rays are traced
    with profiling.span("render.plane.fallback"):
        profiling.count("sync.render.fallback_any")
        if bool(unresolved.any()):
            profiling.count("sync.render.fallback_nonzero")
            w = unresolved.nonzero()[:, 0]
            profiling.count("render.march_rays", w.shape[0])
            d, h, st = render._trace_depth(sdf, of[w], vf[w], t_min, t_max, eps, max_steps, min_step)
            depth[w], hit[w], steps[w] = d, h, st

    out = (_restore(depth, rays), _restore(hit, rays), _restore(steps, rays))
    if not diag:
        return out
    model_bits = kernel_out[3].reshape(-1)
    return out + (
        {
            "unresolved": unresolved.sum(),
            "n_act": tables.tab[:, 0].sum(),
            "n_flagged": tail.n_flagged,
            "n_near_miss": tail.n_near,
            "n_resumed": tail.n_resumed,
            "n_entry": ((model_bits & 1) > 0).sum(),
            "n_graze": ((model_bits & 2) > 0).sum(),
            "n_exit": ((model_bits & 4) > 0).sum(),
            "exec_slabs": kernel_out[5][:, 0].sum(),
        },
    )
