"""The parts the render-design probes share (``probe_smem_block``,
``probe_dma_align``, ``bench_micro_render`` and ``bench_micro_render2`` to
``6``): the plane sweep's sampler and the one summation order, written
once; the plain versions and kernel launches of the three kernels of
``csrc/micro_render.cu``; and the factories of their ``_micro.Probe``
records.

**The sampler** of a ray row (128 rays, one a lane): the band base (the
row's least floor(y) rounded down to 8 and floor(z) to 128, or a table's
entry rounded so), the per-lane column gathers at zi and zi + 1 and the
one-hot row selects at ry and ry + 1 (sums with one nonzero term, so
exactly the selected value, taken here by index), and the bilinear combine
``v00*(1-fy)*(1-fz) + v01*(1-fy)*fz + v10*fy*(1-fz) + v11*fy*fz``
evaluated left to right. A dynamic slice's start is clamped into the data,
as ``lax.dynamic_slice`` clamps it.

**The summation order** (``ordered_sum``), the kernels' and every plain
version's: lane t of 128 adds the elements t, t + 128, ... of the row-major
band in order from 0.0, then the tree p[t] += p[t + w] for w = 64, ..., 1.
The TPU probes' loops are chains (``chain``): acc = acc + term in their
order; a nested probe (R1-R3) starts each step's chain at 0.0 and adds it
to the total. Every step of R1-R3 samples the same rays, so the plain
versions and the kernels compute a step's chain once and add it ``steps``
times, and a band sum's plain version sums each distinct band once (its
items' bands repeat): the same adds as the kernels'.

**The launch** (``render_geometry``): the kernels cut an instance's items
into tiles of consecutive items, a block each, ceil(4 x SMs / B) tiles an
instance and one from B_fill on; each item's addends go to a buffer of
terms (``torch.empty``, written before it is read), which a second kernel
of the same C call chains. R6 ``sample9`` writes per-ray terms only where
an instance takes several blocks, as do R6's copies (``dma``, ``dma_ovl``:
a term a lane an iteration; ``smem_rw``: a block's partial sum, exact
while the total stays below 2^24). S1, S2 and D1 take a block a table
row.

Batches: the data (plane, cube, volume) is one copy for the batch; an
instance's ray rows and tables are rolled (``_micro.ROLL``), so they stay
in the ranges the JAX builders draw from. The plain version of a batch
computes every instance at once, in chunks of items that keep each
temporary under CHUNK_ELEMENTS.

**The bound** counts what the plain versions compute: a band sum's
distinct bands once and one chain add an item; a sampler's distinct items
(a ray row and its bases) once and one chain add an item; R1-R3's steps one
add each. The distinct bands and items are work on the shared data, which a
batch counts once (``_micro.Probe``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from .. import _build
from ..grid import floor_to_int32
from . import _micro

KERNELS = ("micro_band_sum", "micro_sampler", "micro_band_copy")
SOURCE = "sdf_tools_tpu_torch/csrc/micro_render.cu"
LANES = 128
CHUNK_ELEMENTS = 1 << 24  # the largest temporary of a plain version, in elements
R6_BAND = (9, 32, 256)  # R6's band: planes, y, z
EXACT_FLOAT_INT = 1 << 24  # float32 holds every integer below this exactly
C_Y, C_Z = np.float32(0.01), np.float32(0.017)  # R4's per-step position offsets, times k in float32


# ---- the sampler and the summation order -------------------------------------


def ordered_sum(x: torch.Tensor) -> torch.Tensor:
    """The kernels' sum over the last axis (a multiple of 128): lane t adds
    x[t], x[t + 128], ... from 0.0, then p[t] += p[t + w] for w = 64, ..., 1."""
    p = torch.zeros((*x.shape[:-1], LANES), dtype=x.dtype, device=x.device)
    for k in range(0, x.shape[-1], LANES):
        p = p + x[..., k:k + LANES]
    w = LANES // 2
    while w:
        p = p[..., :w] + p[..., w:2 * w]
        w //= 2
    return p[..., 0]


def chain(acc: torch.Tensor, terms: torch.Tensor) -> torch.Tensor:
    """The TPU probes' loop: ``acc = acc + terms[:, j]`` for each j in order."""
    for term in terms.unbind(1):
        acc = acc + term
    return acc


def _floor_div(x: torch.Tensor, d: int) -> torch.Tensor:
    return torch.div(x, d, rounding_mode="floor")


def row_bases(y: torch.Tensor, z: torch.Tensor):
    """A ray row's band base (y [..., 128]): its least floor(y) rounded
    down to 8, its least floor(z) rounded down to 128 (int32 [...])."""
    return (_floor_div(floor_to_int32(y).amin(-1), 8) * 8, _floor_div(floor_to_int32(z).amin(-1), 128) * 128)


def table_bases(ytab: torch.Tensor, ztab: torch.Tensor):
    """A table's band bases: its entries rounded down to 8 and to 128."""
    return _floor_div(ytab, 8) * 8, _floor_div(ztab, 128) * 128


def combine(v00, v01, v10, v11, fy, fz) -> torch.Tensor:
    """The JAX probes' bilinear combine, evaluated left to right."""
    return v00 * (1 - fy) * (1 - fz) + v01 * (1 - fy) * fz + v10 * fy * (1 - fz) + v11 * fy * fz


def sample(data: torch.Tensor, row0, col0, ry, zi, fy, fz) -> torch.Tensor:
    """The bilinear sample of the band at (row0, col0) of ``data`` [R, C]:
    the column gathers at zi and zi + 1 of rows ry and ry + 1 (the one-hot
    row selects' values); row0, col0 broadcast against ry, zi."""
    C = data.shape[-1]
    flat = data.reshape(-1)

    def at(r, c):
        return flat[((row0 + r).long() * C + (col0 + c).long())]

    return combine(at(ry, zi), at(ry, zi + 1), at(ry + 1, zi), at(ry + 1, zi + 1), fy, fz)


def band_sums(data: torch.Tensor, row0, cols, H: int, add=None) -> torch.Tensor:
    """``ordered_sum`` of H-row bands of ``data`` [R, C]: rows row0 .. row0
    + H - 1 ([B, k]), columns ``cols`` ([B, k, W]); ``add`` ([B, k]) added
    to each element first."""
    C = data.shape[-1]
    rows = row0.long()[..., None] + torch.arange(H, device=data.device)
    idx = rows[..., :, None] * C + cols.long()[..., None, :]
    v = data.reshape(-1)[idx.reshape(*idx.shape[:-2], -1)]
    if add is not None:
        v = v + add[..., None]
    return ordered_sum(v)


def render_geometry(batch: int, items: int, sms: int) -> _micro.Geometry:
    """The blocks of a ``micro_band_sum`` or ``micro_sampler`` launch on an
    instance of ``items`` items, args (tiles, chunk): ``tiles`` runs of
    ``chunk`` consecutive items, none empty. FILL_BLOCKS_PER_SM blocks on
    every SM are wanted in all, so an instance takes ceil(that / batch)
    tiles, at most one an item: at B = 1 a probe spreads over about 4 x SMs
    blocks, from B_fill on one block an instance."""
    tiles = min(_micro._ceil(_micro.FILL_BLOCKS_PER_SM * sms, batch), items)
    chunk = _micro._ceil(items, tiles)
    tiles = _micro._ceil(items, chunk)
    return _micro.Geometry(tiles, 1, (tiles, chunk))


def terms_stride(addends: int) -> int:
    """Floats of an instance's terms: its addends padded to 16 bytes, then
    a slot of 4 (the sum of a band that depends on no item)."""
    return -(-addends // 4) * 4 + 4


def _chunks(n: int, per_item: int, batch: int):
    step = max(1, CHUNK_ELEMENTS // max(1, per_item * batch))
    for a in range(0, n, step):
        yield a, min(n, a + step)


def _clamp(x, hi: int):
    return x.clamp(0, max(hi, 0))


def _fl(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32)


# ---- micro_band_sum ---------------------------------------------------------------


@dataclass(frozen=True)
class BandSum:
    """A micro_band_sum variant: the bases from the ray rows ("rays"), a
    table ("table") or none; an H x W band (H = 0: none) at rows from 0 or
    the base (``row_base``), columns from 0 ("zero"), the base ("base") or
    rolled by the base modulo the data's width ("roll"); the base y added
    to each element first (``add_y``); what the chain adds after the band's
    sum (``extra``: "y,z" the y then the z base, "y+z" their int sum, "z",
    "one" 1.0, "" nothing)."""

    base: str | None
    H: int = 0
    W: int = 0
    row_base: bool = True
    cols: str = "base"
    add_y: bool = False
    extra: str = ""


_BASES = {None: 0, "rays": 1, "table": 2}
_COLS = {"zero": 0, "base": 1, "roll": 2}
_EXTRAS = {"": 0, "y,z": 1, "y+z": 2, "z": 3, "one": 4}


def distinct_bands(spec: BandSum, shape, yb, zb):
    """The distinct bands of the items at bases yb, zb (each [B, M]) of
    data of ``shape``, and each item's among them: (keys [n, 3], inverse
    [B * M]). A band is set by its row base, its column base (roll: the z
    base) and, with ``add_y``, the y base added to it; the items' bands
    repeat."""
    R, C = shape
    row0 = _clamp(yb, R - spec.H) if spec.row_base else torch.zeros_like(yb)
    if spec.cols == "roll":
        col = zb
    else:
        col = _clamp(zb, C - spec.W) if spec.cols == "base" else torch.zeros_like(zb)
    keys = torch.stack([row0, col, yb if spec.add_y else torch.zeros_like(yb)], -1).reshape(-1, 3)
    return torch.unique(keys, dim=0, return_inverse=True)


def fixed_band(spec: BandSum) -> bool:
    """Whether the band depends on no item (at (0, 0), no base added): the
    kernel sums it once an instance."""
    return bool(spec.H) and not spec.row_base and spec.cols == "zero" and not spec.add_y


def band_addends(spec: BandSum) -> int:
    """Addends an item stores for the chain: its band's sum (unless fixed)
    and its extras."""
    return int(bool(spec.H) and not fixed_band(spec)) + {"": 0, "y,z": 2, "y+z": 1, "z": 1, "one": 1}[spec.extra]


def band_sum_plain(spec: BandSum, data, y, z, ytab, ztab, steps: int, per_step: int) -> torch.Tensor:
    """micro_band_sum's plain version: [B] totals. data [R, C] (one copy),
    y, z [B, rows, 128], ytab, ztab [B, >= per_step] (flattened)."""
    B = next(t.shape[0] for t in (y, ytab) if t is not None)
    dev = (y if y is not None else ytab).device
    M = per_step
    if spec.base == "rays":
        yb, zb = row_bases(y[:, :M], z[:, :M])
    elif spec.base == "table":
        yb, zb = table_bases(ytab[:, :M], ztab[:, :M])
    else:
        yb = zb = torch.zeros((B, M), dtype=torch.int32, device=dev)
    addends = []
    if spec.H:
        R, C = data.shape
        uniq, inverse = distinct_bands(spec, data.shape, yb, zb)
        j = torch.arange(spec.W, device=dev)
        sums = torch.empty(uniq.shape[0], dtype=torch.float32, device=dev)
        for s, e in _chunks(uniq.shape[0], spec.H * spec.W, 1):
            r0, c, ya = uniq[s:e].unbind(-1)
            cols = torch.remainder(j - c[:, None], C) if spec.cols == "roll" else c[:, None] + j
            sums[s:e] = band_sums(data, r0[None], cols[None], spec.H, _fl(ya)[None] if spec.add_y else None)[0]
        addends.append(sums[inverse].view(B, M))
    if spec.extra == "y,z":
        addends += [_fl(yb), _fl(zb)]
    elif spec.extra == "y+z":
        addends.append(_fl(yb + zb))
    elif spec.extra == "z":
        addends.append(_fl(zb))
    elif spec.extra == "one":
        addends.append(torch.ones((B, M), dtype=torch.float32, device=dev))
    part = chain(torch.zeros(B, dtype=torch.float32, device=dev), torch.stack(addends, -1).reshape(B, -1))
    total = torch.zeros(B, dtype=torch.float32, device=dev)
    for _ in range(steps):
        total = total + part
    return total


def band_sum_kernel(key: str, spec: BandSum, data, y, z, ytab, ztab, steps: int, per_step: int, B: int,
                    dev) -> torch.Tensor:
    out = torch.empty(B, dtype=torch.float32, device=dev)
    R, C = data.shape if data is not None else (0, 0)
    rows = y.shape[1] if y is not None else 0
    tab_len = ytab[0].numel() if ytab is not None else 0
    g = render_geometry(B, per_step, _micro.sm_count(dev))
    stride = terms_stride(per_step * band_addends(spec))
    terms = torch.empty(B * stride, dtype=torch.float32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    _build.launch(f"probe_{key}", dev, "sdf_micro_band_sum", ptr(data), R, C, ptr(y), ptr(z), ptr(ytab), ptr(ztab),
                  out.data_ptr(), terms.data_ptr(), stride, B, steps, per_step, rows, tab_len, _BASES[spec.base],
                  spec.H, spec.W, int(spec.row_base), _COLS[spec.cols], int(spec.add_y), _EXTRAS[spec.extra], *g.args)
    return out


# ---- micro_sampler ------------------------------------------------------------------

VARIANTS = ("full", "static", "loadtaa", "mxu", "tab_full", "sample512", "sample9")


def _ray_terms(variant: str, data, y, z, s: int, e: int):
    """R1 and R2's sampler on ray rows s .. e - 1: its addends [B, k, 1 or 2]."""
    R, C = data.shape
    dev = y.device
    if variant == "static":
        yb = zb = torch.zeros(y.shape[:1] + (e - s,), dtype=torch.int32, device=dev)
    else:
        yb, zb = row_bases(y[:, s:e], z[:, s:e])
    yv, zv = y[:, s:e], z[:, s:e]
    y0, z0 = floor_to_int32(yv), floor_to_int32(zv)
    r0, c0 = _clamp(yb, R - 16), _clamp(zb, C - 256)  # [B, k]
    zi = (z0 - zb[..., None]).clamp(0, 254)  # [B, k, 128]
    ry = (y0 - yb[..., None]).clamp(0, 14)
    fy, fz = yv - _fl(y0), zv - _fl(z0)
    flat = data.reshape(-1)
    rows16 = torch.arange(16, device=dev).view(1, 1, 16, 1)
    band_rows = (r0[:, :, None, None] + rows16).long() * C  # [B, k, 16, 1]
    if variant == "loadtaa":
        # the column gathers over the band's 16 rows, each summed
        return torch.stack([ordered_sum(flat[band_rows + (c0[:, :, None, None] + zi[:, :, None, :] + dz).long()]
                                        .flatten(-2)) for dz in (0, 1)], -1)
    if variant == "mxu":
        # the (16, 256) band times (256, 128) one-hot column selects, then the one-hot row selects
        c = torch.arange(256, device=dev)
        band = flat[band_rows + (c0[:, :, None, None] + c).long()]  # [B, k, 16, 256]
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False  # a float32 product: TF32 would round the band
        try:
            g = [band @ (c.view(1, 1, 256, 1) == (zi + dz)[:, :, None, :]).to(torch.float32) for dz in (0, 1)]
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
        v = [torch.where(rows16 == r[:, :, None, :], gz, 0.0).sum(-2) for r in (ry, ry + 1) for gz in g]
        return ordered_sum(combine(*v, fy, fz))[..., None]
    return ordered_sum(sample(data, r0[..., None], c0[..., None], ry, zi, fy, fz))[..., None]


def _offsets(K: int, dev):
    """R4's position offsets float32(0.01) * k and float32(0.017) * k,
    each product rounded in float32 ([K] each)."""
    return tuple(torch.tensor([np.float32(c * np.float32(k)) for k in range(K)], dtype=torch.float32, device=dev)
                 for c in (C_Y, C_Z))


def sampler_plain(variant: str, data, y, z, ytab, ztab, vol, steps: int, per_step: int, G: int = 0,
                  K: int = 0) -> torch.Tensor:
    """micro_sampler's plain version: [B] totals, or [B, 128] (``sample9``)."""
    B, dev = y.shape[0], y.device
    zero = torch.zeros(B, dtype=torch.float32, device=dev)
    if variant in ("full", "static", "loadtaa", "mxu"):
        per_item = 256 * LANES * 2 + 16 * 256 if variant == "mxu" else 16 * LANES * 2
        terms = torch.cat([_ray_terms(variant, data, y, z, s, e) for s, e in _chunks(per_step, per_item, B)], 1)
        part = chain(zero, terms.reshape(B, -1))
        total = zero
        for _ in range(steps):
            total = total + part
        return total
    if variant == "tab_full":
        R, C = data.shape
        rows = per_step // (G * K)
        ck, dk = (c.view(1, 1, 1, K, 1) for c in _offsets(K, dev))
        acc = zero
        for s, e in _chunks(rows, G * K * LANES * 8, B):
            yb, zb = table_bases(ytab.view(B, -1, G)[:, s:e], ztab.view(B, -1, G)[:, s:e])  # [B, r, G]
            yv = y[:, s:e, None, None, :] + ck  # [B, r, 1, K, 128]
            zv = z[:, s:e, None, None, :] + dk
            y0, z0 = floor_to_int32(yv), floor_to_int32(zv)
            yb5, zb5 = yb[..., None, None], zb[..., None, None]
            zi = (z0 - zb5).clamp(0, 254)
            ry = (y0 - yb5).clamp(0, 22)
            F = sample(data, _clamp(yb5, R - 24), _clamp(zb5, C - 256), ry, zi, yv - _fl(y0), zv - _fl(z0))
            acc = chain(acc, ordered_sum(F).reshape(B, -1))
        return acc
    if variant == "sample512":
        R, C = data.shape
        acc = zero
        for s, e in _chunks(per_step, LANES * 8, B):
            yb, _ = table_bases(ytab[:, s:e], ztab[:, s:e])
            r = torch.arange(s, e, device=dev) & 127
            yv, zv = y[:, r], z[:, r]
            y0, z0 = floor_to_int32(yv), floor_to_int32(zv)
            ry = (y0 - yb[..., None]).clamp(0, 22)
            zi = z0.clamp(0, 510)
            F = sample(data, _clamp(yb, R - 24)[..., None], 0, ry, zi, yv - _fl(y0), zv - _fl(z0))
            acc = chain(acc, ordered_sum(F))
        return acc
    # sample9: per ray, over (9, 32, 256) bfloat16 bands of the volume [nx, ny, nz]
    P, BY, BZ = R6_BAND
    nx, ny, nz = vol.shape
    acc = torch.zeros((B, LANES), dtype=torch.float32, device=dev)
    for s, e in _chunks(per_step, LANES * 8, B):
        xb, yb, zb = unpack(ytab[:, s:e], nx, ny, nz)
        r = torch.arange(s, e, device=dev) & 127
        yv, zv = y[:, r], z[:, r]
        y0, z0 = floor_to_int32(yv), floor_to_int32(zv)
        ry = torch.remainder(y0, 32).clamp(0, 30) + 3 * BY  # band row: plane 3
        zi = torch.remainder(z0, 128).clamp(0, 253)
        flat = vol.reshape(-1)

        def at(row):  # the band's (P * BY, BZ) row `row` at the lanes' columns
            x = (xb[..., None] + row // BY).long()
            return _fl(flat[(x * ny + (yb[..., None] + row % BY).long()) * nz + (zb[..., None] + zi).long()])

        v00, v10 = at(ry), at(ry + 1)
        acc = chain(acc, combine(v00, v00, v10, v10, yv - _fl(y0), zv - _fl(z0)))
    return acc


def unpack(p: torch.Tensor, nx: int, ny: int, nz: int):
    """R6's packed copy offsets (xb * 65536 + yb8 * 4 + zb128), each start
    clamped into the volume for a (9, 32, 256) band."""
    P, BY, BZ = R6_BAND
    xb = _floor_div(p, 65536)
    yb = torch.remainder(_floor_div(p, 4), 64) * 8
    zb = torch.remainder(p, 4) * 128
    return _clamp(xb, nx - P), _clamp(yb, ny - BY), _clamp(zb, nz - BZ)


def sampler_kernel(key: str, variant: str, data, y, z, ytab, ztab, vol, steps: int, per_step: int, G: int = 0,
                   K: int = 0) -> torch.Tensor:
    B, dev = y.shape[0], y.device
    out = torch.empty((B, LANES) if variant == "sample9" else (B,), dtype=torch.float32, device=dev)
    R, C = data.shape if data is not None else (0, 0)
    nx, ny, nz = vol.shape if vol is not None else (0, 0, 0)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    tab_len = ytab[0].numel() if ytab is not None else 0
    g = render_geometry(B, per_step, _micro.sm_count(dev))
    if variant == "sample9":  # per-ray terms only where an instance takes several blocks
        stride = per_step * LANES if g.tiles > 1 else 0
    else:
        stride = terms_stride(per_step * (2 if variant == "loadtaa" else 1))
    terms = torch.empty(B * stride, dtype=torch.float32, device=dev) if stride else None
    _build.launch(f"probe_{key}", dev, "sdf_micro_sampler", ptr(data), R, C, ptr(vol), nx, ny, nz, y.data_ptr(),
                  z.data_ptr(), y.shape[1], ptr(ytab), ptr(ztab), tab_len, out.data_ptr(), ptr(terms), stride, B,
                  steps, per_step, G, K, VARIANTS.index(variant), *g.args)
    return out


# ---- micro_band_copy ----------------------------------------------------------------

COPIES = ("rowsum", "trips", "copyout", "smem_rw", "dma", "dma_ovl")
ROW_COPIES = COPIES[:3]  # S1, S2, D1: a block an instance's table row


def smem_rw_total(iters: int) -> int:
    """R6 ``smem_rw``'s total: the sum over i < iters of i // 128, every
    partial sum of its values at most that."""
    q, r = divmod(iters, LANES)
    return LANES * q * (q - 1) // 2 + r * q


def band_copy_plain(variant: str, tab, vol, band, iters: int) -> torch.Tensor:
    """micro_band_copy's plain version: S1, S2 [B, rows, 128]; D1 [B, rows,
    P * BY, BZ]; R6 [B, 128]."""
    B, dev = tab.shape[0], tab.device
    if variant == "rowsum":  # tab [B, rows, width]
        acc = chain(torch.zeros(tab.shape[:2], dtype=torch.float32, device=dev), _fl(tab).transpose(1, 2))
        return acc[..., None].expand(*acc.shape, LANES).contiguous()
    if variant == "trips":  # vol [nx, ny, nz]: per trip, vol[xb, 0, 0:128]
        nx = vol.shape[0]
        n = tab[..., 0].clamp(0, tab.shape[-1] - 1)
        acc = torch.zeros((*tab.shape[:2], LANES), dtype=torch.float32, device=dev)
        for s in range(tab.shape[-1] - 1):
            v = vol[_clamp(tab[..., 1 + s], nx - band[0]).long(), 0, :LANES]
            acc = torch.where((s < n)[..., None], acc + v, acc)
        return acc
    if variant == "copyout":  # the (P, BY, BZ) band at (xb, 8 yb, 8 zb)
        P, BY, BZ = band
        nx, ny, nz = vol.shape
        xb, yb, zb = _clamp(tab[..., 0], nx - P), _clamp(tab[..., 1] * 8, ny - BY), _clamp(tab[..., 2] * 8, nz - BZ)
        ar = lambda n: torch.arange(n, device=dev)  # noqa: E731
        idx = (((xb[..., None, None, None] + ar(P).view(P, 1, 1)).long() * ny
                + (yb[..., None, None, None] + ar(BY).view(1, BY, 1)).long()) * nz
               + (zb[..., None, None, None] + ar(BZ).view(1, 1, BZ)).long())
        return vol.reshape(-1)[idx].reshape(B, tab.shape[1], P * BY, BZ)
    acc = torch.zeros((B, LANES), dtype=torch.float32, device=dev)
    if variant == "smem_rw":
        # counters zero-filled: iteration i reads counter i & 127 after i >> 7 increments
        c = _fl(torch.arange(iters, device=dev) >> 7)
        return chain(acc, c.view(1, -1, 1).expand(B, iters, LANES))
    # dma, dma_ovl: vol[xb, yb, zb : zb + 128] of each iteration's band
    nx, ny, nz = vol.shape
    flat = vol.reshape(-1)
    for s, e in _chunks(iters, LANES, B):
        xb, yb, zb = unpack(tab[:, s:e], nx, ny, nz)
        idx = ((xb.long() * ny + yb.long()) * nz + zb.long())[..., None] + torch.arange(LANES, device=dev)
        acc = chain(acc, _fl(flat[idx]))
    return acc


def band_copy_kernel(key: str, variant: str, tab, vol, band, iters: int, out_shape) -> torch.Tensor:
    B, dev = tab.shape[0], tab.device
    out = torch.empty((B, *out_shape), dtype=torch.float32, device=dev)
    nx, ny, nz = vol.shape if vol is not None else (0, 0, 0)
    es = vol.element_size() if vol is not None else 4
    stride, terms = 0, None
    if variant in ROW_COPIES:  # a block a table row
        rows, width, g = tab.shape[1], tab.shape[-1], (1, 1)
    else:  # R6: the iterations over blocks; per-lane terms (smem_rw: a block's sum) where an instance takes several
        rows, width = 1, tab.shape[-1]
        g = render_geometry(B, iters, _micro.sm_count(dev)).args
        if g[0] > 1:
            if variant == "smem_rw" and smem_rw_total(iters) >= EXACT_FLOAT_INT:
                raise ValueError(f"{key}: the counters' sum over {iters} iterations reaches 2^24, past which the"
                                 " blocks' float partial sums are no longer exact")
            stride = terms_stride(g[0]) if variant == "smem_rw" else iters * LANES
            terms = torch.empty(B * stride, dtype=torch.float32, device=dev)
    _build.launch(f"probe_{key}", dev, "sdf_micro_band_copy", tab.data_ptr(), rows, width,
                  None if vol is None else vol.data_ptr(), es, nx, ny, nz, *band, out.data_ptr(),
                  None if terms is None else terms.data_ptr(), stride, B, iters, COPIES.index(variant), *g)
    return out


# ---- bytes the output depends on -------------------------------------------------


def _mask_count(size: int, *indices: torch.Tensor) -> int:
    mask = torch.zeros(size, dtype=torch.bool)
    for idx in indices:
        mask[idx.reshape(-1).long()] = True
    return int(mask.sum())


# ---- the probe factories -----------------------------------------------------------

# roles of the JAX probes' inputs -> (batch rule, dtype)
_ROLE = {
    "data": (_micro.SHARED, torch.float32), "plane": (_micro.SHARED, torch.float32),
    "cube": (_micro.SHARED, torch.float32), "vol": (_micro.SHARED, torch.float32),
    "vol16": (_micro.SHARED, torch.bfloat16), "y": (_micro.ROLL, torch.float32), "z": (_micro.ROLL, torch.float32),
    "ytab": (_micro.ROLL, torch.int32), "ztab": (_micro.ROLL, torch.int32), "tab": (_micro.ROLL, torch.int32),
}


def _named(roles, args) -> dict:
    """The inputs by role; a SHARED input without its batch axis, the cube
    [64, 8, 512] as the plane [512, 512] of its rows."""
    out = {}
    for role, a in zip(roles, args):
        a = a[0] if _ROLE[role][0] == _micro.SHARED else a
        out["vol" if role == "vol16" else role] = a.reshape(-1, a.shape[-1]) if role == "cube" else a
    return out


def _record(roles, build, shapes=None, **kw) -> dict:
    return dict(build=build, index=tuple(_ROLE[r][0] for r in roles), dtypes=tuple(_ROLE[r][1] for r in roles),
                in_shapes=tuple(shapes) if shapes else (), **kw)


def _tables(named: dict) -> tuple:
    """The y and z tables, each instance's flattened ([B, N])."""
    ytab, ztab = named.get("ytab"), named.get("ztab")
    if ytab is None:
        return None, None
    return ytab.reshape(ytab.shape[0], -1), ztab.reshape(ztab.shape[0], -1)


def band_sum(key, label, replaces, build, roles, spec: BandSum, steps: int, per_step: int, data_role: str = "data",
             unit: str = "row-step", shapes=None, lo=None) -> _micro.Probe:
    """A micro_band_sum probe: ``steps`` x ``per_step`` items chained (a
    nested chain when ``steps`` > 1), over the input of ``data_role``."""

    def args_of(args):
        n = _named(roles, args)
        ytab, ztab = _tables(n)
        return n.get(data_role) if spec.H else None, n.get("y"), n.get("z"), ytab, ztab

    def plain(*args):
        return band_sum_plain(spec, *args_of(args), steps, per_step).view(-1, 1, 1)

    def launch(*args):
        data, y, z, ytab, ztab = args_of(args)
        B, dev = (y if y is not None else ytab).shape[0], args[0].device
        if spec.base != "rays":
            y = z = None
        if spec.base != "table":
            ytab = ztab = None
        return band_sum_kernel(key, spec, data, y, z, ytab, ztab, steps, per_step, B, dev).view(-1, 1, 1)

    if band_addends(spec) == 0 or (fixed_band(spec) and band_addends(spec) != 1):
        raise ValueError(f"{key}: the kernel's chain takes an addend an item at least, and exactly one beside a band"
                         " that depends on no item")
    band_ops = spec.H * spec.W * (2 if spec.add_y else 1)  # a band's adds (and the base y added)

    def needs(args):  # instance 0's: (the data's bytes, its own inputs' bytes, the distinct bands' adds)
        data, y, z, ytab, ztab = args_of(args)
        own = shared = 0
        if spec.base == "rays":
            own = 2 * 4 * per_step * LANES  # every ray of the rows read (their least floor)
            yb, zb = row_bases(y[:, :per_step], z[:, :per_step])
        elif spec.base == "table":
            own = 2 * 4 * per_step
            yb, zb = table_bases(ytab[:, :per_step], ztab[:, :per_step])
        else:
            yb = zb = torch.zeros((1, per_step), dtype=torch.int32)
        if not spec.H:
            return 0, own, 0
        R, C = data.shape
        bands, _ = distinct_bands(spec, data.shape, yb, zb)
        mask = torch.zeros((R, C), dtype=torch.bool)
        for r, c, _ in bands.tolist():
            cols = torch.remainder(torch.arange(spec.W) - c, C) if spec.cols == "roll" else slice(c, c + spec.W)
            mask[r:r + spec.H, cols] = True
        return 4 * int(mask.sum()), own, bands.shape[0] * band_ops

    base_ops = {"rays": 4 * LANES, "table": 4, None: 0}[spec.base]  # per item: the floors and mins, or the roundings
    extra_ops = {"": 0, "y,z": 2, "y+z": 2, "z": 1, "one": 1}[spec.extra]  # the extras' adds
    items = steps * per_step
    memory = {"data": "L2 (the 1 MiB plane, read through L1)", "plane": "L2 (the 1 MiB plane, read through L1)",
              "cube": "L2 (the 1 MiB cube, read through L1)"}[data_role] if spec.H else "none (bases only)"
    return _micro.Probe(
        key, label, replaces, "micro_band_sum", plain=plain, launch=launch, out_shape=(1, 1), steps=items,
        # an instance's own: a step's items' bases and chain adds, and the steps' adds to the total
        work=items, ops=per_step * (base_ops + extra_ops + (1 if spec.H else 0)) + steps, memory=memory, needs=needs,
        unit=unit, lo=lo, geometry=lambda batch, sms: render_geometry(batch, per_step, sms),
        **_record(roles, build, shapes))


def sampler(key, label, replaces, build, roles, variant: str, steps: int, per_step: int, G: int = 0, K: int = 0,
            data_role: str = "data", unit: str = "row-step", shapes=None, lo=None) -> _micro.Probe:
    """A micro_sampler probe (``variant`` of VARIANTS)."""

    def args_of(args):
        n = _named(roles, args)
        ytab, ztab = _tables(n)
        if variant == "sample9":
            ytab = n["tab"]
        return n.get(data_role), n["y"], n["z"], ytab, ztab, n.get("vol")

    def plain(*args):
        out = sampler_plain(variant, *args_of(args), steps, per_step, G, K)
        return out.view(-1, 1, LANES) if variant == "sample9" else out.view(-1, 1, 1)

    def launch(*args):
        out = sampler_kernel(key, variant, *args_of(args), steps, per_step, G, K)
        return out.view(-1, 1, LANES) if variant == "sample9" else out.view(-1, 1, 1)

    def needs(args):  # instance 0's: (the data's bytes, its own inputs' bytes, the distinct items' operations)
        data, y, z, ytab, ztab, vol = args_of(args)
        if variant in ("full", "static", "loadtaa", "mxu"):
            # the items are the rays rows, each distinct; every step samples them again
            R, C = data.shape
            yb, zb = (torch.zeros((1, per_step), dtype=torch.int32),) * 2 if variant == "static" else row_bases(
                y[:, :per_step], z[:, :per_step])
            y0, z0 = floor_to_int32(y[:, :per_step]), floor_to_int32(z[:, :per_step])
            row0, col0 = _clamp(yb, R - 16)[..., None], _clamp(zb, C - 256)[..., None]
            zi = (z0 - zb[..., None]).clamp(0, 254) + col0
            own, ops = 2 * 4 * per_step * LANES, per_step * item_ops
            if variant == "loadtaa":
                rows = (row0 + torch.arange(16).view(1, 1, 16))[..., None]  # [1, M, 16, 1]
                idx = rows * C + zi[:, :, None, :]
                return 4 * _mask_count(R * C, idx, idx + 1), own, ops
            ry = (y0 - yb[..., None]).clamp(0, 14) + row0
            return 4 * _mask_count(R * C, *(r * C + zi + dz for r in (ry, ry + 1) for dz in (0, 1))), own, ops
        if variant == "tab_full":
            # an item is a ray row's sample at a group's bases and a step k: distinct by (row, bases) and k
            R, C = data.shape
            rows = per_step // (G * K)
            yb, zb = table_bases(ytab.view(1, -1, G)[:, :rows], ztab.view(1, -1, G)[:, :rows])
            r = torch.arange(rows).view(1, -1, 1).expand_as(yb)
            distinct = torch.unique(torch.stack([r, yb, zb], -1).reshape(-1, 3), dim=0).shape[0] * K
            ck, dk = _offsets(K, "cpu")
            yv = y[:, :rows, None, None, :] + ck.view(1, 1, 1, K, 1)
            zv = z[:, :rows, None, None, :] + dk.view(1, 1, 1, K, 1)
            yb5, zb5 = yb[..., None, None], zb[..., None, None]
            ry = (floor_to_int32(yv) - yb5).clamp(0, 22) + _clamp(yb5, R - 24)
            zi = (floor_to_int32(zv) - zb5).clamp(0, 254) + _clamp(zb5, C - 256)
            shared = 4 * _mask_count(R * C, *(r * C + zi + dz for r in (ry, ry + 1) for dz in (0, 1)))
            return shared, 2 * 4 * rows * G + 2 * 4 * rows * LANES, distinct * item_ops
        rays = 2 * 4 * min(per_step, LANES) * LANES  # the ray rows i & 127 read
        r = torch.arange(per_step) & 127
        if variant == "sample512":
            # an item is ray row i & 127 sampled at the table's row base: distinct by the two
            R, C = data.shape
            yb, _ = table_bases(ytab[:, :per_step], ztab[:, :per_step])
            distinct = torch.unique(torch.stack([r, yb[0]], -1), dim=0).shape[0]
            ry = (floor_to_int32(y[:, r]) - yb[..., None]).clamp(0, 22) + _clamp(yb, R - 24)[..., None]
            zi = floor_to_int32(z[:, r]).clamp(0, 510)
            shared = 4 * _mask_count(R * C, *(rr * C + zi + dz for rr in (ry, ry + 1) for dz in (0, 1)))
            return shared, 4 * per_step + rays, distinct * item_ops
        # sample9: two corners a ray of plane 3 of each band, in the bfloat16 volume; an item is ray row i & 127
        # sampled in the band at the unpacked offset: distinct by the two
        nx, ny, nz = vol.shape
        xb, yb, zb = unpack(ytab[:, :per_step], nx, ny, nz)
        distinct = torch.unique(torch.stack([r, xb[0], yb[0], zb[0]], -1), dim=0).shape[0]
        ry = torch.remainder(floor_to_int32(y[:, r]), 32).clamp(0, 30)
        zi = torch.remainder(floor_to_int32(z[:, r]), 128).clamp(0, 253)
        idx0 = (((xb + 3).long() * ny + yb.long())[..., None] + ry) * nz + zb.long()[..., None] + zi
        return 2 * _mask_count(nx * ny * nz, idx0, idx0 + nz), 4 * per_step + rays, distinct * item_ops

    # per ray of an item: two floors, the two fractions and 1 - each, eight products, three sums, two clamps and two
    # subtractions of the indices; and the tree's add (127 of 128), or in sample9 the ray's chain add (an own one)
    ray_ops = 2 * 16 + 6 if variant == "loadtaa" else 21  # loadtaa: the two columns' 16-row sums, the index math
    base_ops = {"full": 4 * LANES, "loadtaa": 4 * LANES, "mxu": 4 * LANES, "static": 0}.get(variant, 4)
    item_ops = LANES * (ray_ops - (variant == "sample9")) + base_ops
    chain_ops = LANES if variant == "sample9" else 1  # an item's chain adds
    items = steps * per_step
    memory = ("L2 (the 1 MiB plane, read through L1)" if variant != "sample9" else
              "device memory (the 256 MiB bfloat16 volume), bulk copies into shared memory")
    if variant == "mxu":
        memory = "L2 (the 1 MiB plane, float4 rows through L1; fp32 FMA one-hot products)"
    if variant == "sample512":
        memory = "L2 (the 1 MiB cube, read through L1)"
    return _micro.Probe(
        key, label, replaces, "micro_sampler", plain=plain, launch=launch,
        # an instance's own: a step's chain adds, and the steps' adds to the total
        out_shape=(1, LANES) if variant == "sample9" else (1, 1), steps=items, work=items,
        ops=per_step * chain_ops + steps, memory=memory, needs=needs, unit=unit, lo=lo,
        copied=items * math.prod(R6_BAND) * 2 if variant == "sample9" else 0,
        geometry=lambda batch, sms: render_geometry(batch, per_step, sms), **_record(roles, build, shapes))


def band_copy(key, label, replaces, build, roles, variant: str, band=(0, 0, 0), iters: int = 0, out_shape=(),
              unit: str = "iteration", steps: int = 0, copied: int = 0, shapes=None, lo=None, check=None,
              prepare=None, library=None) -> _micro.Probe:
    """A micro_band_copy probe (``variant`` of COPIES)."""

    def args_of(args):
        n = _named(roles, args)
        tab = n["tab"]
        if variant in ROW_COPIES:  # [B, rows, 1, width] -> [B, rows, width]
            tab = tab.reshape(tab.shape[0], tab.shape[1], -1)
        return tab, n.get("vol")

    def plain(*args):
        tab, vol = args_of(args)
        return band_copy_plain(variant, tab, vol, band, iters).view(-1, *out_shape)

    def launch(*args):
        tab, vol = args_of(args)
        return band_copy_kernel(key, variant, tab, vol if variant not in ("rowsum", "smem_rw") else None, band,
                                iters, out_shape)

    def needs(args):  # instance 0's: (the data's bytes, its own inputs' bytes, no shared operations)
        tab, vol = args_of(args)
        es = 2 if "vol16" in roles else 4
        if variant == "rowsum":
            return 0, 4 * tab.numel(), 0
        if variant == "smem_rw":
            return 0, 0, 0
        if variant == "trips":
            n = tab[..., 0].clamp(0, tab.shape[-1] - 1)
            xs = [tab[0, r, 1 + s] for r in range(tab.shape[1]) for s in range(int(n[0, r]))]
            own = 4 * int((n + 1).sum())  # each row's count and x-bases
            if not xs:
                return 0, own, 0
            rows = torch.stack(xs).clamp(0, vol.shape[0] - band[0]).long() * vol.shape[1] * vol.shape[2]
            return 4 * _mask_count(vol.numel(), rows[:, None] + torch.arange(LANES)), own, 0
        if variant == "copyout":
            out = band_copy_plain("copyout", tab, torch.arange(vol.numel()).view(vol.shape), band, 0)
            return es * _mask_count(vol.numel(), out), 4 * 3 * tab.shape[1], 0
        nx, ny, nz = vol.shape
        xb, yb, zb = unpack(tab[:, :iters], nx, ny, nz)
        first = (xb.long() * ny + yb.long()) * nz + zb.long()
        return es * _mask_count(vol.numel(), first[..., None] + torch.arange(LANES)), 4 * iters, 0

    ops = {"rowsum": 16 * 64, "trips": steps * LANES, "copyout": 0, "smem_rw": 3 * iters,
           "dma": iters * (LANES + 6), "dma_ovl": iters * (LANES + 6)}[variant]  # adds, unpacking, counter updates
    memory = {"rowsum": "a table row in shared memory (one bulk copy)",
              "smem_rw": "shared memory (128 counters)"}.get(
        variant, "device memory, bulk copies into shared memory (mbarrier)")
    return _micro.Probe(
        key, label, replaces, "micro_band_copy", plain=plain, launch=launch, out_shape=tuple(out_shape),
        steps=steps or iters, work=steps or iters, ops=ops, memory=memory, needs=needs, unit=unit, lo=lo,
        copied=copied, check=check, prepare=prepare, library=library,
        geometry=None if variant in ROW_COPIES else lambda batch, sms: render_geometry(batch, iters, sms),
        **_record(roles, build, shapes))
