"""The volume sharded over processes: EDT, signed field and render.

Counterpart of ``sdf_tools_tpu/parallel/sharded.py`` on
``torch.distributed``. Each rank calls these functions with its own part
of the volume, as the JAX package's run inside ``shard_map``; the mesh
axes are those of a ``ProcessMesh`` (``make_mesh``), passed as ``mesh=``.
The pass order and the sentinels are the JAX package's:

  * ``sharded_squared_edt`` (boundary summaries): the binary line pass runs
    along the sharded x axis, so a shard's influence on the others reduces
    to two numbers a line (the distance from each of its x faces to its
    nearest seed), exchanged with one ``all_gather``; the envelopes along
    the unsharded y and z are local. On the card: K4 (linear) -> summaries
    -> K5 along y and z. ``sharded_signed_field`` runs both fields through
    K1 (linear) -> one stacked ``all_gather`` -> K2 -> K3.
  * ``sharded_envelope_axis0_halo``: the odd-weight relaxation along the
    sharded axis, a halo swapped every K steps, until a global flag (one
    all-reduce and one host sync a round) says nothing changed.
  * 2-D (x, y) tiles: ``"reshard"`` (``all_to_all`` between the envelope
    passes) or ``"halo"`` (the relaxation along y).
  * The render: each rank traces every ray inside its own slab or tile
    (with a 2-cell halo from its neighbours, along y up to 3 more for the
    plane sweep's band, and 2*res beyond the volume's faces) and a
    min-composite over the axes picks each ray's first hit
    (``sharded_render_depth``, ``sharded_render_depth_2d``).

All collectives are in ``_comm``.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ..grid import GridMeta, SdfGrid
from ..ops import edt, render, render_plane
from . import _comm
from ._comm import ProcessMesh

SENT = edt._LINE_SENTINEL  # the linear line pass's no-seed distance


def make_mesh(axis_sizes: dict) -> ProcessMesh:
    """A mesh from {axis_name: size} over the ranks of the default process
    group (row-major by rank); the sizes must multiply to the world size
    (the JAX package's ``make_mesh`` may take the first devices only)."""
    return ProcessMesh(axis_sizes)


# ---------------------------------------------------------------------------
# The x line pass with boundary summaries
# ---------------------------------------------------------------------------


def _square_line_d2(d: torch.Tensor) -> torch.Tensor:
    """Linear line distance (1 << 24 sentinel) -> squared d^2 (INF_D2
    sentinel), in place."""
    no_seed = d >= SENT
    d.masked_fill_(no_seed, 0).mul_(d)
    return d.masked_fill_(no_seed, edt.INF_D2)


def _combine_across_shards(d_local: torch.Tensor, lows: torch.Tensor, highs: torch.Tensor, axis) -> torch.Tensor:
    """The global linear line distance of this shard from its local one and
    every shard's boundary summaries [P, ny, nz] (the distance from each
    shard's low / high x face to its nearest seed), in place in ``d_local``."""
    n_local, idx = d_local.shape[0], axis.index
    sh = torch.arange(lows.shape[0], dtype=torch.int32, device=d_local.device)[:, None, None]
    below = torch.where(sh < idx, (idx - sh - 1) * n_local + highs + 1, SENT).amin(0)
    above = torch.where(sh > idx, (sh - idx - 1) * n_local + lows + 1, SENT).amin(0)
    iota = torch.arange(n_local, dtype=torch.int32, device=d_local.device)[:, None, None]
    torch.minimum(d_local, iota + below, out=d_local)
    torch.minimum(d_local, (n_local - 1 - iota) + above, out=d_local)
    return d_local.clamp_(max=SENT)


def _summaries(d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(low, high) [ny, nz]: each line's distance from the shard's first
    and last x cell to its nearest local seed, ``SENT`` without one (the
    linear line distance at those cells)."""
    return d[0], d[-1]


def _sharded_line_d2(mask_local: torch.Tensor, axis, backend: str) -> torch.Tensor:
    """Squared line distance along the sharded x axis (one field)."""
    line_pass, _ = edt._single_field(backend)
    d = line_pass(mask_local, square=False)
    lows, highs = _comm.all_gather(torch.stack(_summaries(d)), axis).unbind(1)
    return _square_line_d2(_combine_across_shards(d, lows, highs, axis))


def _sharded_line_d2_dual(mask_local: torch.Tensor, axis, backend: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both fields' squared line distances along the sharded x axis from
    one dual line pass (K1 linear on the card) and one stacked
    ``all_gather`` of the four summaries."""
    line_pass, _, _ = edt._chain(backend)
    da, db = line_pass(mask_local, square=False)
    allp = _comm.all_gather(torch.stack([*_summaries(da), *_summaries(db)]), axis)  # [P, 4, ny, nz]
    da = _combine_across_shards(da, allp[:, 0], allp[:, 1], axis)
    db = _combine_across_shards(db, allp[:, 2], allp[:, 3], axis)
    return _square_line_d2(da), _square_line_d2(db)


def _mask(mask_local) -> torch.Tensor:
    if not isinstance(mask_local, torch.Tensor):
        raise TypeError("the sharded functions take this rank's slab as a tensor on its device")
    return mask_local.to(torch.bool).contiguous()


def sharded_squared_edt(mask_local, axis_name: str = "x", backend: str = "auto", *, mesh: ProcessMesh) -> torch.Tensor:
    """Exact squared EDT of an x-sharded volume: this rank's slab
    ``mask_local`` [nx_local, ny, nz] -> its slab of the global d^2 (int32).

    The line pass along the sharded x (boundary-summary exchange, exact),
    then the envelopes along y and z, which are whole on every rank."""
    _, envelope = edt._single_field(backend)
    f = _sharded_line_d2(_mask(mask_local), mesh.axis(axis_name), backend)
    f = envelope(f, 1)
    return envelope(f, 2)


def sharded_signed_field(filled_local, resolution, axis_name: str = "x", backend: str = "auto", *,
                         mesh: ProcessMesh) -> torch.Tensor:
    """This rank's slab of the global signed field. ``"auto"`` and
    ``"plain"`` run both fields fused (K1 linear, one stacked collective,
    K2, K3 with the combine); the other backends two ``sharded_squared_edt``
    and the combine, as the JAX package's non-Pallas backends do."""
    mask = _mask(filled_local)
    if edt._fused(backend):
        _, envelope, combine = edt._chain(backend)
        fa, fb = _sharded_line_d2_dual(mask, mesh.axis(axis_name), backend)
        fa, fb = envelope(fa, fb, 1)
        return combine(fa, fb, resolution)
    d2f = sharded_squared_edt(mask, axis_name, backend, mesh=mesh)
    d2e = sharded_squared_edt(~mask, axis_name, backend, mesh=mesh)
    return edt.signed_from_d2(d2f, d2e, resolution)


# ---------------------------------------------------------------------------
# The halo relaxation along the sharded axis
# ---------------------------------------------------------------------------


def sharded_envelope_axis0_halo(f_local: torch.Tensor, axis_name: str = "x", halo: int = 16, *,
                                mesh: ProcessMesh) -> torch.Tensor:
    """Exact envelope along the SHARDED axis 0 by halo-iterated relaxation:
    the odd-weight 3-tap relaxation, with ``halo`` boundary rows swapped
    with the neighbours every ``halo`` steps, until no rank's rows changed
    in a round (one all-reduce and one host sync a round; the rounds add to
    ``mesh.stats.halo_rounds``)."""
    axis = mesh.axis(axis_name)
    n_local = f_local.shape[0]
    halo = min(halo, n_local)  # a wider halo would slice short
    n_total = n_local * axis.size
    d = f_local.contiguous()
    t = 1
    inf_rows = torch.full((1, *d.shape[1:]), edt.INF_D2, dtype=d.dtype, device=d.device)
    while t <= n_total:
        lo, hi = _comm.exchange(d[-halo:], d[:halo], axis)
        inf = inf_rows.expand(halo, *d.shape[1:])
        e = torch.cat([inf if lo is None else lo, d, inf if hi is None else hi])
        for k in range(halo):
            c = 2 * (t + k) - 1
            up = torch.cat([inf_rows, e[:-1]])
            dn = torch.cat([e[1:], inf_rows])
            e = torch.minimum(e, torch.minimum(up, dn) + c)
        new_d = e[halo : halo + n_local]
        changed = (new_d != d).any().to(torch.int32)
        mesh.stats.halo_rounds += 1
        t += halo
        d = new_d.contiguous()
        if int(_comm.all_reduce(changed, axis, "max")) == 0:
            break
    return d


# ---------------------------------------------------------------------------
# 2-D (x, y) tiles
# ---------------------------------------------------------------------------


def sharded_squared_edt_2d(mask_local, axis_x: str = "x", axis_y: str = "y", backend: str = "auto",
                           method: str = "reshard", *, mesh: ProcessMesh) -> torch.Tensor:
    """Exact squared EDT of a volume sharded as (x, y) tiles: this rank's
    tile [nx_loc, ny_loc, nz] -> its tile of the global d^2.

    ``"reshard"``: the x line pass with boundary summaries; the z envelope
    (z is whole); one ``all_to_all`` over y swaps the y and z shardings, the
    y envelope, and a second ``all_to_all`` restores the input tiling.
    ``"halo"``: the y envelope in place by the halo relaxation over y, then
    the z envelope."""
    _, envelope = edt._single_field(backend)
    ay = mesh.axis(axis_y)
    f = _sharded_line_d2(_mask(mask_local), mesh.axis(axis_x), backend)
    if method == "reshard":
        f = envelope(f, 2)
        f = _comm.all_to_all(f, ay, split_axis=2, concat_axis=1)  # [nx_loc, ny, nz_loc]
        f = envelope(f, 1)
        return _comm.all_to_all(f, ay, split_axis=1, concat_axis=2)
    if method == "halo":
        fy = sharded_envelope_axis0_halo(f.movedim(1, 0), axis_y, halo=16, mesh=mesh)
        return envelope(fy.movedim(0, 1).contiguous(), 2)
    raise ValueError(method)


def sharded_signed_field_2d(filled_local, resolution, axis_x: str = "x", axis_y: str = "y", backend: str = "auto",
                            method: str = "reshard", *, mesh: ProcessMesh) -> torch.Tensor:
    """This rank's tile of the global signed field on an (x, y) tile mesh.
    ``"auto"``/``"plain"`` with ``"reshard"`` run both fields fused: one dual
    line pass and one stacked summary collective over x, K2 along z, ONE
    stacked ``all_to_all`` carrying both fields, K2 along y, and the
    combine before the reshard back (which then moves one f32 volume)."""
    mask = _mask(filled_local)
    if edt._fused(backend) and method == "reshard":
        _, envelope, _ = edt._chain(backend)
        fa, fb = _sharded_line_d2_dual(mask, mesh.axis(axis_x), backend)
        fa, fb = envelope(fa, fb, 2)
        ay = mesh.axis(axis_y)
        fa, fb = _comm.all_to_all(torch.stack([fa, fb]), ay, split_axis=3, concat_axis=2).unbind(0)
        fa, fb = envelope(fa.contiguous(), fb.contiguous(), 1)
        dist = edt.signed_from_d2(fa, fb, resolution)
        return _comm.all_to_all(dist, ay, split_axis=1, concat_axis=2)
    d2f = sharded_squared_edt_2d(mask, axis_x, axis_y, backend, method, mesh=mesh)
    d2e = sharded_squared_edt_2d(~mask, axis_x, axis_y, backend, method, mesh=mesh)
    return edt.signed_from_d2(d2f, d2e, resolution)


# ---------------------------------------------------------------------------
# The render without gathering the volume
# ---------------------------------------------------------------------------


def exchange_slab_halo(values_local: torch.Tensor, axis_name: str, width: int, *, mesh: ProcessMesh) -> torch.Tensor:
    """This x-slab extended by ``width`` rows from each x neighbour,
    differentiable (each halo's cotangent returns to its owner). At the
    volume's ends the halo repeats the edge plane (the reference clamps
    trilinear corners at the grid border)."""
    axis = mesh.axis(axis_name)
    lo, hi = _comm.halo_exchange(values_local[-width:], values_local[:width], axis)
    if axis.index == 0:
        lo = values_local[:1].expand_as(lo)
    if axis.index == axis.size - 1:
        hi = values_local[-1:].expand_as(hi)
    return torch.cat([lo, values_local, hi])


def _pad_faces(ext: torch.Tensor, faces: Sequence[Tuple[int, bool, bool, int]], res: float) -> torch.Tensor:
    """``ext`` with its outer halo rows along each (dim, at the volume's low
    face, at its high face, halo width) set to 2*res: after the march's
    -res/2 corner correction that is above every hit threshold, and a safe
    step (the ring exchange of the JAX package wrapped the volume's far
    side in there, which displaced boundary-face hits by ``halo`` cells)."""
    outer = torch.zeros(ext.shape, dtype=torch.bool, device=ext.device)
    for dim, low, high, halo in faces:
        i = torch.arange(ext.shape[dim], device=ext.device).reshape([-1 if d == dim else 1 for d in range(ext.ndim)])
        if low:
            outer |= i < halo
        if high:
            outer |= i >= ext.shape[dim] - halo
    return torch.where(outer, torch.full((), 2.0 * res, dtype=ext.dtype, device=ext.device), ext)


def _tile_grid(ext: torch.Tensor, full_meta: GridMeta, oob_value, offsets: Sequence[int]) -> SdfGrid:
    """The SdfGrid of an extended tile whose cell 0 is global cell
    ``offsets`` (x, then y; cells, may be negative): the full volume's
    origin translated along its own x and y axes by ``offset * res``."""
    res = full_meta.resolution
    m = full_meta.origin_transform
    shift = m[:3, 3]
    for dim, off in enumerate(offsets):
        shift = m[:3, dim] * (torch.tensor(float(off), dtype=torch.float32, device=m.device) * res) + shift
    origin = m.clone()
    origin[:3, 3] = shift
    meta = GridMeta.create(origin, full_meta.resolution_float, ext.shape, full_meta.frame, device=m.device)
    return SdfGrid.create(ext, meta, oob_value)


def _composite(depth_local: torch.Tensor, hit_local: torch.Tensor, axis, t_max: float):
    """(depth, hit) replicated over ``axis``: each ray's first hit over the
    ranks. The winner choice is not differentiated; the depth's cotangent
    reaches the winning ranks (ties share it) through ``replicated_sum``."""
    with torch.no_grad():
        depth_min = _comm.all_reduce(depth_local, axis, "min")
        win = (depth_local.detach() <= depth_min).to(depth_local.dtype)
        n_win = _comm.all_reduce(win, axis, "sum")
        weight = win / torch.clamp(n_win, min=1.0)
        hit = _comm.all_reduce(hit_local.to(torch.int32), axis, "sum") > 0
    depth = _comm.replicated_sum(weight * depth_local, axis)
    return torch.where(hit, depth, torch.full_like(depth, t_max)), hit


def tile_halos(shape_local: Sequence[int], halo: int, origins: torch.Tensor, backend: str = "auto") -> Tuple[int, int]:
    """(x, y) halo widths of the 2-D tile render of a tile [nx, ny, nz]:
    ``halo`` along both, but where the tile renders with the plane sweep
    the y halo grows by up to 3 cells until the extended y extent less the
    sweep's band (``render_plane.BY``) is a multiple of 8. A row's band
    base is such a multiple, so the band of a row at the tile's +y face
    then reaches the face, and the sweep keeps rows that it would
    otherwise hand to the march (``render_plane._row_tables``)."""
    nx, ny, nz = shape_local
    if render._resolve_backend(backend, (nx + 2 * halo, ny + 2 * halo, nz), origins) != "plane":
        return halo, halo
    return halo, min(ny, halo + (-(ny + 2 * halo - render_plane.BY) % 8) // 2)


def render_tile(ext, full_meta, oob_value, offsets, origins, directions, t_min, t_max, eps, max_steps, min_step,
                backend):
    """(depth, t_max where missed; hit) of every ray marched through one
    extended tile ``ext`` whose cell 0 is global cell ``offsets``: a rank's
    part of the sharded render (and of ``train.reference_step``'s).

    A hit in the tile's outer half cell along a mesh axis is dropped: the
    trilinear there reads the corners clamped at the tile's edge, not the
    cells beyond it, and may cross zero where the field does not. That
    half cell is the neighbour's own (or, at the volume's faces, the 2*res
    border, where the field has no surface), so the composite takes the
    neighbour's hit."""
    grid = _tile_grid(ext, full_meta, oob_value, offsets)
    r = render.render_depth(grid, origins, directions, t_min=t_min, t_max=t_max, eps=eps, max_steps=max_steps,
                            min_step=min_step, backend=backend)
    with torch.no_grad():
        g = grid.meta.world_to_grid(origins + r.depth.detach()[..., None] * directions) / grid.resolution
        hit = r.hit
        for dim in range(len(offsets)):
            hit = hit & (g[..., dim] >= 0.5) & (g[..., dim] < ext.shape[dim] - 0.5)
    return torch.where(hit, r.depth, torch.full_like(r.depth, t_max)), hit


def sharded_render_depth(
    values_local: torch.Tensor,
    full_meta: GridMeta,
    oob_value,
    origins: torch.Tensor,
    directions: torch.Tensor,
    axis_name: str = "x",
    halo: int = 2,
    t_min: float = 0.0,
    t_max: float = 10.0,
    eps: float = 1e-3,
    max_steps: int = 96,
    min_step: Optional[float] = None,
    backend: str = "auto",
    *,
    mesh: ProcessMesh,
):
    """Depth of every ray over an x-sharded SDF: (depth, hit), replicated
    over the axis. Each rank marches all rays inside its slab (the full
    step budget: a ray along y or z may cross its whole length in one
    slab), then ``_composite``. Differentiable w.r.t. the slab's values,
    the origins and the directions."""
    axis = mesh.axis(axis_name)
    nx_local = values_local.shape[0]
    ext = exchange_slab_halo(values_local, axis_name, halo, mesh=mesh)
    ext = _pad_faces(ext, [(0, axis.index == 0, axis.index == axis.size - 1, halo)], full_meta.resolution_float)
    depth_local, hit_local = render_tile(ext, full_meta, oob_value, (axis.index * nx_local - halo,), origins,
                                          directions, t_min, t_max, eps, max_steps, min_step, backend)
    return _composite(depth_local, hit_local, axis, t_max)


def sharded_render_depth_2d(
    values_local: torch.Tensor,
    full_meta: GridMeta,
    oob_value,
    origins: torch.Tensor,
    directions: torch.Tensor,
    axis_x: str = "x",
    axis_y: str = "y",
    halo: int = 2,
    t_min: float = 0.0,
    t_max: float = 10.0,
    eps: float = 1e-3,
    max_steps: int = 96,
    min_step: Optional[float] = None,
    backend: str = "auto",
    *,
    mesh: ProcessMesh,
):
    """Depth over a volume sharded as (x, y) tiles: the halo along x, then
    along y on the x-extended tile (the y neighbours bring their x halos,
    so the tile's corners are exact; ``tile_halos`` may widen the y halo),
    each rank marches every ray inside its tile, and the composite runs
    over both axes."""
    ax, ay = mesh.axis(axis_x), mesh.axis(axis_y)
    nx_local, ny_local = values_local.shape[0], values_local.shape[1]
    hx, hy = tile_halos(values_local.shape, halo, origins, backend)
    ext = exchange_slab_halo(values_local, axis_x, hx, mesh=mesh)
    ext = exchange_slab_halo(ext.movedim(1, 0), axis_y, hy, mesh=mesh).movedim(0, 1)
    faces = [(0, ax.index == 0, ax.index == ax.size - 1, hx), (1, ay.index == 0, ay.index == ay.size - 1, hy)]
    ext = _pad_faces(ext, faces, full_meta.resolution_float).contiguous()
    offsets = (ax.index * nx_local - hx, ay.index * ny_local - hy)
    depth_local, hit_local = render_tile(ext, full_meta, oob_value, offsets, origins, directions, t_min, t_max, eps,
                                          max_steps, min_step, backend)
    return _composite(depth_local, hit_local, mesh.axis((axis_x, axis_y)), t_max)
