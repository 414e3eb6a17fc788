"""Map topology (counterpart of ``sdf_tools_tpu/ops/topology.py``):
connected components, surface masks, the holes/voids census, the watershed
extrema map, convex segments and the nearest-location resample.

The contracts are the JAX package's:

  * Connected components: labels are 1-based dense ranks of each
    component's smallest flat index (the reference's raster-scan discovery
    order), 0 for ineligible cells, and the count comes back as a tensor.
  * Holes/voids: the Chen & Rong census, #holes = 1 + (M5 + 2 M6 - M3) / 8
    + voids, with a component's voids the number of its disjoint surface
    sets less one (a vertex is a surface vertex of component c iff its 8
    surrounding voxels hold both c and not c).
  * Local extrema: each cell's gradient walk by pointer doubling; a cycle
    resolves to its member of smallest flat index; a walk off the grid to
    +inf.

The three min-label propagations (components, the per-component vertex
graph, the census's joint vertex graph) iterate to a fixed point, which JAX
tests with a device ``all()`` every round of a ``lax.while_loop``. Here the
host checks only every ``CHECK_EVERY`` rounds whether the last round changed
a label (rounds at the fixed point change nothing), and each round ends
with a hook and two pointer jumps (``_fixed_point``): a label is always the
id of a node of the same set and never grows, so the fixed point is the
same (each set's smallest id) but is reached in a few rounds, where the
plain loop takes as many as the longest path. The tests hold this loop
bitwise against the plain one. Flat
indices, node ids and labels are int64 throughout (the JAX package's int32
sentinel 2^30 and node ids vertex * 8 + slot meet real values on large
grids); labels hold uint32 values, as everywhere in the port.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..grid import CollisionMap, GridMeta, SdfGrid, TaggedCollisionMap, flat_cell_index
from . import query

_DIRS6 = [(0, 1), (0, -1), (1, 1), (1, -1), (2, 1), (2, -1)]
# the vertex edges in the order of _EDGE_GROUPS: z-, z+, y-, y+, x-, x+
_EDGE_DIRS = [(2, -1), (2, 1), (1, -1), (1, 1), (0, -1), (0, 1)]
# rounds of a fixed-point loop between two host checks
CHECK_EVERY = 2
# vertices of the census's slot-sharing step at a time
_SHARE_CHUNK = 1 << 22


def _shift(a: torch.Tensor, axis: int, sign: int, fill) -> torch.Tensor:
    """Neighbour value in direction (axis, sign): out[i] = a[i + sign],
    ``fill`` past the edge."""
    n = a.shape[axis]
    out = torch.full_like(a, fill)
    if n > 1:
        dst, src = (0, 1) if sign > 0 else (1, 0)
        out.narrow(axis, dst, n - 1).copy_(a.narrow(axis, src, n - 1))
    return out


def _lower_along(new: torch.Tensor, old: torch.Tensor, axis: int, sign: int, link: torch.Tensor, big: int) -> None:
    """new[i] = min(new[i], old[i + sign]) where link[i], along ``axis``."""
    n = new.shape[axis]
    if n < 2:
        return
    dst, src = (0, 1) if sign > 0 else (1, 0)
    view = new.narrow(axis, dst, n - 1)
    cand = torch.where(link.narrow(axis, dst, n - 1), old.narrow(axis, src, n - 1), big)
    torch.minimum(view, cand, out=view)


def _fixed_point(label0: torch.Tensor, relax, jump: bool):
    """Min-label propagation to its fixed point.

    ``label0`` is flat int64 [M + 1]: node i's label (i itself, or M for a
    node outside every set) and a sentinel M at the end, which the node
    labels of M point at. ``relax(old, new)`` lowers the labels of ``new``
    (a copy of ``old``) from ``old`` along the graph's edges. With ``jump``
    a round then hooks: the node that a lowered label used to name takes
    the new label where it is smaller (a scatter-min over the lowered nodes
    only); and takes two pointer jumps, label = min(label, label[label]).
    Every label stays the id of a node of the same set, at most the node's
    own, so the fixed point (each set's smallest id) is the plain loop's,
    reached in a few rounds instead of the longest path's length. The host
    checks every ``CHECK_EVERY`` rounds whether the last round changed a
    label. Returns (labels [M], rounds, host checks)."""
    buf, rounds, checks = label0, 0, 0
    del label0  # a round holds two label buffers: the last and the new
    while True:
        new = buf.clone()
        relax(buf, new)
        if jump:
            body, was = new[:-1], buf[:-1]
            lowered = body < was
            new.scatter_reduce_(0, was[lowered], body[lowered], reduce="amin")
            for _ in range(2):
                torch.minimum(body, new[body], out=body)
            del body, was, lowered
        rounds += 1
        if rounds % CHECK_EVERY == 0:
            checks += 1
            if torch.equal(new, buf):
                return new[:-1], rounds, checks
        buf = new


def _with_sentinel(label: torch.Tensor, big: int) -> torch.Tensor:
    return torch.cat([label.reshape(-1), torch.full((1,), big, dtype=torch.int64, device=label.device)])


# ---------------------------------------------------------------------------
# Connected components
# ---------------------------------------------------------------------------


def connected_components_from_adjacency(
    eligible: torch.Tensor, conn: List[torch.Tensor], *, jump: bool = True, diag: bool = False
):
    """Min-label propagation components.

    eligible: [nx, ny, nz] bool, the cells that get a component (others 0).
    conn: 6 bool masks (order +x, -x, +y, -y, +z, -z); conn[d][i] means
    cell i connects to its neighbour in direction d (symmetric).

    Returns (labels int64 [nx, ny, nz], 1-based in raster-scan discovery
    order, n_components 0-d int64), and with ``diag`` also {"rounds",
    "host_checks"}. ``jump=False`` runs the plain propagation, one
    neighbour step a round (the reference the tests hold the jumped loop
    to)."""
    shape = tuple(eligible.shape)
    N = math.prod(shape)
    dev = eligible.device
    flat = torch.arange(N, dtype=torch.int64, device=dev)
    elig = eligible.reshape(-1)

    def relax(old, new):
        o, n = old[:-1].view(shape), new[:-1].view(shape)
        for d, (axis, sign) in enumerate(_DIRS6):
            _lower_along(n, o, axis, sign, conn[d], N)

    label, rounds, checks = _fixed_point(
        _with_sentinel(torch.where(elig, flat, N), N), relax, jump
    )
    # dense 1-based ranks in discovery (smallest flat index) order
    is_rep = (label == flat) & elig
    ranks = torch.cumsum(is_rep, 0)
    comp = torch.where(elig, ranks[label.clamp(max=N - 1)], 0).view(shape)
    out = comp, is_rep.sum()
    return (*out, {"rounds": rounds, "host_checks": checks}) if diag else out


def _symmetric_conn(eligible: torch.Tensor, same: List[torch.Tensor]) -> List[torch.Tensor]:
    return [eligible & _shift(eligible, axis, sign, False) & same[d] for d, (axis, sign) in enumerate(_DIRS6)]


def connected_components_by_key(eligible: torch.Tensor, key: torch.Tensor, **kw):
    """Components where two 6-adjacent eligible cells connect iff their key
    values match (keyword arguments as ``connected_components_from_adjacency``)."""
    same = [_shift(key, axis, sign, -1) == key for axis, sign in _DIRS6]
    return connected_components_from_adjacency(eligible, _symmetric_conn(eligible, same), **kw)


def update_connected_components(cmap: CollisionMap, **kw):
    """Reference ``CollisionMapGrid::UpdateConnectedComponents``
    (collision_map.cpp:564-618): 6-connectivity, same binary occupancy
    (occupancy > 0.5), every cell labelled. Returns (map, n_components)
    (and the loop's diag with ``diag=True``); a ``TaggedCollisionMap``
    works the same."""
    binary = (cmap.occupancy > 0.5).to(torch.int32)
    comp, *rest = connected_components_by_key(torch.ones_like(binary, dtype=torch.bool), binary, **kw)
    return (dataclasses.replace(cmap, component=comp, components_valid=True), *rest)


# ---------------------------------------------------------------------------
# Surface predicates (reference collision_map.hpp:45-119, 549-619)
# ---------------------------------------------------------------------------


def surface_mask_26(filled: torch.Tensor) -> torch.Tensor:
    """IsSurfaceIndex: a filled cell with at least one of its 26 neighbours
    not filled, or on the grid border (collision_map.hpp:45-92). All 26
    neighbours filled is a 3x3x3 AND, taken one axis at a time."""
    f = filled.to(torch.bool)
    all_nb = f
    for axis in range(3):
        all_nb = all_nb & _shift(all_nb, axis, 1, False) & _shift(all_nb, axis, -1, False)
    return f & ~all_nb


def _neighbour_differences(labels: torch.Tensor):
    """Per axis, (in-bounds pairs i, i + 1 whose labels differ)."""
    lab = labels.to(torch.int64)
    return [
        lab.narrow(ax, 1, n - 1) != lab.narrow(ax, 0, n - 1) if n > 1 else None
        for ax, n in enumerate(lab.shape)
    ]


def component_surface_mask(labels: torch.Tensor) -> torch.Tensor:
    """IsConnectedComponentSurfaceIndex: a cell with at least one of its 6
    neighbours in another component, or on the grid border
    (collision_map.hpp:94-119)."""
    out = torch.zeros(labels.shape, dtype=torch.bool, device=labels.device)
    for ax, diff in enumerate(_neighbour_differences(labels)):
        n = labels.shape[ax]
        out.narrow(ax, 0, 1).fill_(True)
        out.narrow(ax, n - 1, 1).fill_(True)
        if diff is not None:
            out.narrow(ax, 0, n - 1).logical_or_(diff)
            out.narrow(ax, 1, n - 1).logical_or_(diff)
    return out


def candidate_corner_mask(labels: torch.Tensor) -> torch.Tensor:
    """CheckIfCandidateCorner: at least 2 of the 6 neighbours in another
    component (collision_map.hpp:549-619). Out-of-grid neighbours do not
    count as different (the reference counts only neighbours it can read)."""
    count = torch.zeros(labels.shape, dtype=torch.int32, device=labels.device)
    for ax, diff in enumerate(_neighbour_differences(labels)):
        if diff is not None:
            n = labels.shape[ax]
            count.narrow(ax, 0, n - 1).add_(diff)
            count.narrow(ax, 1, n - 1).add_(diff)
    return count >= 2


# ---------------------------------------------------------------------------
# Holes / voids (genus) census
# ---------------------------------------------------------------------------


def _vertex_cube_labels(labels: torch.Tensor) -> torch.Tensor:
    """[nx+1, ny+1, nz+1, 8] int64 labels of the 8 voxels around each
    vertex, -1 out of the grid. Slot k = dx*4 + dy*2 + dz holds the voxel at
    (x-1+dx, y-1+dy, z-1+dz)."""
    lab = labels.to(torch.int64)
    p = F.pad(lab, (1, 1, 1, 1, 1, 1), value=-1)
    nx, ny, nz = lab.shape
    cubes = [
        p[dx : dx + nx + 1, dy : dy + ny + 1, dz : dz + nz + 1] for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)
    ]
    return torch.stack(cubes, dim=-1)


def _edge_groups():
    """For each of the 6 vertex edges (z-, z+, y-, y+, x-, x+), the 4 cube
    slots around it (topology_computation.hpp:502-608)."""
    groups = []
    for axis, val in ((2, 0), (2, 1), (1, 0), (1, 1), (0, 0), (0, 1)):
        groups.append([k for k in range(8) if ((k >> 2) & 1, (k >> 1) & 1, k & 1)[axis] == val])
    return groups


_EDGE_GROUPS = _edge_groups()


def vertex_edge_exposure(labels: torch.Tensor, component) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-vertex edge exposure for one component: (edge_bits int32
    [nx+1, ny+1, nz+1], is_surface_vertex bool, exposed_edge_count int32).
    An edge is exposed iff its 4 voxels are mixed (some == c, some != c); a
    vertex is a surface vertex iff its 8-cube is mixed."""
    is_c = _vertex_cube_labels(labels) == int(component)
    mixed_cube = is_c.any(-1) & ~is_c.all(-1)
    bits = torch.zeros(is_c.shape[:-1], dtype=torch.int32, device=is_c.device)
    count = torch.zeros_like(bits)
    for e, group in enumerate(_EDGE_GROUPS):
        g = is_c[..., group]
        mixed = (g.any(-1) & ~g.all(-1)).to(torch.int32)
        bits |= mixed << e
        count += mixed
    return torch.where(mixed_cube, bits, 0), mixed_cube, torch.where(mixed_cube, count, 0)


def _raw_holes(m3, m5, m6):
    return 1 + torch.div(m5 + 2 * m6 - m3, 8, rounding_mode="floor")


def component_holes_and_voids(
    labels: torch.Tensor, component, *, jump: bool = True, diag: bool = False
):
    """(#holes, #voids) of one component as 0-d int64 tensors: Chen & Rong
    census plus the vertex graph's surface sets (reference
    topology_computation.hpp:326-640); with ``diag`` also the loop's
    {"rounds", "host_checks"}."""
    bits, is_sv, count = vertex_edge_exposure(labels, component)
    m3, m5, m6 = ((count == k).sum() for k in (3, 5, 6))
    vshape = tuple(bits.shape)
    Nv = math.prod(vshape)
    flat = torch.arange(Nv, dtype=torch.int64, device=bits.device)
    links = [((bits >> e) & 1) == 1 for e in range(6)]

    def relax(old, new):
        o, n = old[:-1].view(vshape), new[:-1].view(vshape)
        for e, (axis, sign) in enumerate(_EDGE_DIRS):
            _lower_along(n, o, axis, sign, links[e], Nv)

    sv = is_sv.reshape(-1)
    vlabel, rounds, checks = _fixed_point(
        _with_sentinel(torch.where(sv, flat, Nv), Nv), relax, jump
    )
    n_voids = torch.clamp(((vlabel == flat) & sv).sum() - 1, min=0)
    out = _raw_holes(m3, m5, m6) + n_voids, n_voids
    return (*out, {"rounds": rounds, "host_checks": checks}) if diag else out


def component_topology_census(labels: torch.Tensor, n_components: int, *, jump: bool = True, diag: bool = False):
    """(holes, voids) of every component 1..n in one pass: [n, 2] int64
    (with ``diag`` also {"rounds", "host_checks"}). Equal to
    ``component_holes_and_voids`` over 1..n.

    Each vertex's 8-cube holds every component the vertex can be a surface
    vertex of, so the census runs over (vertex, slot) nodes: a node counts
    at the first slot holding its label, the M3/M5/M6 exposure census
    reduces into per-label histograms, and one joint min-label propagation
    over the nodes (id vertex * 8 + that first slot, int64) counts each
    component's disjoint surface sets. A node links along an exposed vertex
    edge to the same label at the neighbour vertex, which is the edge's
    voxel seen from there (the slot with the edge axis's bit flipped); the
    slots of one label at a vertex then share their smallest label. The
    labels live as [vx, vy, vz, 2, 2, 2] (the slot's dx, dy, dz), so each
    of a round's steps is a strided view of all vertices.

    Memory: a node keeps its first slot, its six exposure bits and its two
    flags in a byte each beside the loop's two int64 label buffers, and a
    round's pointer jump gathers a third: about 200 B a vertex at the peak.
    The 8-cube's labels are strided views of the padded grid, never
    stacked."""
    n = int(n_components)
    dev = labels.device
    if n <= 0:
        out = torch.zeros((0, 2), dtype=torch.int64, device=dev)
        return (out, {"rounds": 0, "host_checks": 0}) if diag else out
    p = F.pad(labels.to(torch.int64), (1, 1, 1, 1, 1, 1), value=-1)
    vshape = tuple(s - 1 for s in p.shape)
    Nv = math.prod(vshape)

    def slot(k):  # the voxel labels of slot k = dx*4 + dy*2 + dz around every vertex
        dx, dy, dz = (k >> 2) & 1, (k >> 1) & 1, k & 1
        return p[dx : dx + vshape[0], dy : dy + vshape[1], dz : dz + vshape[2]]

    # the first slot holding each slot's label (the smallest j wins, last)
    canon = torch.arange(8, dtype=torch.uint8, device=dev).expand(vshape + (8,)).contiguous()
    for k in range(1, 8):
        for j in range(k - 1, -1, -1):
            canon[..., k].masked_fill_(slot(j) == slot(k), j)
    mixed_cube = (canon != 0).any(-1)
    # edge e exposed at slot k: its 4 slots hold k's label and another
    exposure = torch.zeros_like(canon)
    for e, g in enumerate(_EDGE_GROUPS):
        same = canon[..., g][..., None, :] == canon[..., :, None]  # [..., 8, 4]
        exposure |= (same.any(-1) & ~same.all(-1)).to(torch.uint8) << e
        del same
    active = torch.empty(vshape + (8,), dtype=torch.bool, device=dev)
    for k in range(8):
        torch.logical_and(slot(k) >= 1, slot(k) <= n, out=active[..., k])
    active &= mixed_cube[..., None]
    valid = active & (canon == torch.arange(8, dtype=torch.uint8, device=dev))
    del mixed_cube

    # M3 / M5 / M6 per component: one histogram of (label, class) keys
    count = sum((exposure >> e) & 1 for e in range(6))
    hist = torch.zeros(4 * (n + 1), dtype=torch.int64, device=dev)
    for k in range(8):
        vk = valid[..., k]
        ck = count[..., k][vk]
        cls = torch.where(ck == 3, 0, torch.where(ck == 5, 1, torch.where(ck == 6, 2, 3)))
        hist += torch.bincount(slot(k)[vk] * 4 + cls, minlength=4 * (n + 1))
    hist = hist.view(n + 1, 4)[1:]
    m3, m5, m6 = hist[:, 0], hist[:, 1], hist[:, 2]
    del count, p

    big = Nv * 8
    exp6 = exposure.view(vshape + (2, 2, 2))
    canon8 = canon.view(Nv, 8)

    def relax(old, new):
        o6 = old[:-1].view(vshape + (2, 2, 2))
        n6 = new[:-1].view(vshape + (2, 2, 2))
        for e, (axis, sign) in enumerate(_EDGE_DIRS):
            val = 1 if sign > 0 else 0  # the edge's slots here; the neighbour's hold 1 - val
            nv = vshape[axis]
            if nv < 2:
                continue
            dst, src = (0, 1) if sign > 0 else (1, 0)
            view = n6.narrow(axis, dst, nv - 1).select(3 + axis, val)
            link = ((exp6.narrow(axis, dst, nv - 1).select(3 + axis, val) >> e) & 1).bool()
            cand = torch.where(link, o6.narrow(axis, src, nv - 1).select(3 + axis, 1 - val), big)
            torch.minimum(view, cand, out=view)
            del link, cand
        # the slots of one label at a vertex share their smallest label (in
        # chunks of vertices: the int64 slot index and the minima are 128 B
        # a vertex)
        n8 = new[:-1].view(Nv, 8)
        for v0 in range(0, Nv, _SHARE_CHUNK):
            part = n8[v0 : v0 + _SHARE_CHUNK]
            idx = canon8[v0 : v0 + _SHARE_CHUNK].long()
            least = torch.full_like(part, big).scatter_reduce_(1, idx, part, reduce="amin")
            torch.gather(least, 1, idx, out=part)

    labs, rounds, checks = _fixed_point(_slot_nodes(canon, active), relax, jump)
    del active
    # one root per surface set: the counted node whose label is its own id
    # (a counted node sits at its first slot, so its id is its flat index)
    node = valid.view(-1).nonzero().squeeze(1)
    root = node[labs[node] == node]
    del labs, node
    v, k = root // 8, root % 8
    vz, vy, vx = v % vshape[2], (v // vshape[2]) % vshape[1], v // (vshape[1] * vshape[2])
    at = labels[vx - 1 + ((k >> 2) & 1), vy - 1 + ((k >> 1) & 1), vz - 1 + (k & 1)]
    n_surf = torch.bincount(at.to(torch.int64), minlength=n + 1)[1:]
    n_voids = torch.clamp(n_surf - 1, min=0)
    out = torch.stack([_raw_holes(m3, m5, m6) + n_voids, n_voids], dim=-1)
    return (out, {"rounds": rounds, "host_checks": checks}) if diag else out


def _slot_nodes(canon: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """The census's initial node labels, flat int64 [Nv * 8 + 1]: vertex * 8
    + the slot's first slot where active, else the sentinel Nv * 8, which
    also ends the buffer."""
    nv = canon[..., 0].numel()
    label = torch.empty(nv * 8 + 1, dtype=torch.int64, device=canon.device)
    body = label[:-1].view(nv, 8)
    body.copy_(canon.view(nv, 8))
    body += torch.arange(0, nv * 8, 8, dtype=torch.int64, device=canon.device)[:, None]
    body.masked_fill_(~active.view(nv, 8), nv * 8)
    label[-1] = nv * 8
    return label


def compute_component_topology(labels: torch.Tensor, n_components: int) -> np.ndarray:
    """Host utility: int32 [(holes, voids)] for components 1..n_components,
    in one device pass (``CollisionMapGrid::ComputeComponentTopology``,
    collision_map.cpp:620-671, loops over the components)."""
    n = int(n_components)
    if n <= 0:
        return np.zeros((0, 2), np.int32)
    return component_topology_census(labels, n).cpu().numpy().astype(np.int32)


# ---------------------------------------------------------------------------
# Local extrema (watershed) map via pointer doubling
# ---------------------------------------------------------------------------


def local_extrema_map(sdf: SdfGrid) -> torch.Tensor:
    """Dense [nx, ny, nz, 3] map of the local extremum each cell's gradient
    walk reaches (reference ``ComputeLocalExtremaMap``, sdf.cpp:186-207).

    World-frame gradient with edge gradients; a step of sign(component)
    along each axis where |g| > res * 0.06125 (the sign flipped inside
    obstacles); a flat gradient ends the walk at the cell's grid-frame
    center; a step off the grid ends it at (+inf, +inf, +inf). Cycles
    resolve to their member of smallest flat index. Flat indices are int64
    (the JAX package's are int32)."""
    shape = sdf.shape
    N = math.prod(shape)
    dev = sdf.values.device
    axes = [torch.arange(n, dtype=torch.int32, device=dev) for n in shape]
    idx = torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1)

    grad, _ = query.gradient(sdf, idx, enable_edge_gradients=True)
    thresh = sdf.resolution * 0.06125
    flat_grad = (grad.abs() <= thresh).all(dim=-1)
    wg = torch.where((sdf.values < 0.0)[..., None], -grad, grad)
    step = torch.where(wg > thresh, 1, torch.where(wg < -thresh, -1, 0)).to(torch.int32)
    nxt = idx + step
    off = ~sdf.meta.index_in_bounds(nxt)
    del grad, wg, step

    # 0 = walk on, 1 = flat terminal, 2 = off-grid terminal
    term = torch.where(flat_grad, 1, torch.where(off, 2, 0)).reshape(-1)
    self_flat = torch.arange(N, dtype=torch.int64, device=dev)
    nxt_flat = flat_cell_index(nxt[..., 0], nxt[..., 1], nxt[..., 2], shape).reshape(-1)
    ptr = torch.where(term != 0, self_flat, nxt_flat)
    del nxt, nxt_flat, off, flat_grad

    # pointer doubling, stopping at terminals
    n_steps = int(np.ceil(np.log2(max(N, 2)))) + 1
    for _ in range(n_steps):
        ptr = torch.where(term[ptr] != 0, ptr, ptr[ptr])

    # cells whose root is no terminal sit on (or lead into) a cycle: the
    # smallest flat index over what they reach, by min-doubling
    cyclic = term[ptr] == 0
    mval = torch.where(cyclic, ptr, N)
    p2 = ptr
    for _ in range(n_steps):
        mval = torch.minimum(mval, mval[p2])
        p2 = p2[p2]
    root = torch.where(cyclic, mval, ptr)

    centers = sdf.meta.index_to_location_grid_frame(idx).reshape(-1, 3)
    ext = torch.where((term[root] == 2)[:, None], math.inf, centers[root])
    return ext.reshape(shape + (3,))


# ---------------------------------------------------------------------------
# Convex segmentation (reference UpdateConvexSegments,
# tagged_object_collision_map.cpp:552-654)
# ---------------------------------------------------------------------------


def convex_segments(tmap: TaggedCollisionMap, sdf: SdfGrid, connected_threshold, **kw):
    """Convex segment labels: (labels int64, count), as
    ``connected_components_from_adjacency`` (keyword arguments too).

    Connectivity: 6-adjacent cells with the same object id whose watershed
    extrema are within ``connected_threshold`` (Euclidean, float32, its
    root taken in float64 and rounded: the CPU's float32 root is not
    correctly rounded). Eligible: free (occupancy < 0.5) or object cells
    (object_id > 0) with finite extrema. The SDF is the virtual-border or
    free+named field the reference uses (tagged_object_collision_map.cpp:556)."""
    extrema = local_extrema_map(sdf)
    eligible = ((tmap.occupancy < 0.5) | (tmap.object_id > 0)) & torch.isfinite(extrema).all(dim=-1)
    thr = torch.as_tensor(connected_threshold, dtype=torch.float32, device=extrema.device)
    same = []
    for axis, sign in _DIRS6:
        nb_obj = _shift(tmap.object_id, axis, sign, 2**31)
        diff = _shift(extrema, axis, sign, math.inf) - extrema
        d2 = (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]) + diff[..., 2] * diff[..., 2]
        dist = torch.sqrt(d2.double()).float()
        same.append((nb_obj == tmap.object_id) & (dist < thr))
        del diff, d2, dist
    return connected_components_from_adjacency(eligible, _symmetric_conn(eligible, same), **kw)


# ---------------------------------------------------------------------------
# Resample (collision_map.cpp:673-695)
# ---------------------------------------------------------------------------


def resample_nearest(values: torch.Tensor, meta: GridMeta, new_resolution) -> Tuple[torch.Tensor, GridMeta]:
    """Resample a grid to a new resolution by nearest-location copy: each
    new cell takes the old cell holding its center."""
    new_shape = tuple(
        max(1, int(np.ceil(s * float(meta.resolution_float) / float(new_resolution) - 1e-4))) for s in meta.shape
    )
    new_meta = GridMeta.create(meta.origin_transform, new_resolution, new_shape, meta.frame, device=meta.device)
    axes = [torch.arange(n, dtype=torch.int32, device=meta.device) for n in new_shape]
    idx = torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1)
    old = meta.location_to_index(new_meta.index_to_location(idx))
    ci = [old[..., ax].clamp(0, n - 1) for ax, n in enumerate(meta.shape)]
    return values.reshape(-1)[flat_cell_index(*ci, meta.shape)], new_meta
