"""Point clouds, meshes and images -> occupancy grids (counterpart of
``sdf_tools_tpu/ops/voxelize.py``)."""
from __future__ import annotations

import numpy as np
import torch

from ..grid import GridMeta, as_tensor_on, flat_cell_index, float_to_int32, floor_to_int32


def voxelize_points(points: torch.Tensor, meta: GridMeta, weights: torch.Tensor | None = None) -> torch.Tensor:
    """Hard-scatter points into an occupancy grid [nx, ny, nz] f32 (max of
    the weights per cell, 1 by default). Points outside the grid, and
    non-finite points, are dropped.

    Out-of-bounds points are filtered out before the scatter: a flat index
    of -1 would write the last cell (as it does in the JAX package, whose
    ``mode="drop"`` scatter wraps -1 to the last cell before dropping; it
    also fills cell [0, 0, 0] for a NaN point)."""
    idx = meta.location_to_index(points)
    ok = meta.index_in_bounds(idx) & torch.isfinite(points).all(dim=-1)
    nx, ny, nz = meta.shape
    flat = flat_cell_index(idx[..., 0], idx[..., 1], idx[..., 2], meta.shape)[ok]
    w = torch.ones(points.shape[:-1], dtype=torch.float32, device=points.device) if weights is None else weights
    occ = torch.zeros(nx * ny * nz, dtype=torch.float32, device=points.device)
    occ.scatter_reduce_(0, flat, w[ok].to(torch.float32), reduce="amax")
    return occ.reshape(meta.shape)


def soft_voxelize_points(points: torch.Tensor, meta: GridMeta, temperature: float = 1.0) -> torch.Tensor:
    """Differentiable trilinear splatting -> soft occupancy in [0, 1].

    Each point deposits trilinear weights on its 8 surrounding cell
    centers, one corner at a time in the JAX package's order; the per-cell
    mass m becomes ``1 - exp(-m / temperature)``. Gradients flow to the
    point positions through the weights (``index_add`` is differentiable).
    Non-finite points deposit nothing (the JAX package adds a NaN point's
    NaN weights to the cells around [0, 0, 0])."""
    res = meta.resolution
    g = meta.world_to_grid(points) / res - 0.5  # continuous cell-center coordinates
    frac = g - torch.floor(g)
    base = floor_to_int32(g)
    finite = torch.isfinite(points).all(dim=-1)
    nx, ny, nz = meta.shape
    occ = torch.zeros(nx * ny * nz, dtype=torch.float32, device=points.device)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                cx, cy, cz = base[..., 0] + dx, base[..., 1] + dy, base[..., 2] + dz
                w = (
                    (frac[..., 0] if dx else 1.0 - frac[..., 0])
                    * (frac[..., 1] if dy else 1.0 - frac[..., 1])
                    * (frac[..., 2] if dz else 1.0 - frac[..., 2])
                )
                ok = finite & (cx >= 0) & (cx < nx) & (cy >= 0) & (cy < ny) & (cz >= 0) & (cz < nz)
                flat = torch.where(ok, (cx * ny + cy) * nz + cz, 0).reshape(-1).to(torch.int64)
                occ = occ.index_add(0, flat, torch.where(ok, w, 0.0).reshape(-1))
    return 1.0 - torch.exp(-occ.reshape(meta.shape) / temperature)


def _mesh_parity_batch(v0, v1, v2, cx, cy, nz: int, res: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """Add one triangle batch's vertical-ray crossings to ``counts``
    [nx, ny, nz] int64, the number of crossings above each cell center.
    v0/v1/v2: [B, 3] vertices in the grid frame; cx/cy: [nx], [ny]
    cell-center x and y. Each triangle's crossing with the column's ray
    (2-D edge functions, barycentric z) falls in bucket k, the number of
    cell centers below it; a column's crossings above center iz are those
    with k > iz (a reverse cumulative sum). Pairs that do not cross are
    dropped (the JAX package scatters them to index -1, which wraps to the
    last column's top bucket)."""
    px = cx[None, :, None]
    py = cy[None, None, :]

    def edge(a, b):
        ax, ay = a[:, 0, None, None], a[:, 1, None, None]
        bx, by = b[:, 0, None, None], b[:, 1, None, None]
        return (bx - ax) * (py - ay) - (by - ay) * (px - ax)

    e0, e1, e2 = edge(v0, v1), edge(v1, v2), edge(v2, v0)
    denom = ((v1[:, 0] - v0[:, 0]) * (v2[:, 1] - v0[:, 1]) - (v1[:, 1] - v0[:, 1]) * (v2[:, 0] - v0[:, 0]))[:, None, None]
    pos = (e0 > 0) & (e1 > 0) & (e2 > 0)
    neg = (e0 < 0) & (e1 < 0) & (e2 < 0)
    flat_tri = denom.abs() > 1e-12
    inside = (pos | neg) & flat_tri  # vertical triangles are skipped
    safe = torch.where(flat_tri, denom, 1.0)
    zc = (e1 / safe) * v0[:, 2, None, None] + (e2 / safe) * v1[:, 2, None, None] + (e0 / safe) * v2[:, 2, None, None]
    k = float_to_int32(torch.ceil(zc / res - 0.5).clamp(0, nz)).to(torch.int64)
    nx, ny = counts.shape[0], counts.shape[1]
    col = torch.arange(nx * ny, device=counts.device).reshape(1, nx, ny) * (nz + 1)
    hist = torch.bincount((col + k)[inside], minlength=nx * ny * (nz + 1)).reshape(nx, ny, nz + 1)
    return counts + hist.flip(-1).cumsum(-1).flip(-1)[..., 1:]


def mesh_to_occupancy(vertices, faces, meta: GridMeta, batch: int = 256) -> torch.Tensor:
    """Solid-voxelize a watertight triangle mesh by ray parity: occupancy
    [nx, ny, nz] f32 on ``meta``'s device, a cell filled iff an odd number
    of triangles cross the vertical ray above its center. Triangles go in
    batches of ``batch`` (padded with degenerate faces, which cross
    nothing). Cell centers are offset by about 1e-4 res in x and y, so that
    rays through edges and vertices have measure zero on real meshes."""
    dev = meta.device
    verts = torch.as_tensor(np.asarray(vertices, np.float32), device=dev)
    tris = torch.as_tensor(np.asarray(faces, np.int64), device=dev)
    if verts.ndim != 2 or verts.shape[-1] != 3:
        raise ValueError(f"vertices must be [V, 3], got {tuple(verts.shape)}")
    if tris.ndim != 2 or tris.shape[-1] != 3:
        raise ValueError(f"faces must be [T, 3], got {tuple(tris.shape)}")
    nx, ny, nz = meta.shape
    res = meta.resolution_float
    vg = meta.world_to_grid(verts)
    cx = (torch.arange(nx, dtype=torch.float32, device=dev) + 0.5) * res + 1.23456789e-4 * res
    cy = (torch.arange(ny, dtype=torch.float32, device=dev) + 0.5) * res + 2.34567891e-4 * res
    T = tris.shape[0]
    pad = (-T) % batch
    if pad:
        tris = torch.cat([tris, torch.zeros((pad, 3), dtype=tris.dtype, device=dev)])
    counts = torch.zeros((nx, ny, nz), dtype=torch.int64, device=dev)
    for i in range(0, T + pad, batch):
        f = tris[i : i + batch]
        counts = _mesh_parity_batch(vg[f[:, 0]], vg[f[:, 1]], vg[f[:, 2]], cx, cy, nz, meta.resolution, counts)
    return (counts % 2 == 1).to(torch.float32)


def image_to_occupancy(image, threshold: float = 0.5, *, device="cuda") -> torch.Tensor:
    """Binary image [h, w] (row = y, column = x) -> occupancy [nx = w,
    ny = h, 1] f32 (the reference's utils_2d convention: image[y, x] marks
    cell (x, y)). A tensor stays on its device; numpy input goes to
    ``device``."""
    img = as_tensor_on(image, device)
    return (img > threshold).to(torch.float32).T.contiguous()[:, :, None]
