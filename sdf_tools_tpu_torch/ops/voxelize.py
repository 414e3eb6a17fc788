"""Point clouds -> occupancy grids (counterpart of ``sdf_tools_tpu/ops/voxelize.py``)."""
from __future__ import annotations

import torch

from ..grid import GridMeta


def voxelize_points(points: torch.Tensor, meta: GridMeta, weights: torch.Tensor | None = None) -> torch.Tensor:
    """Hard-scatter points into an occupancy grid [nx, ny, nz] f32 (max of
    the weights per cell, 1 by default). Points outside the grid are dropped.

    Out-of-bounds points are filtered out before the scatter: a flat index
    of -1 would write the last cell (as it does in the JAX package, whose
    ``mode="drop"`` scatter wraps -1 to the last cell before dropping)."""
    idx = meta.location_to_index(points)
    ok = meta.index_in_bounds(idx)
    nx, ny, nz = meta.shape
    flat = ((idx[..., 0] * ny + idx[..., 1]) * nz + idx[..., 2])[ok].to(torch.int64)
    w = torch.ones(points.shape[:-1], dtype=torch.float32, device=points.device) if weights is None else weights
    occ = torch.zeros(nx * ny * nz, dtype=torch.float32, device=points.device)
    occ.scatter_reduce_(0, flat, w[ok].to(torch.float32), reduce="amax")
    return occ.reshape(meta.shape)


def soft_voxelize_points(points: torch.Tensor, meta: GridMeta, temperature: float = 1.0) -> torch.Tensor:
    """Differentiable trilinear splatting -> soft occupancy in [0, 1].

    Each point deposits trilinear weights on its 8 surrounding cell
    centers, one corner at a time in the JAX package's order; the per-cell
    mass m becomes ``1 - exp(-m / temperature)``. Gradients flow to the
    point positions through the weights (``index_add`` is differentiable)."""
    res = meta.resolution
    g = meta.world_to_grid(points) / res - 0.5  # continuous cell-center coordinates
    base = torch.floor(g)
    frac = g - base
    base = base.to(torch.int32)
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
                ok = (cx >= 0) & (cx < nx) & (cy >= 0) & (cy < ny) & (cz >= 0) & (cz < nz)
                flat = torch.where(ok, (cx * ny + cy) * nz + cz, 0).reshape(-1).to(torch.int64)
                occ = occ.index_add(0, flat, torch.where(ok, w, 0.0).reshape(-1))
    return 1.0 - torch.exp(-occ.reshape(meta.shape) / temperature)
