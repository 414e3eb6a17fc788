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
