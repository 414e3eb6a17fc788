"""Trilinear SDF queries (counterpart of ``sdf_tools_tpu/ops/query.py:45-204``).

``estimate_distance`` interpolates center-corrected cell distances
(reference ``EstimateDistanceInterpolateFromNeighbors``, sdf.hpp:903-914;
corner selection sdf.hpp:798-833; center correction sdf.hpp:773-796) with
one stacked 8-corner flat gather. The float operations are the JAX
package's, in the same order.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..grid import SdfGrid


def _axis_interp_indices(i: torch.Tensor, size: int, offset: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-axis corner selection (reference sdf.hpp:798-833)."""
    lo_p = i
    up_p = torch.where(i + 1 >= size, i, i + 1)
    lo_p = torch.where(i + 1 >= size, torch.where(i - 1 < 0, i, i - 1), lo_p)
    lo_n = torch.where(i - 1 < 0, i, i - 1)
    up_n = torch.where(i - 1 < 0, torch.where(i + 1 >= size, i, i + 1), i)
    pos = offset >= 0.0
    return torch.where(pos, lo_p, lo_n), torch.where(pos, up_p, up_n)


def _flat_cell_index(ix: torch.Tensor, iy: torch.Tensor, iz: torch.Tensor, shape) -> torch.Tensor:
    """Flat int64 index of in-range cells (ix, iy, iz) of a grid of
    ``shape``: widened before the products, so grids of 2^31 cells and more
    index right."""
    return (ix.to(torch.int64) * shape[1] + iy) * shape[2] + iz


def interpolation_stencil(sdf: SdfGrid, points: torch.Tensor):
    """The full trilinear stencil at world ``points`` [..., 3].

    Returns (flat_idx [..., 8] int64, weights [..., 8], value [...],
    grad_grid [..., 3], in_bounds [...]): the 8 corner flat indices and
    their weights, the interpolated center-corrected distance and its
    analytic gradient w.r.t. the grid-frame point. Corner order
    (m/p x)(m/p y)(m/p z), z fastest."""
    meta = sdf.meta
    res = sdf.resolution
    g = meta.world_to_grid(points)
    idx = torch.floor(g / res).to(torch.int32)
    in_bounds = meta.index_in_bounds(idx)
    shape = meta.shape

    lo, up = [], []
    for ax in range(3):
        safe = idx[..., ax].clamp(0, shape[ax] - 1)
        offset = g[..., ax] - (safe.to(g.dtype) + 0.5) * res
        l_ax, u_ax = _axis_interp_indices(safe, shape[ax], offset)
        lo.append(l_ax)
        up.append(u_ax)

    half = res * 0.5
    idx8 = [
        _flat_cell_index(ix, iy, iz, shape)
        for ix in (lo[0], up[0])
        for iy in (lo[1], up[1])
        for iz in (lo[2], up[2])
    ]
    idx8s = torch.stack(idx8, dim=-1)  # [..., 8]
    v8 = sdf.values.reshape(-1)[idx8s]
    c8s = torch.where(v8 >= 0.0, v8 - half, v8 + half)

    inv_res = 1.0 / res
    axp = (g[..., 0] - (lo[0].to(g.dtype) + 0.5) * res) * inv_res
    ayp = (g[..., 1] - (lo[1].to(g.dtype) + 0.5) * res) * inv_res
    azp = (g[..., 2] - (lo[2].to(g.dtype) + 0.5) * res) * inv_res
    wx = (1.0 - axp, axp)
    wy = (1.0 - ayp, ayp)
    wz = (1.0 - azp, azp)

    w8 = []
    value = torch.zeros(g.shape[:-1], dtype=g.dtype, device=g.device)
    gx = torch.zeros_like(value)
    gy = torch.zeros_like(value)
    gz = torch.zeros_like(value)
    k = 0
    for i in (0, 1):
        sx = 1.0 if i else -1.0
        for j in (0, 1):
            sy = 1.0 if j else -1.0
            for l in (0, 1):
                sz = 1.0 if l else -1.0
                w = wx[i] * wy[j] * wz[l]
                w8.append(w)
                c = c8s[..., k]
                value = value + w * c
                gx = gx + sx * wy[j] * wz[l] * c
                gy = gy + wx[i] * sy * wz[l] * c
                gz = gz + wx[i] * wy[j] * sz * c
                k += 1
    grad_grid = torch.stack([gx, gy, gz], dim=-1) * inv_res
    return idx8s, torch.stack(w8, dim=-1), value, grad_grid, in_bounds


def estimate_distance(sdf: SdfGrid, points: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Trilinearly interpolated signed distance at world ``points`` [..., 3].

    Returns (distance [...], in_bounds [...]); out-of-bounds queries give
    ``sdf.oob_value`` (reference ``EstimateDistance4d``, sdf.hpp:947-961)."""
    _, _, value, _, in_bounds = interpolation_stencil(sdf, points)
    return torch.where(in_bounds, value, sdf.oob_value.to(value.dtype)), in_bounds


def autodiff_gradient(sdf: SdfGrid, points: torch.Tensor) -> torch.Tensor:
    """d(estimate_distance)/d(world point) by autograd on the points;
    [..., 3] -> [..., 3], zeros out of bounds."""
    p = points.detach().reshape(-1, 3).clone().requires_grad_(True)
    with torch.enable_grad():
        v, ok = estimate_distance(sdf, p)
        (grads,) = torch.autograd.grad(v.sum(), p)
    grads = torch.where(ok[:, None], grads, 0.0)
    return grads.reshape(points.shape)
