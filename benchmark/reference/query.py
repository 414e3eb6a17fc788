"""Plain PyTorch reference of the queries on a signed field with an
identity origin: upstream sdf_tools' ``EstimateDistance`` (trilinear
interpolation of cell-centre distances shrunk by half a cell toward the
surface, the corners chosen on the side of the cell centre the point lies)
and ``GetGradient`` (central differences inside, one-sided on the edges).

The interpolation and the differences are taken in float64 from the
field's float32 values. A point's cell is ``floor(p / resolution)`` in
float32, as the configuration's float32 grid states it, so that the two
sides agree on which cell a point lies in; everything after is float64.
"""
from __future__ import annotations

import torch


def cell_index(points: torch.Tensor, resolution: float) -> torch.Tensor:
    """int64 cell [..., 3] of float32 world points (identity origin)."""
    res32 = torch.tensor(resolution, dtype=torch.float32, device=points.device)
    return torch.floor(points.to(torch.float32) / res32).to(torch.int64)


def _corners(i: torch.Tensor, size: int, offset: torch.Tensor):
    """(lower, upper) cell of one axis (sdf.hpp's corner choice): the
    neighbour on the point's side of the centre, the other side at an edge."""
    pos = offset >= 0
    up_p = torch.where(i + 1 >= size, i, i + 1)
    lo_p = torch.where(i + 1 >= size, (i - 1).clamp(min=0), i)
    lo_n = torch.where(i - 1 < 0, i, i - 1)
    up_n = torch.where(i - 1 < 0, (i + 1).clamp(max=size - 1), i)
    return torch.where(pos, lo_p, lo_n), torch.where(pos, up_p, up_n)


def estimate_distance(values: torch.Tensor, resolution: float, oob: float, points: torch.Tensor):
    """(distance [P] float64, in_bounds [P]) at float32 points [P, 3]."""
    shape = values.shape
    res = float(torch.tensor(resolution, dtype=torch.float32))
    idx = cell_index(points, resolution)
    ok = torch.isfinite(points).all(dim=-1)
    for a in range(3):
        ok &= (idx[:, a] >= 0) & (idx[:, a] < shape[a])
    p = points.to(torch.float64)
    flat = values.reshape(-1)
    lo, up = [], []
    for a in range(3):
        i = idx[:, a].clamp(0, shape[a] - 1)
        l, u = _corners(i, shape[a], p[:, a] - (i + 0.5) * res)
        lo.append(l)
        up.append(u)
    # weights along each axis from the lower corner's centre, over one cell
    w = [(p[:, a] - (lo[a] + 0.5) * res) / res for a in range(3)]
    out = torch.zeros(points.shape[0], dtype=torch.float64, device=points.device)
    for cx, wx in ((lo[0], 1 - w[0]), (up[0], w[0])):
        for cy, wy in ((lo[1], 1 - w[1]), (up[1], w[1])):
            for cz, wz in ((lo[2], 1 - w[2]), (up[2], w[2])):
                v = flat[(cx * shape[1] + cy) * shape[2] + cz].to(torch.float64)
                v = torch.where(v >= 0, v - 0.5 * res, v + 0.5 * res)
                out += wx * wy * wz * v
    return torch.where(ok, out, torch.tensor(oob, dtype=torch.float64)), ok


def gradient(values: torch.Tensor, resolution: float, idx: torch.Tensor):
    """(gradient [P, 3] float64, valid [P]) at int64 cells [P, 3], with
    edge gradients: (v[hi] - v[lo]) / ((hi - lo) res) per axis, hi and lo
    the neighbours clamped into the grid; zero along an axis of one cell
    and at cells out of the grid."""
    shape = values.shape
    res = float(torch.tensor(resolution, dtype=torch.float32))
    ok = torch.ones(idx.shape[0], dtype=torch.bool, device=idx.device)
    for a in range(3):
        ok &= (idx[:, a] >= 0) & (idx[:, a] < shape[a])
    c = [idx[:, a].clamp(0, shape[a] - 1) for a in range(3)]
    flat = values.reshape(-1)
    comps = []
    for a in range(3):
        hi, lo = list(c), list(c)
        hi[a] = (c[a] + 1).clamp(max=shape[a] - 1)
        lo[a] = (c[a] - 1).clamp(min=0)
        vh = flat[(hi[0] * shape[1] + hi[1]) * shape[2] + hi[2]].to(torch.float64)
        vl = flat[(lo[0] * shape[1] + lo[1]) * shape[2] + lo[2]].to(torch.float64)
        span = (hi[a] - lo[a]).to(torch.float64) * res
        comps.append(torch.where(span > 0, (vh - vl) / span.clamp(min=res), 0.0))
    g = torch.stack(comps, dim=-1)
    return torch.where(ok[:, None], g, 0.0), ok
