"""Plain PyTorch reference of the depth render: a sphere-traced march over
a signed field with an identity origin.

A frozen copy of the march that the port and the JAX package define as the
render's semantics (ray/box entry, empty-space skipping on a min-pooled
field, a nearest-cell march, a trilinear crossing, six bisection steps), in
the same masked steps and the same order, written out here on bare tensors
so that the yardstick does not move with the program. ``dtype`` runs every
float of it (field, rays, depths) in another precision: the control.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .query import _corners


def _cell(x: torch.Tensor) -> torch.Tensor:
    """floor(x) as int64, NaN to 0 and saturated far outside any grid."""
    return torch.floor(x).nan_to_num(0.0).clamp(-(2.0**40), 2.0**40).to(torch.int64)


def _flat(ci, shape):
    ok = torch.ones(ci[0].shape, dtype=torch.bool, device=ci[0].device)
    for a in range(3):
        ok &= (ci[a] >= 0) & (ci[a] < shape[a])
    c = [ci[a].clamp(0, shape[a] - 1) for a in range(3)]
    return (c[0] * shape[1] + c[1]) * shape[2] + c[2], ok


def min_pool(values: torch.Tensor, factor: int = 8) -> torch.Tensor:
    """Separable min-pool, window factor + 2, stride factor, +inf padding
    (1, window - 1) on each axis."""
    window = factor + 2
    pooled = values
    for ax in range(3):
        pad = [0] * 6
        pad[2 * (2 - ax)] = 1
        pad[2 * (2 - ax) + 1] = window - 1
        pooled = F.pad(pooled, pad, value=math.inf).unfold(ax, window, factor).amin(-1)
    return pooled


def trilinear(values, res, oob, p):
    """(distance, in_bounds) at points p [..., 3]: centre-corrected trilinear
    interpolation, ``oob`` outside."""
    shape = values.shape
    idx = [_cell(p[..., a] / res) for a in range(3)]
    ok = torch.isfinite(p).all(dim=-1)
    for a in range(3):
        ok &= (idx[a] >= 0) & (idx[a] < shape[a])
    lo, up = [], []
    for a in range(3):
        safe = idx[a].clamp(0, shape[a] - 1)
        l_, u_ = _corners(safe, shape[a], p[..., a] - (safe.to(p.dtype) + 0.5) * res)
        lo.append(l_)
        up.append(u_)
    flat = values.reshape(-1)
    half = res * 0.5
    inv_res = 1.0 / res
    w = [(p[..., a] - (lo[a].to(p.dtype) + 0.5) * res) * inv_res for a in range(3)]
    value = torch.zeros(p.shape[:-1], dtype=p.dtype, device=p.device)
    for cx, wx in ((lo[0], 1.0 - w[0]), (up[0], w[0])):
        for cy, wy in ((lo[1], 1.0 - w[1]), (up[1], w[1])):
            for cz, wz in ((lo[2], 1.0 - w[2]), (up[2], w[2])):
                v = flat[(cx * shape[1] + cy) * shape[2] + cz]
                c = torch.where(v >= 0.0, v - half, v + half)
                value = value + wx * wy * wz * c
    return torch.where(ok, value, torch.as_tensor(oob, dtype=p.dtype, device=p.device)), ok


def march(values, res: float, oob: float, o, v, t_min: float, t_max: float, eps: float, max_steps: int,
          dtype=torch.float32, pooled=None):
    """(depth, hit) of rays (o, v) [..., 3] over the field ``values`` (an
    identity origin, cells of ``res``). ``pooled``: ``min_pool(values)``
    already taken, to share it between blocks of rays."""
    values = values.to(dtype)
    o, v = o.to(dtype), v.to(dtype)
    res = torch.tensor(res, dtype=torch.float32, device=o.device).to(dtype)
    shape = values.shape

    sizes = torch.tensor(shape, dtype=torch.float32, device=o.device).to(dtype) * res
    safe_v = torch.where(v.abs() > 1e-12, v, 1e-12)
    t_a = (0.0 - o) / safe_v
    t_b = (sizes - o) / safe_v
    t_entry = torch.minimum(t_a, t_b).amax(dim=-1)
    t_exit = torch.maximum(t_a, t_b).amin(dim=-1)
    finite = torch.isfinite(o).all(dim=-1) & torch.isfinite(v).all(dim=-1)
    misses_box = (t_entry > t_exit) | (t_exit < t_min) | ~finite
    ms = res * 0.5

    def dist_at(t):
        return trilinear(values, res, oob, o + t[..., None] * v)

    t0 = torch.maximum(torch.full_like(t_entry, t_min), t_entry)
    factor = 8
    coarse_steps = max(8, max_steps // 8)
    if min(shape) >= 4 * factor:
        cv = (min_pool(values, factor) if pooled is None else pooled.to(dtype)) - res * 0.87
        c_shape, c_flat = cv.shape, cv.reshape(-1)
        inv_c = 1.0 / (res * factor)
        switch = 2.0 * res
        t, alive = t0, ~misses_box
        for _ in range(coarse_steps):
            g = o + t[..., None] * v
            flat, _ = _flat([_cell(g[..., a] * inv_c) for a in range(3)], c_shape)
            dc = c_flat[flat]
            can_skip = dc > switch
            t_new = torch.where(alive & can_skip, t + torch.maximum(dc, res), t)
            out = (t_new > t_max) | (t_new > t_exit + res)
            alive = alive & can_skip & ~out
            t = t_new
        t0 = t

    values_flat = values.reshape(-1)
    inv_res = 1.0 / res
    nn_slack = res * 0.87

    def nn_dist(t):
        g = o + t[..., None] * v
        flat, ok = _flat([_cell(g[..., a] * inv_res) for a in range(3)], shape)
        return torch.where(ok, values_flat[flat], res), ok

    rounds, tri_steps = 3, 6
    nn_steps = max(4, max_steps // rounds)
    t, t_prev = t0, t0
    in_box = ~misses_box
    hit = torch.zeros_like(in_box)
    for _ in range(rounds):
        near = torch.zeros_like(in_box)
        for _ in range(nn_steps):
            dnn, ok = nn_dist(t)
            near_now = ok & (dnn < 2.0 * res)
            advance = in_box & ~hit & ~near & ~near_now
            t_new = torch.where(advance, t + torch.maximum(dnn - nn_slack, ms), t)
            t_prev = torch.where(advance, t, t_prev)
            in_box = in_box & ~((t_new > t_max) | (t_new > t_exit + res))
            near = near | (in_box & ~hit & near_now)
            t = t_new
        d, _ = dist_at(t)
        for _ in range(tri_steps):
            advance = near & in_box & ~hit & (d >= eps)
            t_new = torch.where(advance, t + torch.maximum(d, ms), t)
            t_prev = torch.where(advance, t, t_prev)
            d_new, _ = dist_at(t_new)
            in_box = in_box & ~((t_new > t_max) | (t_new > t_exit + res))
            d = torch.where(advance, d_new, d)
            t = t_new
        hit = hit | (near & in_box & (d < eps))

    d_final, ok_final = dist_at(t)
    hit = hit & ok_final & (d_final < eps) & (t <= t_max) & ~misses_box
    lo, hi = t_prev, t
    for _ in range(6):
        mid = 0.5 * (lo + hi)
        d_mid, _ = dist_at(mid)
        outside = d_mid > 0.0
        lo = torch.where(outside, mid, lo)
        hi = torch.where(outside, hi, mid)
    depth = torch.where(hit, hi, torch.as_tensor(t_max, dtype=dtype, device=o.device))
    return depth, hit


def march_blocks(values, res, oob, o, v, kw: dict, block: int = 1 << 20, dtype=torch.float32):
    """``march`` over flat blocks of ``block`` rays: (depth, hit) shaped like
    the rays, depth in float32."""
    shape = o.shape[:-1]
    of, vf = o.reshape(-1, 3), v.reshape(-1, 3)
    pooled = min_pool(values.to(dtype), 8) if min(values.shape) >= 32 else None
    depth = torch.empty(of.shape[0], dtype=torch.float32, device=o.device)
    hit = torch.empty(of.shape[0], dtype=torch.bool, device=o.device)
    for a in range(0, of.shape[0], block):
        d, h = march(values, res, oob, of[a : a + block], vf[a : a + block], dtype=dtype, pooled=pooled, **kw)
        depth[a : a + block], hit[a : a + block] = d.to(torch.float32), h
    return depth.reshape(shape), hit.reshape(shape)
