"""SDF queries (counterpart of ``sdf_tools_tpu/ops/query.py``).

``estimate_distance`` interpolates center-corrected cell distances
(reference ``EstimateDistanceInterpolateFromNeighbors``, sdf.hpp:903-914;
corner selection sdf.hpp:798-833; center correction sdf.hpp:773-796) with
one stacked 8-corner flat gather. Beside it the grid gradients (central
differences with the reference's edge handling, sdf.hpp:405-526; the dense
field, sdf.hpp:341-358), the smoothed gradient (sdf.hpp:544-598), the
distance to the grid boundary (sdf.hpp:963-989) and the projections into
the volume and out of collision (sdf.hpp:996-1191). The float operations
are the JAX package's, in the same order; flat cell indices are int64.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..grid import SdfGrid, flat_cell_index, floor_to_int32, rotate_points

# project_out_of_collision: masked steps between two host checks of
# whether any point is still active
PROJECT_CHECK_EVERY = 16
# full_gradient: x-planes rotated at a time (bounds the rotation's temporaries)
_ROTATE_CHUNK = 32
_F32_EPS = float(torch.finfo(torch.float32).eps)


def _axis_interp_indices(i: torch.Tensor, size: int, offset: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-axis corner selection (reference sdf.hpp:798-833)."""
    lo_p = i
    up_p = torch.where(i + 1 >= size, i, i + 1)
    lo_p = torch.where(i + 1 >= size, torch.where(i - 1 < 0, i, i - 1), lo_p)
    lo_n = torch.where(i - 1 < 0, i, i - 1)
    up_n = torch.where(i - 1 < 0, torch.where(i + 1 >= size, i, i + 1), i)
    pos = offset >= 0.0
    return torch.where(pos, lo_p, lo_n), torch.where(pos, up_p, up_n)


def _gather(sdf: SdfGrid, ix: torch.Tensor, iy: torch.Tensor, iz: torch.Tensor) -> torch.Tensor:
    return sdf.values.reshape(-1)[flat_cell_index(ix, iy, iz, sdf.shape)]


def corrected_center_distance(sdf: SdfGrid, ix: torch.Tensor, iy: torch.Tensor, iz: torch.Tensor) -> torch.Tensor:
    """|d| shrunk by res/2 toward the surface at in-bounds cells (ix, iy, iz)
    (reference sdf.hpp:773-796; callers clamp the indices)."""
    v = _gather(sdf, ix, iy, iz)
    half = sdf.resolution * 0.5
    return torch.where(v >= 0.0, v - half, v + half)


def interpolation_stencil(sdf: SdfGrid, points: torch.Tensor):
    """The full trilinear stencil at world ``points`` [..., 3].

    Returns (flat_idx [..., 8] int64, weights [..., 8], value [...],
    grad_grid [..., 3], in_bounds [...]): the 8 corner flat indices and
    their weights, the interpolated center-corrected distance and its
    analytic gradient w.r.t. the grid-frame point. Corner order
    (m/p x)(m/p y)(m/p z), z fastest. A non-finite point is out of bounds
    (the JAX package takes a NaN point as cell 0's, in bounds)."""
    meta = sdf.meta
    res = sdf.resolution
    g = meta.world_to_grid(points)
    idx = floor_to_int32(g / res)
    in_bounds = meta.index_in_bounds(idx) & torch.isfinite(points).all(dim=-1)
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
        flat_cell_index(ix, iy, iz, shape)
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


def grid_aligned_gradient(
    sdf: SdfGrid, indices: torch.Tensor, enable_edge_gradients: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Finite-difference gradient at integer cell ``indices`` [..., 3]
    (reference ``GetGridAlignedGradient``, sdf.hpp:432-526): central
    differences / (2 res) inside; with ``enable_edge_gradients``, one-sided
    differences on edges (zero along an axis of one cell). Returns
    (gradient [..., 3], valid [...]); invalid cells (out of bounds, or on an
    edge without edge gradients) get zeros."""
    res = sdf.resolution
    in_bounds = sdf.meta.index_in_bounds(indices)
    interior = torch.ones_like(in_bounds)
    ci, lo, hi = [], [], []
    for ax, n in enumerate(sdf.shape):
        i = indices[..., ax]
        interior = interior & (i > 0) & (i < n - 1)
        c = i.clamp(0, n - 1)
        ci.append(c)
        lo.append((c - 1).clamp(min=0))
        hi.append((c + 1).clamp(max=n - 1))
    comps = []
    for ax in range(3):
        a_hi, a_lo = list(ci), list(ci)
        a_hi[ax], a_lo[ax] = hi[ax], lo[ax]
        incr = (hi[ax] - lo[ax]).to(sdf.values.dtype) * res
        diff = _gather(sdf, *a_hi) - _gather(sdf, *a_lo)
        comps.append(torch.where(incr > 0, diff / torch.maximum(incr, res), 0.0))
    grad = torch.stack(comps, dim=-1)
    valid = in_bounds & (interior | enable_edge_gradients)
    return torch.where(valid[..., None], grad, 0.0), valid


def gradient(
    sdf: SdfGrid, indices: torch.Tensor, enable_edge_gradients: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Grid-aligned gradient rotated into the world frame (sdf.hpp:405-430)."""
    g, valid = grid_aligned_gradient(sdf, indices, enable_edge_gradients)
    return rotate_points(sdf.meta.origin_transform[:3, :3], g), valid


def full_gradient(sdf: SdfGrid, enable_edge_gradients: bool = True, gradient_function=None) -> torch.Tensor:
    """Dense world-frame gradient field [nx, ny, nz, 3] (reference
    ``GetFullGradient``, sdf.hpp:341-358).

    Each axis's differences are written by slices into one preallocated
    output, with no field-sized temporary: central / (2 res) inside, one-sided / res on the two edge
    planes, zero along an axis of one cell; without
    ``enable_edge_gradients`` every cell on an edge of any axis is zero.
    The rotation into the world frame runs in place, a few x-planes at a
    time. ``gradient_function(sdf, indices, enable_edge_gradients)``, if
    given, replaces the built-in rule: it gets the dense int32 index grid
    [nx, ny, nz, 3] and returns the world-frame gradients."""
    nx, ny, nz = sdf.shape
    dev = sdf.values.device
    if gradient_function is not None:
        axes = [torch.arange(n, dtype=torch.int32, device=dev) for n in (nx, ny, nz)]
        idx = torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1)
        return gradient_function(sdf, idx, enable_edge_gradients)
    v = sdf.values
    res = sdf.resolution
    out = torch.empty((nx, ny, nz, 3), dtype=v.dtype, device=dev)
    for ax, n in enumerate(sdf.shape):
        o = out[..., ax]
        if n == 1:
            o.zero_()
            continue
        torch.sub(v.narrow(ax, 2, n - 2), v.narrow(ax, 0, n - 2), out=o.narrow(ax, 1, n - 2)).div_(2.0 * res)
        torch.sub(v.narrow(ax, 1, 1), v.narrow(ax, 0, 1), out=o.narrow(ax, 0, 1)).div_(res)
        torch.sub(v.narrow(ax, n - 1, 1), v.narrow(ax, n - 2, 1), out=o.narrow(ax, n - 1, 1)).div_(res)
    if not enable_edge_gradients:
        for ax, n in enumerate(sdf.shape):
            out.narrow(ax, 0, 1).zero_()
            out.narrow(ax, n - 1, 1).zero_()
    rot = sdf.meta.origin_transform[:3, :3]
    for x0 in range(0, nx, _ROTATE_CHUNK):
        part = out[x0 : x0 + _ROTATE_CHUNK]
        part.copy_(rotate_points(rot, part))
    return out


def smooth_gradient(sdf: SdfGrid, points: torch.Tensor, nominal_window_size) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric differences of ``estimate_distance`` over a window, with
    the per-axis one-sided fallback (reference ``GetSmoothGradient``,
    sdf.hpp:544-598, 656-697). Returns (gradient [..., 3], valid [...]);
    invalid where the window is unusable on some axis or the point is out
    of bounds."""
    w = torch.as_tensor(nominal_window_size, dtype=points.dtype, device=points.device).abs()
    v0, ok_all = estimate_distance(sdf, points)
    comps = []
    for ax in range(3):
        e = torch.zeros(3, dtype=points.dtype, device=points.device)
        e[ax] = 1.0
        vm, okm = estimate_distance(sdf, points - w * e)
        vp, okp = estimate_distance(sdf, points + w * e)
        central = (vp - vm) / (2.0 * w)
        fwd = (vp - v0) / w
        bwd = (v0 - vm) / w
        comps.append(torch.where(okm & okp, central, torch.where(okm, bwd, torch.where(okp, fwd, 0.0))))
        ok_all = ok_all & (okm | okp)
    return torch.stack(comps, dim=-1), ok_all


def distance_to_boundary(sdf: SdfGrid, points: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The smallest axis-aligned signed displacement to the grid boundary
    (sdf.hpp:976-989), and whether the point is inside. At ties the first
    axis wins, as ``jnp.argmin`` and ``torch.argmin`` both pick the first
    minimum."""
    g = sdf.meta.world_to_grid(points)
    sizes = sdf.meta.sizes.to(g.dtype)
    disp = torch.minimum(g, sizes - g)
    inside = (disp >= 0.0).all(dim=-1)
    amin = disp.abs().argmin(dim=-1, keepdim=True)
    return torch.take_along_dim(disp, amin, dim=-1)[..., 0], inside


def project_into_valid_volume(sdf: SdfGrid, points: torch.Tensor, minimum_distance=0.0) -> torch.Tensor:
    """Clamp world points into the grid volume, ``minimum_distance`` (plus
    res * 1e-4) inside its faces (sdf.hpp:1162-1191); points already inside
    come back unchanged."""
    g = sdf.meta.world_to_grid(points)
    margin = torch.as_tensor(minimum_distance, dtype=g.dtype, device=g.device) + sdf.resolution * 1e-4
    sizes = sdf.meta.sizes.to(g.dtype)
    clamped = torch.minimum(torch.maximum(g, margin), sizes - margin)
    changed = (clamped != g).any(dim=-1, keepdim=True)
    return torch.where(changed, sdf.meta.grid_to_world(clamped), points)


def project_out_of_collision(
    sdf: SdfGrid,
    points: torch.Tensor,
    minimum_distance=0.0,
    stepsize_multiplier: float = 1.0 / 8.0,
    max_steps: int = 1000,
    diag: bool = False,
):
    """Gradient-ascent projection to a distance above ``minimum_distance``
    (sdf.hpp:1041-1122). Returns (projected points [..., 3], success [...]),
    and with ``diag`` also {"steps", "host_checks", "nudges"} (steps run,
    host syncs, and replaced steps, below).

    Points out of the volume are first clamped into it. Each step moves
    every active point (distance <= minimum_distance, not stuck) along its
    normalised edge-aware grid gradient by min(res * stepsize_multiplier,
    the distance still needed); a point whose gradient is invalid or
    shorter than res / 4 is frozen as stuck and fails (where the reference
    throws). The JAX package runs this as a while loop that stops when no
    point is active or after ``max_steps`` steps. Here the host checks for
    an active point only every ``PROJECT_CHECK_EVERY`` steps (one sync each)
    and never runs more than ``max_steps`` steps; a step with no active
    point moves nothing and freezes nothing, so the extra steps change no
    point and the result is the JAX loop's, step for step.

    One departure: where a step is shorter than the spacing of the point's
    float32 grid-frame coordinates (the last steps before the margin of
    res * stepsize_multiplier * 1e-4, on grids some 300 cells or more a
    side), it moves no coordinate, and the JAX loop repeats it until
    ``max_steps`` and reports failure. Such a step is replaced by one of
    4 * eps * max|coordinate|, which moves the point by one or two units in
    the last place along the gradient. Every other step is the JAX loop's."""
    flat = points.reshape(-1, 3)
    meta = sdf.meta
    res = sdf.resolution
    min_dist = torch.as_tensor(minimum_distance, dtype=flat.dtype, device=flat.device)
    margin = min_dist + res * stepsize_multiplier * 1e-4
    max_step = res * stepsize_multiplier

    def grid_est(gpts):
        return estimate_distance(sdf, meta.grid_to_world(gpts))[0]

    g = meta.world_to_grid(project_into_valid_volume(sdf, flat))
    stuck = torch.zeros(flat.shape[:1], dtype=torch.bool, device=flat.device)
    steps = host_checks = 0
    nudges = torch.zeros((), dtype=torch.int64, device=flat.device)
    while steps < max_steps:
        d = grid_est(g)
        active = (d <= min_dist) & ~stuck
        if steps % PROJECT_CHECK_EVERY == 0:
            host_checks += 1
            if not bool(active.any()):
                break
        idx = floor_to_int32(g / res)
        grad, gvalid = grid_aligned_gradient(sdf, idx, enable_edge_gradients=True)
        norm = torch.linalg.vector_norm(grad, dim=-1)
        ok = gvalid & (norm > res * 0.25)
        step = torch.minimum(max_step, margin - d)
        direction = grad / torch.clamp(norm, min=1e-30)[..., None]
        move = active & ok
        new_g = g + direction * step[..., None]
        # a step below the spacing of the point's float32 coordinates moves
        # no coordinate; take the smallest step that moves one instead
        frozen = move & (new_g == g).all(dim=-1)
        nudges += frozen.sum()
        nudge = (4.0 * _F32_EPS) * g.abs().amax(dim=-1)
        new_g = torch.where(frozen[..., None], g + direction * nudge[..., None], new_g)
        g = torch.where(move[..., None], new_g, g)
        stuck = stuck | (active & ~ok)
        steps += 1
    success = (grid_est(g) > min_dist) & ~stuck
    out = meta.grid_to_world(g).reshape(points.shape), success.reshape(points.shape[:-1])
    return (*out, {"steps": steps, "host_checks": host_checks, "nudges": int(nudges)}) if diag else out
