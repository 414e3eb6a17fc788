"""Sphere-traced depth rendering over an SdfGrid, differentiable.

Counterpart of ``sdf_tools_tpu/ops/render.py``: ``camera_rays``, the exact
march ``_trace_depth`` (ray/AABB entry -> coarse min-pool empty-space
skipping -> nearest-neighbour march -> trilinear crossing -> bisection
refinement), with the same masked per-ray steps in the same order, so hits
and depths follow the JAX march, and the implicit-function-theorem
backward ``ift_backward`` (``_std_bwd``), shared by both forwards. Every
ray of the march takes every step; on a GPU that is many small launches.

The other forward is the plane sweep (``ops/render_plane.py``, kernel K8).
``backend="auto"`` takes it for CUDA tensors on supported grids and
image-shaped bundles, as the JAX package does on its accelerator, and the
march elsewhere.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from ..grid import SdfGrid, flat_cell_index, floor_to_int32, rotate_points
from . import query, render_plane


class RenderResult(NamedTuple):
    depth: torch.Tensor  # [...]: hit distance along the ray, t_max where missed
    hit: torch.Tensor  # [...] bool
    steps: torch.Tensor  # [...] int32 march advances (bisection excluded)


def coarse_min_pool(values: torch.Tensor, factor: int = 8) -> torch.Tensor:
    """Separable min-pool with window ``factor+2``, stride ``factor`` and
    +inf padding (1, window-1) per axis: ``lax.reduce_window`` as the JAX
    march calls it. Each axis of length n becomes ``n // factor + 1``."""
    window = factor + 2
    pooled = values
    for ax in range(3):
        pad = [0] * 6  # F.pad lists the last axis first
        pad[2 * (2 - ax)] = 1
        pad[2 * (2 - ax) + 1] = window - 1
        pooled = F.pad(pooled, pad, value=math.inf).unfold(ax, window, factor).amin(-1)
    return pooled


def _flat_index(ci: torch.Tensor, shape) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int64 flat index of the clamped cell, in-bounds) for int32 cells [..., 3]."""
    ok = (ci[..., 0] >= 0) & (ci[..., 0] < shape[0])
    for ax in (1, 2):
        ok = ok & (ci[..., ax] >= 0) & (ci[..., ax] < shape[ax])
    c = [ci[..., ax].clamp(0, shape[ax] - 1) for ax in range(3)]
    return flat_cell_index(*c, shape), ok


def _trace_depth(
    sdf: SdfGrid,
    origins: torch.Tensor,
    directions: torch.Tensor,
    t_min: float,
    t_max: float,
    eps: float,
    max_steps: int,
    min_step,
    coarse: bool = True,
):
    meta = sdf.meta
    res = sdf.resolution
    values = sdf.values
    o = origins
    v = directions

    # analytic ray/AABB intersection in the grid frame
    og = meta.world_to_grid(o)
    vg = rotate_points(meta.inv_origin_transform[:3, :3], v)
    sizes = meta.sizes.to(og.dtype)
    safe_v = torch.where(vg.abs() > 1e-12, vg, 1e-12)
    t_a = (0.0 - og) / safe_v
    t_b = (sizes - og) / safe_v
    t_entry = torch.minimum(t_a, t_b).amax(dim=-1)
    t_exit = torch.maximum(t_a, t_b).amin(dim=-1)
    # a ray with a non-finite origin or direction misses (each of its
    # positions would be out of bounds); finite rays keep finite positions
    finite = torch.isfinite(og).all(dim=-1) & torch.isfinite(vg).all(dim=-1)
    misses_box = (t_entry > t_exit) | (t_exit < t_min) | ~finite

    # no less than half a cell per step; bisection repairs the overshoot
    ms = res * 0.5 if min_step is None else torch.as_tensor(min_step, dtype=o.dtype, device=o.device)

    def dist_at(t):
        return query.estimate_distance(sdf, o + t[..., None] * v)

    t0 = torch.maximum(torch.full_like(t_entry, t_min), t_entry)
    steps_used = torch.zeros(t0.shape, dtype=torch.int32, device=t0.device)

    # ---- coarse empty-space skipping on a min-pooled lower bound --------
    # (``coarse=False`` skips it: the plane sweep's resume march traces a
    # few hundred rays, for which pooling the whole field does not pay)
    factor = 8
    coarse_steps = max(8, max_steps // 8)
    if coarse and min(meta.shape) >= 4 * factor:
        coarse_v = coarse_min_pool(values, factor) - res * 0.87
        c_shape = coarse_v.shape
        coarse_flat = coarse_v.reshape(-1)
        inv_c = 1.0 / (res * factor)

        def coarse_at(t):
            g = meta.world_to_grid(o + t[..., None] * v)
            flat, ok = _flat_index(floor_to_int32(g * inv_c), c_shape)
            return torch.where(ok, coarse_flat[flat], res * factor)

        switch = 2.0 * res  # hand off to the fine march below this
        t = t0
        alive = ~misses_box
        for _ in range(coarse_steps):
            dc = coarse_at(t)
            can_skip = dc > switch
            step = torch.maximum(dc, res)
            t_new = torch.where(alive & can_skip, t + step, t)
            steps_used = steps_used + (alive & can_skip).to(torch.int32)
            out = (t_new > t_max) | (t_new > t_exit + res)
            alive = alive & can_skip & ~out
            t = t_new
        t0 = t

    # ---- nearest-neighbour march: one gather per step -------------------
    values_flat = values.reshape(-1)
    inv_res = 1.0 / res
    nn_slack = res * 0.87

    def nn_dist(t):
        g = meta.world_to_grid(o + t[..., None] * v)
        flat, ok = _flat_index(floor_to_int32(g * inv_res), meta.shape)
        return torch.where(ok, values_flat[flat], res), ok

    rounds = 3
    nn_steps = max(4, max_steps // rounds)
    tri_steps = 6

    t, t_prev = t0, t0
    in_box = ~misses_box
    hit = torch.zeros_like(in_box)
    for _ in range(rounds):
        # NN phase: skip open space, stop when near the surface
        near = torch.zeros_like(in_box)
        for _ in range(nn_steps):
            dnn, ok = nn_dist(t)
            near_now = ok & (dnn < 2.0 * res)
            advance = in_box & ~hit & ~near & ~near_now
            steps_used = steps_used + advance.to(torch.int32)
            step = torch.maximum(dnn - nn_slack, ms)
            t_new = torch.where(advance, t + step, t)
            t_prev = torch.where(advance, t, t_prev)
            in_box = in_box & ~((t_new > t_max) | (t_new > t_exit + res))
            near = near | (in_box & ~hit & near_now)
            t = t_new

        # trilinear phase: cross the surface and record the hit bracket
        d, _ = dist_at(t)
        for _ in range(tri_steps):
            advance = near & in_box & ~hit & (d >= eps)
            steps_used = steps_used + advance.to(torch.int32)
            step = torch.maximum(d, ms)
            t_new = torch.where(advance, t + step, t)
            t_prev = torch.where(advance, t, t_prev)
            d_new, _ = dist_at(t_new)
            in_box = in_box & ~((t_new > t_max) | (t_new > t_exit + res))
            d = torch.where(advance, d_new, d)
            t = t_new
        hit = hit | (near & in_box & (d < eps))

    d_final, ok_final = dist_at(t)
    hit = hit & ok_final & (d_final < eps) & (t <= t_max) & ~misses_box

    # bisection refinement: the crossing lies in [t_prev, t] for hit rays
    lo, hi = t_prev, t
    for _ in range(6):
        mid = 0.5 * (lo + hi)
        d_mid, _ = dist_at(mid)
        outside = d_mid > 0.0
        lo = torch.where(outside, mid, lo)
        hi = torch.where(outside, hi, mid)
    t_refined = torch.where(hit, hi, t)

    depth = torch.where(hit, t_refined, t_max)
    return depth, hit, steps_used


def ift_backward(sdf: SdfGrid, origins, directions, depth, hit, g_depth):
    """(d values, d origins, d directions) of a depth cotangent by the
    implicit function theorem at the hit surface: with F(t, values, o, v) =
    d(o + t v; values) = eps, dt/dx = -(dF/dx) / (dF/dt). One trilinear
    stencil at the hit points gives dF/dvalues (its 8 corner weights, one
    8-corner ``index_add_``) and the surface normal; near-tangent rays are
    guarded as in the JAX package, and missed rays get zero gradient."""
    meta = sdf.meta
    hit_pts = origins + depth[..., None] * directions
    idx8, w8, _, grad_grid, in_bounds = query.interpolation_stencil(sdf, hit_pts)
    n = rotate_points(meta.origin_transform[:3, :3], grad_grid)  # world frame
    dF_dt = (n * directions).sum(dim=-1)
    safe = torch.where(dF_dt.abs() > 1e-6, dF_dt, torch.where(dF_dt >= 0, 1e-6, -1e-6))
    scale = torch.where(hit & in_bounds, -g_depth / safe, 0.0)
    values = sdf.values
    d_values = torch.zeros(values.numel(), dtype=values.dtype, device=values.device)
    d_values.index_add_(0, idx8.reshape(-1), (w8 * scale[..., None]).reshape(-1))
    sn = scale[..., None] * n
    return d_values.reshape(values.shape), sn, sn * depth[..., None]


def _resolve_backend(backend: str, shape, origins: torch.Tensor, device_type: str | None = None) -> str:
    """``"auto"`` -> ``"plane"`` for rays on a CUDA device, a grid the sweep
    supports and an image-shaped bundle of at least 4 rows of 128 rays (the
    8x16 tile regrouping needs a 2-D batch; a flat list has no coherence
    and would churn through the fallback), else ``"march"``: the JAX
    package's rule, with its TPU-class backend read as CUDA.
    ``device_type`` defaults to the origins' device type."""
    if backend != "auto":
        return backend
    device_type = origins.device.type if device_type is None else device_type
    if (
        device_type == "cuda"
        and render_plane.plane_sweep_supported(shape)
        and origins.dim() >= 3
        and origins.numel() // 3 >= 4 * render_plane.LANES
    ):
        return "plane"
    return "march"


class _SphereTraceDepth(torch.autograd.Function):
    """(depth, hit, steps) of the march or the plane sweep (``backend``,
    resolved); gradients w.r.t. the field values, the ray origins and the
    ray directions through ``ift_backward`` for both (none through the hit
    mask or the step counts)."""

    @staticmethod
    def forward(ctx, values, origins, directions, sdf, t_min, t_max, eps, max_steps, min_step, backend):
        grid = SdfGrid(values, sdf.meta, sdf.oob_value)
        if backend == "plane":
            depth, hit, steps = render_plane.plane_sweep_depth(
                grid, origins, directions, t_min, t_max, eps, max_steps, min_step
            )
        else:
            depth, hit, steps = _trace_depth(grid, origins, directions, t_min, t_max, eps, max_steps, min_step)
        ctx.save_for_backward(values, origins, directions, depth, hit)
        ctx.grid = (sdf.meta, sdf.oob_value)
        ctx.mark_non_differentiable(hit, steps)
        return depth, hit, steps

    @staticmethod
    def backward(ctx, g_depth, _g_hit, _g_steps):
        values, origins, directions, depth, hit = ctx.saved_tensors
        grid = SdfGrid(values, *ctx.grid)
        d_values, d_origins, d_directions = ift_backward(grid, origins, directions, depth, hit, g_depth)
        return d_values, d_origins, d_directions, None, None, None, None, None, None, None


def render_depth(
    sdf: SdfGrid,
    origins: torch.Tensor,
    directions: torch.Tensor,
    t_min: float = 0.0,
    t_max: float = 10.0,
    eps: float = 1e-3,
    max_steps: int = 96,
    min_step: float | None = None,
    backend: str = "auto",
) -> RenderResult:
    """Sphere-trace depth for rays (origins, directions) [..., 3].

    Differentiable w.r.t. ``sdf.values``, ``origins`` and ``directions`` by
    the implicit function theorem (missed rays get zero gradient).
    ``backend``: ``"march"`` the exact march; ``"plane"`` the plane sweep
    (kernel K8 on a CUDA tensor, its plain version on the CPU) with the
    march for the rows it cannot take; ``"auto"`` the plane sweep for CUDA
    rays on supported grids and image-shaped bundles, else the march
    (``_resolve_backend``). Both share the hit semantics and the backward."""
    if backend not in ("auto", "march", "plane"):
        raise ValueError(f"unknown render backend {backend!r}")
    resolved = _resolve_backend(backend, sdf.meta.shape, origins)
    depth, hit, steps = _SphereTraceDepth.apply(
        sdf.values, origins, directions, sdf, t_min, t_max, eps, max_steps, min_step, resolved
    )
    return RenderResult(depth=depth, hit=hit, steps=steps)


def camera_rays(
    camera_pos, look_at, up, fov_deg: float, height: int, width: int, *, device
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pinhole camera ray bundle: (origins [h,w,3], directions [h,w,3]) f32."""
    pos = torch.as_tensor(camera_pos, dtype=torch.float32, device=device)
    fwd = torch.as_tensor(look_at, dtype=torch.float32, device=device) - pos
    fwd = fwd / torch.linalg.norm(fwd)
    upv = torch.as_tensor(up, dtype=torch.float32, device=device)
    right = torch.linalg.cross(fwd, upv)
    right = right / torch.linalg.norm(right)
    true_up = torch.linalg.cross(right, fwd)
    aspect = width / height
    fov = torch.tensor(fov_deg, dtype=torch.float32, device=device)
    tan_half = torch.tan(torch.deg2rad(fov) / 2.0)
    ys = torch.linspace(1.0, -1.0, height, dtype=torch.float32, device=device) * tan_half
    xs = torch.linspace(-1.0, 1.0, width, dtype=torch.float32, device=device) * tan_half * aspect
    dirs = (
        fwd[None, None, :]
        + xs[None, :, None] * right[None, None, :]
        + ys[:, None, None] * true_up[None, None, :]
    )
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    origins = pos.expand(dirs.shape)
    return origins, dirs
