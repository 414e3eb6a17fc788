"""The port's query and render pieces against the JAX package, on the CPU.

Tolerances: voxelization, corner indices, in-bounds masks and the coarse
min-pool bitwise; interpolated values and weights within rtol=atol=1e-6;
point gradients within rtol=atol=1e-5; camera rays within atol=1e-6; the
march within the bound the JAX package holds two of its own march runs to
(tests/test_render.py, jit vs eager): hit masks agree on >= 99.5% of rays
and depths on common hits within 2e-3, on the rays whose first coarse
lookup in the JAX march is inside its coarse grid (``_jax_entry_fault``:
on the others JAX takes a free step of 8 cells at the entry, which the
port does not; ``test_march_entry_against_dense_crossing`` holds both
marches there to the first crossing found by dense sampling). The
render backward (IFT) against
``jax.grad`` of the eager JAX march: d values, d origins and d directions
within rtol=1e-5, atol=1e-5 * max|grad|; the float ops are the JAX
package's, and the two scatter-adds sum each cell's eight-corner
contributions in the same ray order on the CPU.
"""
import ctypes
import re
import subprocess
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax import lax
import torch

from bench import make_scene
from sdf_tools_tpu.grid import GridMeta as JaxGridMeta, SdfGrid as JaxSdfGrid, make_origin_transform as jax_origin
from sdf_tools_tpu.ops import edt as jedt, query as jquery, render as jrender, voxelize as jvoxelize
from sdf_tools_tpu_torch import _build, convert
from sdf_tools_tpu_torch.grid import flat_cell_index
from sdf_tools_tpu_torch.ops import query, render, voxelize

N = 64
RES = 0.05
HIT_AGREE_MIN = 0.995
DEPTH_ATOL = 2e-3


def _rotation(angle_deg, axis):
    a = np.deg2rad(angle_deg)
    c, s = np.cos(a), np.sin(a)
    i, j = [k for k in range(3) if k != axis]
    r = np.eye(3)
    r[i, i], r[i, j], r[j, i], r[j, j] = c, -s, s, c
    return r


def _port_meta(jmeta):
    return convert.grid_meta_from_numpy(
        np.asarray(jmeta.origin_transform), np.asarray(jmeta.inv_origin_transform),
        np.asarray(jmeta.resolution), jmeta.shape, jmeta.frame, device="cpu",
    )


@pytest.fixture(scope="module")
def scene():
    """make_scene(64) as a JAX SdfGrid (pallas backend) and the port's copy,
    under a rotated, translated origin."""
    mask = make_scene(N)
    origin = jax_origin([0.3, -0.2, 0.1], _rotation(20.0, 2) @ _rotation(-10.0, 0))
    jmeta = JaxGridMeta.create(origin, RES, mask.shape)
    jsdf, _ = jedt.extract_signed_distance_field(jnp.asarray(mask), jmeta, oob_value=1e3, backend="pallas")
    sdf = convert.sdf_grid_from_numpy(np.asarray(jsdf.values), _port_meta(jmeta), 1e3)
    return jsdf, sdf


def _grid_points(jmeta, n, margin, seed):
    """World points of a uniform grid-frame cloud, ``margin`` cells beyond the grid."""
    rng = np.random.default_rng(seed)
    ext = np.asarray(jmeta.shape) * RES
    g = rng.uniform(-margin * RES, ext + margin * RES, (n, 3)).astype(np.float32)
    return np.asarray(jmeta.grid_to_world(jnp.asarray(g)))


def test_voxelize_points_in_bounds_bitwise(scene):
    jsdf, sdf = scene
    pts = _grid_points(jsdf.meta, 3000, margin=-0.5, seed=1)  # strictly inside
    want = np.asarray(jvoxelize.voxelize_points(jnp.asarray(pts), jsdf.meta))
    got = voxelize.voxelize_points(torch.tensor(pts), sdf.meta).numpy()
    np.testing.assert_array_equal(_u32(got), _u32(want))


def test_voxelize_points_drops_out_of_bounds(scene):
    """With out-of-bounds points in the input the port drops them. The JAX
    package's ``mode="drop"`` scatter turns their flat index -1 into the
    last cell first, so it also fills cell [-1, -1, -1]: everywhere else the
    two agree bitwise."""
    jsdf, sdf = scene
    pts = _grid_points(jsdf.meta, 3000, margin=8, seed=2)
    idx = np.asarray(jsdf.meta.location_to_index(jnp.asarray(pts)))
    inside = np.all((idx >= 0) & (idx < N), axis=-1)
    assert 0 < inside.sum() < len(pts)
    want = np.array(jvoxelize.voxelize_points(jnp.asarray(pts), jsdf.meta))
    got = voxelize.voxelize_points(torch.tensor(pts), sdf.meta).numpy()
    in_last = np.all(idx[inside] == N - 1, axis=-1).any()
    assert want[-1, -1, -1] == 1.0 and got[-1, -1, -1] == float(in_last)
    want[-1, -1, -1] = got[-1, -1, -1]
    np.testing.assert_array_equal(_u32(got), _u32(want))
    inside_only = voxelize.voxelize_points(torch.tensor(pts[inside]), sdf.meta).numpy()
    np.testing.assert_array_equal(_u32(inside_only), _u32(got))


def _u32(x):
    return np.ascontiguousarray(x).view(np.uint32)


def test_interpolation_stencil_matches_jax(scene):
    jsdf, sdf = scene
    pts = _grid_points(jsdf.meta, 10_000, margin=3, seed=3)  # some out of bounds
    j_idx, j_w, j_val, j_grad, j_ok = jquery.interpolation_stencil(jsdf, jnp.asarray(pts))
    idx, w, val, grad, ok = query.interpolation_stencil(sdf, torch.tensor(pts))
    assert 0 < ok.sum() < len(pts)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(j_ok))
    np.testing.assert_allclose(w.numpy(), np.asarray(j_w), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(val.numpy(), np.asarray(j_val), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(grad.numpy(), np.asarray(j_grad), rtol=1e-6, atol=1e-6)


def test_estimate_distance_matches_jax(scene):
    jsdf, sdf = scene
    pts = _grid_points(jsdf.meta, 10_000, margin=3, seed=4)
    j_d, j_ok = jquery.estimate_distance(jsdf, jnp.asarray(pts))
    d, ok = query.estimate_distance(sdf, torch.tensor(pts))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(j_ok))
    assert (d.numpy()[~ok.numpy()] == 1e3).all()
    np.testing.assert_allclose(d.numpy(), np.asarray(j_d), rtol=1e-6, atol=1e-6)


def test_autodiff_gradient_matches_jax(scene):
    jsdf, sdf = scene
    pts = _grid_points(jsdf.meta, 2000, margin=2, seed=5)
    want = np.asarray(jquery.autodiff_gradient(jsdf, jnp.asarray(pts)))
    got = query.autodiff_gradient(sdf, torch.tensor(pts)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", [(64, 64, 64), (40, 33, 57), (9, 8, 17)])
def test_coarse_min_pool_matches_reduce_window(shape):
    v = np.random.default_rng(sum(shape)).normal(size=shape).astype(np.float32)
    # the JAX march's separable pool (sdf_tools_tpu/ops/render.py:109-119)
    pooled = jnp.asarray(v)
    for ax in range(3):
        win, stride, pad = [1, 1, 1], [1, 1, 1], [(0, 0)] * 3
        win[ax], stride[ax], pad[ax] = 10, 8, (1, 9)
        pooled = lax.reduce_window(pooled, jnp.inf, lax.min, tuple(win), tuple(stride), pad)
    got = render.coarse_min_pool(torch.tensor(v), 8).numpy()
    assert got.shape == tuple(s // 8 + 1 for s in shape)
    np.testing.assert_array_equal(_u32(got), _u32(pooled))


def _bench_camera(n):
    center = np.full(3, 0.5 * n * RES)
    return center + np.array([-1.2 * n * RES, 0.0, 0.4 * n * RES]), center


@pytest.mark.parametrize("hw", [(64, 64), (24, 40)])
def test_camera_rays_match_jax(hw):
    cam, center = _bench_camera(N)
    jo, jd = jrender.camera_rays(
        jnp.asarray(cam, jnp.float32), jnp.asarray(center, jnp.float32), jnp.asarray([0.0, 0.0, 1.0]), 50.0, *hw
    )
    o, d = render.camera_rays(cam, center, (0.0, 0.0, 1.0), 50.0, *hw, device="cpu")
    assert o.shape == d.shape == (*hw, 3)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=1e-6, rtol=0)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), atol=1e-6, rtol=0)


def assert_march_agrees(hit, depth, j_hit, j_depth):
    """Hit masks agree on >= 99.5% of rays (flipped rays listed on failure);
    common-hit depths within 2e-3."""
    flipped = np.argwhere(hit != j_hit)
    agree = 1.0 - len(flipped) / hit.size
    assert agree >= HIT_AGREE_MIN, (
        f"hit agreement {agree:.4f}; flipped rays (index, port hit/depth, jax hit/depth): "
        + "; ".join(f"{tuple(i)} {hit[tuple(i)]}/{depth[tuple(i)]:.4f} {j_hit[tuple(i)]}/{j_depth[tuple(i)]:.4f}" for i in flipped)
    )
    both = hit & j_hit
    assert both.any()
    np.testing.assert_allclose(depth[both], j_depth[both], atol=DEPTH_ATOL, rtol=0)


def _bench_rays(jsdf, h, w):
    """JAX camera rays from bench.py's camera in the scene's rotated frame."""
    cam, center = _bench_camera(N)
    cam = np.asarray(jsdf.meta.grid_to_world(jnp.asarray(cam, jnp.float32)))
    center = np.asarray(jsdf.meta.grid_to_world(jnp.asarray(center, jnp.float32)))
    up = np.asarray(jsdf.meta.origin_transform)[:3, 2]
    return jrender.camera_rays(jnp.asarray(cam), jnp.asarray(center), jnp.asarray(up), 50.0, h, w)


def _jax_entry_fault(jsdf, o, v, t_min=0.0, factor=8):
    """[...] bool: rays whose first coarse lookup in the JAX march falls
    outside its coarse grid (its ops, run eagerly:
    sdf_tools_tpu/ops/render.py:60-70 and ``coarse_at``). The ray's entry
    point rounds just outside the box, and the lookup returns a free step
    of ``factor`` cells, past any surface that near the entry face
    (ROADMAP.md C); the port's march reads the entry block there."""
    from sdf_tools_tpu.grid import rotate_points as jrotate

    m = jsdf.meta
    o, v = jnp.asarray(o), jnp.asarray(v)
    og = m.world_to_grid(o)
    vg = jrotate(m.inv_origin_transform[:3, :3], v)
    safe_v = jnp.where(jnp.abs(vg) > 1e-12, vg, 1e-12)
    t_a = (0.0 - og) / safe_v
    t_b = (m.sizes.astype(og.dtype) - og) / safe_v
    t_entry = jnp.max(jnp.minimum(t_a, t_b), axis=-1)
    t_exit = jnp.min(jnp.maximum(t_a, t_b), axis=-1)
    t0 = jnp.maximum(jnp.full(o.shape[:-1], t_min, o.dtype), t_entry)
    ci = jnp.floor(m.world_to_grid(o + t0[..., None] * v) * (1.0 / (jsdf.resolution * factor))).astype(jnp.int32)
    inside = jnp.all((ci >= 0) & (ci < jnp.asarray([s // factor + 1 for s in m.shape])), axis=-1)
    return np.asarray(~inside & (t_entry <= t_exit) & (t_exit >= t_min))


def test_march_matches_jax(scene):
    """make_scene(64), 64x64 rays from bench.py's camera, max_steps=64;
    compared where the JAX march's entry lookup is inside its grid."""
    jsdf, sdf = scene
    jo, jd = _bench_rays(jsdf, 64, 64)
    kw = dict(t_max=4.0 * N * RES, max_steps=64)
    jr = jrender.render_depth(jsdf, jo, jd, backend="march", **kw)
    r = render.render_depth(sdf, torch.tensor(np.asarray(jo)), torch.tensor(np.asarray(jd)), backend="march", **kw)
    hit, depth = r.hit.numpy(), r.depth.numpy()
    assert r.steps.dtype == torch.int32 and 0.05 < hit.mean() < 0.95
    clean = ~_jax_entry_fault(jsdf, jo, jd)
    assert clean.mean() > 0.5
    assert_march_agrees(hit[clean], depth[clean], np.asarray(jr.hit)[clean], np.asarray(jr.depth)[clean])
    assert (depth[~hit] == np.float32(kw["t_max"])).all()


def test_march_entry_against_dense_crossing(scene):
    """On the rays where the JAX march's entry lookup falls outside its
    coarse grid, the first crossing (estimate_distance < eps) found by
    sampling every res/16 along the ray: the port's march hits as it does
    on the other rays (hit masks agree on >= 99% of rays, common hits within
    res/2 of it), the JAX march steps past surfaces near the entry face
    (over 100 common hits beyond res/2, the hit masks agree on fewer). On
    the other rays both marches hold the same bars."""
    jsdf, sdf = scene
    jo, jd = _bench_rays(jsdf, 64, 64)
    kw = dict(t_max=4.0 * N * RES, max_steps=64)
    fault = _jax_entry_fault(jsdf, jo, jd).reshape(-1)
    jr = jrender.render_depth(jsdf, jo, jd, backend="march", **kw)
    o, d = torch.tensor(np.asarray(jo)).reshape(-1, 3), torch.tensor(np.asarray(jd)).reshape(-1, 3)
    r = render.render_depth(sdf, o, d, backend="march", **kw)
    ts = torch.arange(0.0, kw["t_max"], RES / 16)
    first = torch.full((o.shape[0],), float("inf"))
    for k in range(0, len(ts), 256):
        tt = ts[k : k + 256]
        dist, ok = query.estimate_distance(sdf, (o[:, None, :] + tt[None, :, None] * d[:, None, :]).reshape(-1, 3))
        below = (ok & (dist < 1e-3)).reshape(o.shape[0], -1)
        at = torch.where(below.any(1), tt[below.to(torch.int8).argmax(1)], float("inf"))
        first = torch.minimum(first, at)
    first = first.numpy()
    dense = np.isfinite(first)
    counts = {}
    for name, hit, depth in (("port", r.hit.numpy(), r.depth.numpy()),
                             ("jax", np.asarray(jr.hit).reshape(-1), np.asarray(jr.depth).reshape(-1))):
        for part, sel in (("fault", fault), ("clean", ~fault)):
            both = hit & dense & sel
            counts[name, part] = ((hit == dense)[sel].mean(), int((np.abs(depth - first)[both] > 0.5 * RES).sum()))
    assert fault.sum() > 1000, counts
    assert counts["port", "fault"][0] >= 0.99 and counts["port", "fault"][1] == 0, counts
    assert counts["jax", "fault"][1] > 100 and counts["jax", "fault"][0] < counts["port", "fault"][0], counts
    assert counts["port", "clean"] == counts["jax", "clean"] and counts["port", "clean"][0] >= 0.99, counts


def test_render_depth_guards(scene):
    """An explicit plane backend runs on the CPU and returns the
    RenderResult shapes on a grid it supports, and raises on one it does
    not (as the JAX package does); an unknown backend raises; inputs that
    require grad get a gradient (rays through the grid's middle hit)."""
    jsdf, sdf = scene
    o = torch.zeros((4, 3))
    d = torch.tensor([[1.0, 0.0, 0.0]]).expand(4, 3)
    with pytest.raises(ValueError, match="too small"):
        render.render_depth(sdf, o, d, backend="plane")
    # free space up to a wall at x = 1.0 in a (32, 64, 256) grid, a
    # layout whose axis 0 fits the plane sweep's band
    wall_x = 1.0 - (np.arange(32, dtype=np.float32) + 0.5) * RES
    wall = np.broadcast_to(wall_x[:, None, None], (32, 64, 256))
    eye = np.eye(4, dtype=np.float32)
    wall_sdf = convert.sdf_grid_from_numpy(wall, convert.grid_meta_from_numpy(eye, eye, RES, wall.shape, device="cpu"), 1e3)
    for shape in ((4,), (8, 16)):
        start = torch.tensor([0.2, 1.6, 6.4]).expand(*shape, 3)
        r = render.render_depth(wall_sdf, start, torch.tensor([1.0, 0.0, 0.0]).expand(*shape, 3), t_max=5.0, backend="plane")
        assert isinstance(r, render.RenderResult) and r.depth.shape == r.hit.shape == r.steps.shape == shape
        assert r.hit.all() and torch.allclose(r.depth, torch.tensor(0.8), atol=RES)
    with pytest.raises(ValueError):
        render.render_depth(sdf, o, d, backend="bogus")
    jo, jd = _bench_rays(jsdf, 8, 8)
    o = torch.tensor(np.asarray(jo), requires_grad=True)
    d = torch.tensor(np.asarray(jd), requires_grad=True)
    values = sdf.values.clone().requires_grad_(True)
    out = render.render_depth(type(sdf)(values, sdf.meta, sdf.oob_value), o, d, t_max=4.0 * N * RES, backend="auto")
    assert out.depth.shape == out.hit.shape == out.steps.shape == (8, 8)
    assert out.hit.any() and out.depth.requires_grad and not out.hit.requires_grad
    (out.depth**2).sum().backward()
    for x in (values, o, d):
        assert x.grad is not None and torch.isfinite(x.grad).all() and (x.grad != 0).any()


def _grad_close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


@pytest.fixture(scope="module")
def render_grads(scene):
    """make_scene(64), the 64x64 rays from bench.py's camera where the JAX
    march's entry lookup is inside its grid (about 2,600): jax.grad of
    sum(depth^2) w.r.t. (values, origins, directions), the JAX march run
    eagerly, and the JAX forward's depth and hit."""
    jsdf, _ = scene
    jo, jd = _bench_rays(jsdf, 64, 64)
    clean = ~_jax_entry_fault(jsdf, jo, jd)  # the rays where the two marches agree
    jo = jnp.asarray(np.array(jo)[clean])  # a full array, not a broadcast
    jd = jnp.asarray(np.asarray(jd)[clean])
    kw = dict(t_max=4.0 * N * RES, max_steps=64)

    def loss(values, o, d):
        s = JaxSdfGrid(values=values, meta=jsdf.meta, oob_value=jsdf.oob_value)
        return jnp.sum(jrender.render_depth(s, o, d, backend="march", **kw).depth ** 2)

    with jax.disable_jit():
        jr = jrender.render_depth(jsdf, jo, jd, backend="march", **kw)
        grads = jax.grad(loss, argnums=(0, 1, 2))(jsdf.values, jo, jd)
    return (np.asarray(jo), np.asarray(jd)), kw, jr, [np.asarray(g) for g in grads]


def test_render_backward_matches_jax(scene, render_grads):
    _, sdf = scene
    (o_np, d_np), kw, jr, want = render_grads
    values = sdf.values.clone().requires_grad_(True)
    o = torch.tensor(o_np, requires_grad=True)
    d = torch.tensor(d_np, requires_grad=True)
    r = render.render_depth(type(sdf)(values, sdf.meta, sdf.oob_value), o, d, backend="march", **kw)
    np.testing.assert_array_equal(r.hit.numpy(), np.asarray(jr.hit))
    (r.depth**2).sum().backward()
    assert 0.05 < r.hit.float().mean() < 0.95 and (want[0] != 0).sum() > 1000
    for got, w in zip((values.grad, o.grad, d.grad), want):
        _grad_close(got.numpy(), w)


def test_ift_backward_given_jax_forward(scene, render_grads):
    """The port's IFT backward fed the JAX forward's depth and hit, so that
    no hit flip between the two marches can hide an error."""
    _, sdf = scene
    (o_np, d_np), _, jr, want = render_grads
    depth = torch.tensor(np.asarray(jr.depth))
    got = render.ift_backward(
        sdf, torch.tensor(o_np), torch.tensor(d_np), depth, torch.tensor(np.asarray(jr.hit)), 2.0 * depth
    )
    for g, w in zip(got, want):
        _grad_close(g.numpy(), w)


def test_flat_indices_are_int64_past_2_31_cells():
    """The march's ``_flat_index`` and the stencil's corner index math on a
    grid of 2^32 cells (no field needed): every index is non-negative and
    equals numpy's int64 flat index, where int32 products would wrap."""
    shape = (2048, 2048, 1024)
    cells = np.array([[0, 0, 0], [2047, 2047, 1023], [1024, 0, 0], [2047, 0, 5], [1500, 2000, 1000],
                      [-3, 2050, 1024], [2048, -1, 7]])
    clamped = np.clip(cells, 0, np.array(shape) - 1)
    want = np.ravel_multi_index(clamped.T, shape).astype(np.int64)
    assert (want > 2**31 - 1).any()
    c32 = clamped.astype(np.int32)
    wrapped = (c32[:, 0] * np.int32(shape[1]) + c32[:, 1]) * np.int32(shape[2]) + c32[:, 2]
    assert (wrapped < 0).any()  # what the int32 products gave
    flat, ok = render._flat_index(torch.tensor(cells, dtype=torch.int32), shape)
    assert flat.dtype == torch.int64 and (flat >= 0).all()
    np.testing.assert_array_equal(flat.numpy(), want)
    np.testing.assert_array_equal(ok.numpy(), ((cells >= 0) & (cells < np.array(shape))).all(-1))
    c = torch.tensor(clamped, dtype=torch.int32)
    corner = flat_cell_index(c[:, 0], c[:, 1], c[:, 2], shape)
    assert corner.dtype == torch.int64 and (corner >= 0).all()
    np.testing.assert_array_equal(corner.numpy(), want)


def test_sphere_trace_depth_is_render_depth(scene):
    """The named march: bitwise the outputs of ``render_depth``, which calls
    it; an unknown backend raises."""
    jsdf, sdf = scene
    jo, jd = _bench_rays(jsdf, 16, 16)
    o, d = torch.tensor(np.asarray(jo)), torch.tensor(np.asarray(jd))
    for backend in ("march", "auto"):
        r = render.render_depth(sdf, o, d, t_max=4.0 * N * RES, max_steps=48, backend=backend)
        got = render.sphere_trace_depth(sdf.values, (sdf.meta, 1e3), o, d, 0.0, 4.0 * N * RES, 1e-3, 48, None, backend)
        for a, b in zip(got, r):
            assert torch.equal(a, b)
    with pytest.raises(ValueError):
        render.sphere_trace_depth(sdf.values, (sdf.meta, 1e3), o, d, 0.0, 1.0, 1e-3, 8, None, "bogus")


def test_sphere_trace_depth_vjp_matches_jax(scene):
    """Forward and ``jax.vjp`` of the JAX package's ``sphere_trace_depth``
    (run eagerly) against the port's and its autograd, with the same
    depth cotangent: the march bars and ``_grad_close``, on the 32x32
    camera's rays where the JAX march's entry lookup is inside its grid."""
    jsdf, sdf = scene
    jo, jd = _bench_rays(jsdf, 32, 32)
    clean = ~_jax_entry_fault(jsdf, jo, jd)  # the rays where the two marches agree
    jo, jd = jnp.asarray(np.array(jo)[clean]), jnp.asarray(np.asarray(jd)[clean])
    args = (0.0, 4.0 * N * RES, 1e-3, 64, None, "march")
    cot = np.random.default_rng(2).standard_normal(jo.shape[:-1]).astype(np.float32)
    with jax.disable_jit():
        (jdepth, jhit, _), vjp = jax.vjp(
            lambda v, o, d: jrender.sphere_trace_depth(v, (jsdf.meta, jsdf.oob_value), o, d, *args),
            jsdf.values, jo, jd,
        )
        want = vjp((jnp.asarray(cot), np.zeros(jhit.shape, jax.dtypes.float0), jnp.zeros(jhit.shape, jnp.int32)))
    values = sdf.values.clone().requires_grad_(True)
    o = torch.tensor(np.asarray(jo), requires_grad=True)
    d = torch.tensor(np.asarray(jd), requires_grad=True)
    depth, hit, steps = render.sphere_trace_depth(values, (sdf.meta, sdf.oob_value), o, d, *args)
    assert_march_agrees(hit.numpy(), depth.detach().numpy(), np.asarray(jhit), np.asarray(jdepth))
    np.testing.assert_array_equal(hit.numpy(), np.asarray(jhit))
    depth.backward(torch.tensor(cot))
    for got, w in zip((values.grad, o.grad, d.grad), want):
        _grad_close(got.numpy(), np.asarray(w))


# ---- the march's kernel (csrc/render_march.cu) -------------------------------
# The CUDA kernel runs only on a card (chip_smoke.py phase 16 holds it to
# _march there, bitwise). Here: its C declaration against the ctypes
# signature, the dispatch and the wrapper's refusals, and the kernel's own
# source built for the host (g++, without __CUDACC__: the same per-ray code
# looped over the rays, the read-only loads plain reads) against _march,
# bitwise, through the dispatch's own input preparation.

MARCH_SRC = Path(render.__file__).resolve().parents[1] / "csrc" / "render_march.cu"


def _c_params(src: str, fn: str):
    """The parameter types of ``extern "C" int <fn>(...)`` in ``src``, as
    ctypes types (pointers and the stream void pointers)."""
    head = re.search(r'extern "C" int ' + fn + r"\(([^)]*)\)", src)
    assert head, fn
    types = []
    for param in head.group(1).split(","):
        words = param.split()
        if "*" in param or words[0] == "cudaStream_t":
            types.append(ctypes.c_void_p)
        else:
            types.append({"int": ctypes.c_int, "float": ctypes.c_float}[words[0]])
    return types


def test_march_signature_matches_the_c_declaration():
    """``_build.SIGNATURES["sdf_march"]`` has the C entry point's arity and
    types; the host entry point takes the same but the stream; the launch
    counter exists."""
    src = MARCH_SRC.read_text()
    want = _build.SIGNATURES["sdf_march"]
    assert _c_params(src, "sdf_march") == want
    assert _c_params(src, "sdf_march_host") == want[:-1]
    assert "march" in _build.LAUNCHES


@pytest.fixture(scope="module")
def host_march(tmp_path_factory):
    """``march_kernel``'s contract over the host build of
    ``csrc/render_march.cu`` (``sdf_march_host``), for CPU tensors."""
    lib_path = tmp_path_factory.mktemp("march") / "libmarch_host.so"
    subprocess.run(["g++", "-x", "c++", "-std=c++17", "-O2", "-ffp-contract=off", "-fPIC", "-shared", "-o",
                    str(lib_path), str(MARCH_SRC)], check=True)
    fn = ctypes.CDLL(str(lib_path)).sdf_march_host
    fn.argtypes = _build.SIGNATURES["sdf_march"][:-1]
    fn.restype = ctypes.c_int

    def march_kernel(values, pooled, inv_transform, oob, min_step, origins, directions, res, t_min, t_max, eps,
                     max_steps):
        n = origins.shape[0]
        depth, hit, steps = torch.empty(n), torch.empty(n, dtype=torch.bool), torch.empty(n, dtype=torch.int32)
        assert fn(*render._c_args(values, pooled, inv_transform, oob, min_step, origins, directions, res, t_min,
                                  t_max, eps, max_steps, depth, hit, steps)) == 0
        return depth, hit, steps

    return march_kernel


def _march_fields(scene):
    """name -> SdfGrid: the rotated make_scene(64), a random field too thin
    for the coarse skip (at a resolution where g * (1 / res) and g / res
    floor differently on cell faces), a field one cell deep, and an empty
    one (+inf everywhere, oob +inf)."""
    _, sdf = scene
    rng = np.random.default_rng(26)
    eye = np.eye(4, dtype=np.float32)

    def grid(values, oob=1e3, res=RES):
        meta = convert.grid_meta_from_numpy(eye, eye, res, values.shape, device="cpu")
        return convert.sdf_grid_from_numpy(values, meta, oob)

    return {"scene": sdf,
            "thin": grid(rng.uniform(-0.1, 0.4, (20, 29, 33)).astype(np.float32), res=0.11),
            "flat": grid(rng.uniform(-0.1, 0.4, (40, 40, 1)).astype(np.float32)),
            "empty": grid(np.full((32, 32, 32), np.inf, np.float32), np.inf)}


def _march_rays(sdf):
    """(bench.py's camera at the grid, 24 x 32 with broadcast origins; 2,000
    random rays around and inside the grid, with non-finite origins and
    directions, axis-aligned directions, starts on the box's faces, and
    rays along x on the cell faces of y and z)."""
    res = sdf.meta.resolution_float
    ext = np.array(sdf.shape, np.float64) * res
    to_world = sdf.meta.grid_to_world
    center = to_world(torch.tensor(0.5 * ext, dtype=torch.float32))
    cam = to_world(torch.tensor(ext * np.array([-0.7, 0.5, 0.9]), dtype=torch.float32))
    up = sdf.meta.origin_transform[:3, 2]
    bundle = render.camera_rays(cam.numpy(), center.numpy(), up.numpy(), 50.0, 24, 32, device="cpu")
    rng = np.random.default_rng(27)
    o = to_world(torch.tensor(rng.uniform(-0.3, 1.3, (2000, 3)) * ext, dtype=torch.float32))
    v = torch.tensor(rng.standard_normal((2000, 3)), dtype=torch.float32)
    v = v / v.norm(dim=-1, keepdim=True)
    o[:6] = float("nan")
    v[6:12] = float("inf")
    v[12:40] = torch.tensor([1.0, 0.0, 0.0])
    v[40:60] = torch.tensor([0.0, -1.0, 0.0])
    o[60:80, 0] = 0.0
    faces = np.stack(np.meshgrid(np.arange(sdf.shape[1]), np.arange(sdf.shape[2]), indexing="ij"), -1).reshape(-1, 2)
    faces = faces[:: max(1, len(faces) // 400)].astype(np.float32) * np.float32(res)
    o_f = torch.tensor(np.concatenate([np.full((len(faces), 1), -0.5 * res, np.float32), faces], 1))
    v_f = torch.tensor([1.0, 0.0, 0.0]).expand(len(faces), 3)
    return bundle, (torch.cat([o, to_world(o_f)]), torch.cat([v, v_f]))


@pytest.mark.parametrize("field", ["scene", "thin", "flat", "empty"])
@pytest.mark.parametrize("coarse", [True, False])
@pytest.mark.parametrize("min_step", [None, 0.4 * RES])
def test_march_kernel_source_equals_march_bitwise(scene, host_march, monkeypatch, field, coarse, min_step):
    """The dispatch's kernel path (``_march_on_card``: rays broadcast and
    flattened, the pooled field, the min step) over the host build of the
    kernel returns ``_march``'s (depth, hit, steps) bit for bit, in its
    shapes and dtypes, with the coarse skip on and off, at 64 and 7 steps."""
    monkeypatch.setattr(render, "march_kernel", host_march)
    sdf = _march_fields(scene)[field]
    t_max = 4.0 * max(sdf.shape) * RES
    for o, v in _march_rays(sdf):
        for max_steps in (64, 7):
            args = (0.0, t_max, 1e-3, max_steps, min_step, coarse)
            got = render._march_on_card(sdf, o, v, *args)
            want = render._march(sdf, o, v, *args)
            for g, w in zip(got, want):
                assert g.shape == w.shape == o.shape[:-1] and g.dtype == w.dtype
                assert torch.equal(g.view(torch.int32) if g.dtype == torch.float32 else g,
                                   w.view(torch.int32) if w.dtype == torch.float32 else w)
    if field == "scene":
        assert 0.05 < float(want[1].float().mean()) < 0.95


@pytest.mark.parametrize("coarse", [True, False])
def test_trace_depth_on_the_cpu_is_march(scene, monkeypatch, coarse):
    """On CPU tensors ``_trace_depth`` runs ``_march``: its outputs, no
    kernel launch, the kernel path never entered; ``render_depth`` keeps its
    ``RenderResult`` shapes and dtypes."""
    _, sdf = scene
    (o, v), _ = _march_rays(sdf)

    def no_kernel(*args):
        raise AssertionError("the kernel path ran on CPU tensors")

    monkeypatch.setattr(render, "_march_on_card", no_kernel)
    before = dict(_build.LAUNCHES)
    args = (0.0, 4.0 * N * RES, 1e-3, 64, None, coarse)
    for g, w in zip(render._trace_depth(sdf, o, v, *args), render._march(sdf, o, v, *args)):
        assert torch.equal(g, w)
    r = render.render_depth(sdf, o, v, t_max=4.0 * N * RES, backend="march")
    assert isinstance(r, render.RenderResult) and r.depth.shape == r.hit.shape == r.steps.shape == o.shape[:-1]
    assert (r.depth.dtype, r.hit.dtype, r.steps.dtype) == (torch.float32, torch.bool, torch.int32)
    assert _build.LAUNCHES == before


def _march_kernel_inputs(scene):
    """``march_kernel``'s tensors for the bench camera's rays over the scene."""
    _, sdf = scene
    (o, v), _ = _march_rays(sdf)
    values = sdf.values.contiguous()
    return dict(values=values, pooled=render.coarse_min_pool(values, 8),
                inv_transform=sdf.meta.inv_origin_transform.contiguous(), oob=sdf.oob_value.reshape(()),
                min_step=torch.tensor(0.02), origins=o.reshape(-1, 3).contiguous(),
                directions=v.reshape(-1, 3).contiguous())


MARCH_REFUSED = {
    "cpu": ({}, "CUDA"),
    "origins float64": ({"origins": lambda x: x.double()}, "float32"),
    "values float16": ({"values": lambda x: x.half()}, "float32"),
    "min_step float64": ({"min_step": lambda x: x.double()}, "float32"),
    "directions strided": ({"directions": lambda x: x.t().contiguous().t()}, "contiguous"),
    "values strided": ({"values": lambda x: x.transpose(0, 2)}, "contiguous"),
    "directions shape": ({"directions": lambda x: x[:-1]}, "shape"),
    "origins [n, 4]": ({"origins": lambda x: torch.cat([x, x[:, :1]], 1),
                        "directions": lambda x: torch.cat([x, x[:, :1]], 1)}, r"\[n, 3\]"),
    "values 2-D": ({"values": lambda x: x[0].contiguous(), "pooled": lambda x: None}, r"\[nx, ny, nz\]"),
    "pooled shape": ({"pooled": lambda x: x[1:].contiguous()}, "shape"),
    "transform 3x3": ({"inv_transform": lambda x: x[:3, :3].contiguous()}, "shape"),
    "oob [1]": ({"oob": lambda x: x.reshape(1)}, "shape"),
}


@pytest.mark.parametrize("case", sorted(MARCH_REFUSED))
def test_march_kernel_refuses_without_launching(scene, monkeypatch, case):
    """``march_kernel`` raises on what it does not take (the device, each
    input's dtype, contiguity and shape), before it launches or loads the
    library."""
    edits, match = MARCH_REFUSED[case]
    inputs = _march_kernel_inputs(scene)
    for name, edit in edits.items():
        inputs[name] = edit(inputs[name])

    def no_launch(*args):
        raise AssertionError("launched")

    monkeypatch.setattr(_build, "launch", no_launch)
    monkeypatch.setattr(_build, "library", no_launch)
    before = dict(_build.LAUNCHES)
    with pytest.raises(ValueError, match=match):
        render.march_kernel(**inputs, res=RES, t_min=0.0, t_max=10.0, eps=1e-3, max_steps=64)
    assert _build.LAUNCHES == before
