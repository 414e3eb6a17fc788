"""The port's query and render pieces against the JAX package, on the CPU.

Tolerances: voxelization, corner indices, in-bounds masks and the coarse
min-pool bitwise; interpolated values and weights within rtol=atol=1e-6;
point gradients within rtol=atol=1e-5; camera rays within atol=1e-6; the
march within the bound the JAX package holds two of its own march runs to
(tests/test_render.py, jit vs eager): hit masks agree on >= 99.5% of rays
and depths on common hits within 2e-3. The render backward (IFT) against
``jax.grad`` of the eager JAX march: d values, d origins and d directions
within rtol=1e-5, atol=1e-5 * max|grad|; the float ops are the JAX
package's, and the two scatter-adds sum each cell's eight-corner
contributions in the same ray order on the CPU.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax import lax
import torch

from bench import make_scene
from sdf_tools_tpu.grid import GridMeta as JaxGridMeta, SdfGrid as JaxSdfGrid, make_origin_transform as jax_origin
from sdf_tools_tpu.ops import edt as jedt, query as jquery, render as jrender, voxelize as jvoxelize
from sdf_tools_tpu_torch import convert
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


def test_march_matches_jax(scene):
    """make_scene(64), 64x64 rays from bench.py's camera, max_steps=64."""
    jsdf, sdf = scene
    jo, jd = _bench_rays(jsdf, 64, 64)
    kw = dict(t_max=4.0 * N * RES, max_steps=64)
    jr = jrender.render_depth(jsdf, jo, jd, backend="march", **kw)
    r = render.render_depth(sdf, torch.tensor(np.asarray(jo)), torch.tensor(np.asarray(jd)), backend="march", **kw)
    hit, depth = r.hit.numpy(), r.depth.numpy()
    assert r.steps.dtype == torch.int32 and 0.05 < hit.mean() < 0.95
    assert_march_agrees(hit, depth, np.asarray(jr.hit), np.asarray(jr.depth))
    assert (depth[~hit] == np.float32(kw["t_max"])).all()


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
    """make_scene(64), 64x64 rays from bench.py's camera: jax.grad of
    sum(depth^2) w.r.t. (values, origins, directions), the JAX march run
    eagerly, and the JAX forward's depth and hit."""
    jsdf, _ = scene
    jo, jd = _bench_rays(jsdf, 64, 64)
    jo = jnp.asarray(np.array(jo))  # a full array, not a broadcast
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
