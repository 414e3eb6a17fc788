"""The port's plane-sweep renderer at its edges, on the CPU: rays starting
inside an obstacle, z-dominant rays the sweep cannot take (the unresolved
fallback), obstacles poking through the grid faces (entry/exit slivers),
a silhouette-heavy view, the backward through ``backend="plane"`` and the
``"auto"`` rule.

Against the JAX package as in ``test_torch_render_plane.py`` (same
tolerances, same helpers). Rays the sweep leaves unresolved are traced by
the port's march, which follows the JAX march's eager op sequence and is
held bitwise to it run eagerly (the JAX package runs this fallback jitted,
and its jitted march differs from its eager one on about 1.6% of the 64x64
bench rays at 64^3, tests/test_torch_engine.py). Against dense ground truth (4096 exact samples per ray) with the
JAX plane tests' bars (tests/test_render_plane.py:163-275).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from sdf_tools_tpu.grid import GridMeta as JaxGridMeta, SdfGrid as JaxSdfGrid
from sdf_tools_tpu.ops import render as jrender
from sdf_tools_tpu_torch.ops import query, render, render_plane
from test_torch_render_plane import EPS, assert_cores_agree, both_cores, camera, port_core, port_sdf, sphere_values


def sliver_values(shape=(64, 64, 256), res=0.05):
    """Spheres centred near the grid faces (tests/test_render_plane.py:163-185)."""
    rng = np.random.default_rng(2)
    ii, jj, kk = np.meshgrid(np.arange(shape[0]), np.arange(shape[1]), np.arange(shape[2]), indexing="ij")
    pts = (np.stack([ii, jj, kk], -1) + 0.5) * res
    d = np.full(shape, 1e9, np.float32)
    ext = np.array(shape) * res
    for _ in range(30):
        c = ext * rng.random(3)
        face = rng.integers(0, 7)
        if face < 6:
            ax, side = face % 3, face // 3
            c[ax] = (0.0 if side == 0 else ext[ax]) + res * rng.uniform(-6, 6)
        r = res * (5 + 15 * rng.random())
        d = np.minimum(d, np.linalg.norm(pts - c, axis=-1) - r)
    return d.astype(np.float32)


def jax_eager_march(values, res, o, v, t_max):
    meta = JaxGridMeta.create(origin_transform=jnp.eye(4), resolution=res, shape=values.shape)
    sdf = JaxSdfGrid.create(jnp.asarray(values), meta, oob_value=jnp.inf)
    with jax.disable_jit():
        d, h, _ = jrender._trace_depth(sdf.values, sdf, jnp.asarray(o), jnp.asarray(v), 0.0, t_max, EPS, 96, None)
    return np.asarray(d), np.asarray(h)


def dense_truth(sdf, o, v, t_lo, t_max, n=4096):
    """First t of ``n`` samples over [t_lo, t_max] where the exact corrected
    trilinear is below eps (inf if none), per ray."""
    ts = torch.linspace(t_lo, t_max, n, dtype=torch.float32)
    t_true = torch.full((o.shape[0],), float("inf"))
    for b in range(0, o.shape[0], 256):
        pts = o[b : b + 256, None, :] + ts[None, :, None] * v[b : b + 256, None, :]
        d, ok = query.estimate_distance(sdf, pts)
        below = ok & (d < EPS)
        t_true[b : b + 256] = torch.where(below.any(1), ts[below.to(torch.int8).argmax(1)], float("inf"))
    return t_true, float(ts[1] - ts[0])


def check_final(values, res, o, v, t_max, rays, port, want):
    """``plane_sweep_depth``: resolved rays as the JAX core left them,
    unresolved rays bitwise equal to the JAX march run eagerly; the diag
    counts equal the core's."""
    sdf = port_sdf(values, res)
    d, h, _, diag = render_plane.plane_sweep_depth(sdf, o, v, 0.0, t_max, EPS, 96, None, diag=True)
    assert {k: int(x) for k, x in diag.items()} == want["counts"]
    d, h = d.reshape(-1).numpy(), h.reshape(-1).numpy()

    def ray_order(x):
        return render_plane._restore(torch.as_tensor(np.array(x)), rays).reshape(-1).numpy()

    unres = ray_order(want["unresolved"])
    assert (~unres).any()
    np.testing.assert_array_equal(h[~unres], ray_order(want["hit"])[~unres])
    np.testing.assert_allclose(d[~unres], ray_order(want["depth"])[~unres], rtol=1e-6, atol=0)
    if unres.any():
        jd, jh = jax_eager_march(values, res, o.reshape(-1, 3).numpy()[unres], v.reshape(-1, 3).numpy()[unres], t_max)
        np.testing.assert_array_equal(h[unres], jh)
        np.testing.assert_array_equal(d[unres].view(np.uint32), jd.view(np.uint32))
    return d, h


@pytest.fixture(scope="module")
def inside_and_z():
    """Two rows of 128 rays in the two-sphere scene: row 0 starts inside the
    big sphere marching +x; row 1 marches +z, an axis too short for the
    band (64 cells < 256), so the best supported axis breaks the slope cap
    and the row is unresolved."""
    values, res = sphere_values(), 0.1
    shape = np.array(values.shape)
    start = shape * res * 0.5
    start[2] = shape[2] * res * 0.45
    o_in = np.tile(start, (128, 1)).astype(np.float32)
    v_in = np.tile([1.0, 0.0, 0.0], (128, 1)).astype(np.float32)
    o_z = np.zeros((128, 3), np.float32)
    o_z[:, 0] = shape[0] * res * 0.5 + np.linspace(-0.5, 0.5, 128)
    o_z[:, 1] = shape[1] * res * 0.5
    o_z[:, 2] = -1.0
    v_z = np.tile([0.0, 0.0, 1.0], (128, 1)).astype(np.float32)
    o, v = np.concatenate([o_in, o_z]), np.concatenate([v_in, v_z])
    return (values, res, torch.as_tensor(o), torch.as_tensor(v)) + both_cores(values, res, o, v)


def flagged_ray_first(port):
    """A permutation of the prepared rays that makes the sweep's first
    flagged ray (a model hit the tail re-checks) ray 0: its row first, it in
    lane 0. A row's sweep does not depend on its place or its lanes' order."""
    r = int(np.flatnonzero(port["kernel_hit"] & (port["model"] > 0))[0])
    row, lane = divmod(r, render_plane.LANES)
    rows = [row] + [i for i in range(len(port["hit"]) // render_plane.LANES) if i != row]
    lanes = list(range(render_plane.LANES))
    lanes[0], lanes[lane] = lane, 0
    return np.array([i * render_plane.LANES + k for i in rows for k in lanes])


@pytest.fixture(scope="module")
def slivers():
    """The sliver scene; the JAX core also runs its rays reordered by
    ``flagged_ray_first`` (the same compiled core, no new trace)."""
    values, res = sliver_values(), 0.05
    ext = np.array(values.shape) * res
    center = ext * 0.5
    cam = center + np.array([-values.shape[0] * res * 1.2, 0.0, ext[2] * 0.4])
    o, v = camera(cam, center, 50.0, 16, 128)
    return (values, res, o, v) + both_cores(values, res, o.numpy(), v.numpy(), t_max=30.0, reorder=flagged_ray_first)


def test_inside_and_z_dominant_match_jax(inside_and_z):
    values, res, o, v, rays, port, want = inside_and_z
    assert port["tables"].unresolved_row.tolist() == [False, True]
    assert_cores_agree(port, want, ch_bitwise=True)
    d, h = check_final(values, res, o, v, 40.0, rays, port, want)
    # rays starting inside an obstacle hit at once
    assert h[:128].all() and (d[:128] < 2 * res).all()
    assert port["kernel_hit"][:128].all()


def test_slivers_match_jax(slivers):
    values, res, o, v, rays, port, want = slivers
    # the tail's passes all ran: an exit-model hit demoted and resumed
    assert port["counts"]["n_exit"] > 0 and port["counts"]["n_resumed"] > 0 and port["counts"]["n_near_miss"] > 0
    assert_cores_agree(port, want, ch_bitwise=False)
    check_final(values, res, o, v, 30.0, rays, port, want)


def test_jax_tail_loses_ray0_update(slivers):
    """The JAX tail's passes scatter their whole budget back, and the slots
    no ray filled hold index 0 with ray 0's old value; XLA applies duplicate
    indices in no stated order. With the sweep's one flagged ray (an exit
    model hit that the exact window does not confirm) moved to ray 0 and the
    budgets far from full, the jitted JAX core keeps ray 0's unverified hit
    at the sweep's depth, never resumes it (n_resumed 0) and counts one near
    miss fewer. The port writes
    only the selected slots: it demotes the ray and resumes it, as both do
    with the rays in their first order. Every other ray agrees (the module's
    tolerances). A fault of the JAX package; it stays there."""
    values, res, _, _, rays, port, want = slivers
    perm, jax_perm = want["perm"], want["more"][0]
    r = perm[0]
    assert port["counts"]["n_flagged"] == want["counts"]["n_flagged"] == 1
    assert port["counts"]["n_resumed"] == want["counts"]["n_resumed"] == 1
    assert not port["hit"][r] and not want["hit"][r] and port["kernel_hit"][r]

    # the port, reordered: ray 0 demoted and resumed to the same answer
    moved = port_core(port_sdf(values, res), rays.origins[perm], rays.directions[perm], 30.0)
    assert moved["counts"] == port["counts"]
    np.testing.assert_array_equal(moved["hit"], port["hit"][perm])
    np.testing.assert_array_equal(moved["depth"], port["depth"][perm])
    assert not moved["hit"][0] and moved["depth"][0] == np.float32(30.0)

    # JAX, reordered: ray 0's update lost, the sweep's unverified hit kept;
    # as a hit it is no near-miss candidate either
    assert jax_perm["counts"] == {**want["counts"], "n_resumed": 0, "n_near_miss": want["counts"]["n_near_miss"] - 1}
    assert jax_perm["hit"][0] and jax_perm["model"][0] == 4  # the exit model's hit
    tables = port["tables"]
    swept = render_plane.plane_sweep_rows(tables.tab, tables.ch, tables.vols, EPS, 30.0)[0].reshape(-1)[r]
    np.testing.assert_allclose(jax_perm["depth"][0], swept.numpy(), rtol=1e-6, atol=0)
    assert jax_perm["depth"][0] < 30.0
    rest = np.arange(1, len(perm))
    np.testing.assert_array_equal(jax_perm["hit"][rest], moved["hit"][rest])
    np.testing.assert_allclose(jax_perm["depth"][rest], moved["depth"][rest], rtol=1e-6, atol=0)


def test_slivers_against_dense_truth(slivers):
    """Crossings in the sliver between a grid face and the nearest plane
    centre: scored against 4096 exact samples per ray; at most 8 near-graze
    rays may resolve either way (the JAX test's bar)."""
    values, res, o, v, *_ = slivers
    sdf = port_sdf(values, res)
    d, h, _ = render_plane.plane_sweep_depth(sdf, o, v, 0.0, 30.0, EPS, 96, None)
    d, h = d.reshape(-1), h.reshape(-1)
    t_true, dt = dense_truth(sdf, o.reshape(-1, 3), v.reshape(-1, 3), 0.02, 30.0)
    has = torch.isfinite(t_true)
    err = torch.where(has & h, (d - torch.where(has, t_true, 0.0)).abs(), 0.0)
    correct = int(((h == has) & (err <= 2 * dt + 2 * res)).sum())
    assert correct >= h.numel() - 8, (correct, h.numel())


def test_silhouette_no_false_misses():
    """A view filled by the big sphere's limb: against dense ground truth
    no true hit may be lost (near-miss verification), and confirmed hits
    sit at the true crossing (tests/test_render_plane.py:225-275)."""
    values, res = sphere_values(), 0.1
    nx, ny, nz = values.shape
    c1 = np.array([nx * 0.5, ny * 0.5, nz * 0.45]) * res
    limb = c1 + np.array([0.0, 0.0, 0.2 * ny * res])
    o, v = camera(limb + np.array([-nx * res * 1.5, 0.0, 0.0]), limb, 6.0, 16, 16)
    sdf = port_sdf(values, res)
    d, h, _, diag = render_plane.plane_sweep_depth(sdf, o, v, 0.0, 40.0, EPS, 96, None, diag=True)
    assert int(diag["unresolved"]) == 0
    t_true, _ = dense_truth(sdf, o.reshape(-1, 3), v.reshape(-1, 3), 1e-3, 40.0)
    truth = torch.isfinite(t_true)
    h = h.reshape(-1)
    assert truth.any() and (~truth).any()
    assert int((truth & ~h).sum()) == 0
    both = truth & h
    assert float((d.reshape(-1)[both] - t_true[both]).abs().max()) < 0.15


def test_plane_backward_is_ift_of_plane_forward():
    """The gradient through ``backend="plane"`` is ``ift_backward`` fed the
    plane forward's depth and hit, for values, origins and directions."""
    values, res = sphere_values(), 0.1
    shape = np.array(values.shape)
    center = shape * res * 0.5
    o, v = camera(center + np.array([-shape[0] * res * 1.5, shape[1] * res * 0.1, 0.0]), center, 40.0, 16, 128)
    sdf = port_sdf(values, res)
    vals = sdf.values.clone().requires_grad_(True)
    og, vg = o.clone().requires_grad_(True), v.clone().requires_grad_(True)
    r = render.render_depth(type(sdf)(vals, sdf.meta, sdf.oob_value), og, vg, t_max=40.0, eps=EPS, backend="plane")
    (r.depth**2).sum().backward()
    depth = r.depth.detach()
    want = render.ift_backward(sdf, o, v, depth, r.hit, 2.0 * depth)
    assert r.hit.any() and (want[0] != 0).any()
    for got, w in zip((vals.grad, og.grad, vg.grad), want):
        assert torch.equal(got, w)


@pytest.mark.parametrize(
    "device_type, shape, rays_shape, want",
    [
        ("cuda", (64, 64, 256), (32, 128, 3), "plane"),
        ("cuda", (64, 64, 256), (4, 128, 3), "plane"),  # 512 rays: the smallest bundle
        ("cuda", (64, 64, 256), (3, 128, 3), "march"),  # 384 rays
        ("cuda", (64, 64, 256), (4096, 3), "march"),  # a flat list
        ("cuda", (64, 64, 64), (32, 128, 3), "march"),  # no axis fits the band
        ("cuda", (512, 512, 512), (1024, 1024, 3), "plane"),
        ("cpu", (64, 64, 256), (32, 128, 3), "march"),
        ("cpu", (512, 512, 512), (1024, 1024, 3), "march"),
    ],
)
def test_resolve_backend_rule(device_type, shape, rays_shape, want):
    origins = torch.empty(rays_shape, device="meta")
    assert render._resolve_backend("auto", shape, origins, device_type) == want
    for explicit in ("plane", "march"):
        assert render._resolve_backend(explicit, shape, origins, device_type) == explicit


def test_resolve_backend_defaults_to_the_origins_device():
    origins = torch.zeros((32, 128, 3))
    assert render._resolve_backend("auto", (64, 64, 256), origins) == "march"
