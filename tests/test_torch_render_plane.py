"""The port's plane-sweep renderer against the JAX package's, on the CPU.

The JAX side is ``render_plane._plane_sweep_core(..., interpret=True)``
(jitted, the Pallas kernel in interpret mode); the kernel's slot table and
channels are captured from its ``pallas_call``. The port runs
``plane_sweep_tables`` -> ``plane_sweep_rows`` (K8's plain version on a CPU
tensor) -> ``verify_tail`` on the same numpy inputs. This file: the
two-sphere scene of ``tests/test_render_plane.py`` seen along +x and along
-x (positive and negative marching direction), the row tables and the tile
permutations. ``test_torch_render_plane_edges.py``: the ray starting
inside, the z-dominant unresolved fallback, boundary slivers, the
silhouette scene, the backward and the backend rule.

Tolerances, measured on these scenes and pinned:
- tile permutations, slot tables, integer row tables, steps, model bits,
  executed slabs, hit masks and the diag counts: equal;
- the port's row tables against the JAX package's ``_row_tables`` run
  eagerly on the same inputs: floats bitwise too;
- the kernel channels against the jitted JAX's: XLA's CPU jit contracts
  ``a*b + c`` into a fused multiply-add (``jax.jit(lambda a, b, c: a*b + c)``
  differs from numpy on 23% of random float32 inputs here and equals the
  FMA on all), which the port, like the eager JAX, does not. So
  ``y0c = uy0 - ux0*sy`` (and z0c) may differ by the rounding of the
  product: |diff| <= 2^-23 (|ux0*sy| + |y0c|). Measured: bitwise on the
  sphere scenes, up to 33 ulps on 460 of 2048 sliver rays;
- tnear and depths: the same FMA rounding inside the kernel's
  ``tc0 + tc1*ux`` and in the secant: rtol 1e-6 (about 8 ulps). Measured:
  at most 9.5e-7 on tnear and 3.8e-6 on depths around t = 10-40.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from sdf_tools_tpu.grid import GridMeta as JaxGridMeta
from sdf_tools_tpu.ops import render_plane as jrp
from sdf_tools_tpu_torch import _build, convert
from sdf_tools_tpu_torch.ops import render, render_plane

T_MAX = 40.0
EPS = 1e-3
T_RTOL = 1e-6
EYE = np.eye(4, dtype=np.float32)


def sphere_values(shape=(64, 64, 256), res=0.1):
    """The two-sphere analytic field of tests/test_render_plane.py."""
    nx, ny, nz = shape
    ii, jj, kk = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij")
    pts = (np.stack([ii, jj, kk], -1) + 0.5) * res
    c1 = np.array([nx * 0.5, ny * 0.5, nz * 0.45]) * res
    c2 = np.array([nx * 0.65, ny * 0.35, nz * 0.55]) * res
    d1 = np.linalg.norm(pts - c1, axis=-1) - 0.2 * ny * res
    d2 = np.linalg.norm(pts - c2, axis=-1) - 0.12 * ny * res
    return np.minimum(d1, d2).astype(np.float32)


def port_sdf(values, res, oob=np.inf):
    meta = convert.grid_meta_from_numpy(EYE, EYE, np.float32(res), values.shape, device="cpu")
    return convert.sdf_grid_from_numpy(values, meta, oob)


def camera(pos, look_at, fov, h, w):
    return render.camera_rays(np.asarray(pos, np.float32), np.asarray(look_at, np.float32), (0.0, 0.0, 1.0), fov, h, w, device="cpu")


def jax_core(values, res, origins, directions, t_max=T_MAX, more_rays=()):
    """JAX's ``_plane_sweep_core`` on padded rays [N, 3] in interpret mode,
    with the kernel's slot table and channels captured from its
    ``pallas_call`` by a debug callback. ``more_rays``: further (origins,
    directions) of the same shapes, run after it by the same compiled core
    (a cache hit, no new trace); their (depth, hit, counts) under "more"."""
    captured = {}
    real = jrp.pl.pallas_call

    def spy(kernel, **kw):
        call = real(kernel, **kw)

        def run(*args):
            jax.debug.callback(lambda tab, ch: captured.update(tab=np.asarray(tab), ch=np.asarray(ch)), args[0], args[1])
            return call(*args)

        return run

    meta = JaxGridMeta.create(origin_transform=jnp.eye(4), resolution=res, shape=values.shape)
    jax.clear_caches()  # trace the spy in even if this process compiled the core before
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jrp.pl, "pallas_call", spy)
        out = jrp._plane_sweep_core(
            jnp.asarray(values), meta.inv_origin_transform, meta.resolution, jnp.asarray(origins),
            jnp.asarray(directions), 0.0, t_max, EPS, interpret=True, max_steps=96, min_step=None,
        )
        out = jax.block_until_ready(out)
        jax.effects_barrier()
        tab, ch = captured["tab"], captured["ch"]
        more = []
        for o, d in more_rays:
            more.append(jrp._plane_sweep_core(
                jnp.asarray(values), meta.inv_origin_transform, meta.resolution, jnp.asarray(o), jnp.asarray(d),
                0.0, t_max, EPS, interpret=True, max_steps=96, min_step=None,
            ))
        more = jax.block_until_ready(more)
        jax.effects_barrier()
    jax.clear_caches()
    return dict(tab=tab.reshape(tab.shape[0], -1), ch=ch, **_core_outputs(out), more=[_core_outputs(m) for m in more])


def _core_outputs(out):
    depth, hit, steps, unresolved, n_act, n_flagged, n_near, n_resumed, classes, tnear, model, exec_total = out
    return dict(
        depth=np.asarray(depth), hit=np.asarray(hit), steps=np.asarray(steps), unresolved=np.asarray(unresolved),
        tnear=np.asarray(tnear), model=np.asarray(model),
        counts=dict(
            n_act=int(n_act), n_flagged=int(n_flagged), n_near_miss=int(n_near), n_resumed=int(n_resumed),
            n_entry=int(classes[0]), n_graze=int(classes[1]), n_exit=int(classes[2]), exec_slabs=int(exec_total),
            unresolved=int(np.asarray(unresolved).sum()),
        ),
    )


def port_core(sdf, origins, directions, t_max=T_MAX):
    """The port's three stages on padded rays, in the shape of ``jax_core``."""
    tables = render_plane.plane_sweep_tables(sdf.values, sdf.meta, origins, directions, 0.0, t_max)
    kout = render_plane.plane_sweep_rows(tables.tab, tables.ch, tables.vols, EPS, t_max)
    unresolved = tables.unresolved_row[:, None].expand(-1, render_plane.LANES).reshape(-1)
    tail = render_plane.verify_tail(
        sdf.values, sdf.meta, origins, directions, tables.info["tc1"], unresolved, kout, 0.0, t_max, EPS, 96, None
    )
    model = kout[3].reshape(-1).numpy()
    return dict(
        tables=tables, tab=tables.tab.numpy(), ch=tables.ch.numpy(), depth=tail.depth.numpy(), hit=tail.hit.numpy(),
        steps=kout[2].reshape(-1).numpy(), unresolved=tail.unresolved.numpy(), tnear=kout[4].reshape(-1).numpy(),
        model=model, kernel_hit=kout[1].reshape(-1).numpy(),
        counts=dict(
            n_act=int(tables.tab[:, 0].sum()), n_flagged=int(tail.n_flagged), n_near_miss=int(tail.n_near),
            n_resumed=int(tail.n_resumed), n_entry=int(((model & 1) > 0).sum()), n_graze=int(((model & 2) > 0).sum()),
            n_exit=int(((model & 4) > 0).sum()), exec_slabs=int(kout[5][:, 0].sum()),
            unresolved=int(tail.unresolved.sum()),
        ),
    )


def both_cores(values, res, origins, directions, t_max=T_MAX, reorder=None):
    """(port, jax) on the same rays, prepared (tiled, padded) by the port.
    ``reorder(port)``: a permutation of the prepared rays; the JAX core also
    runs them in that order (``want["more"][0]``, ``want["perm"]``)."""
    rays = render_plane.prepare_rays(torch.as_tensor(origins), torch.as_tensor(directions))
    port = port_core(port_sdf(values, res), rays.origins, rays.directions, t_max)
    of, vf = rays.origins.numpy(), rays.directions.numpy()
    perm = None if reorder is None else reorder(port)
    more = () if perm is None else [(of[perm], vf[perm])]
    want = jax_core(values, res, of, vf, t_max, more_rays=more)
    want["perm"] = perm
    return rays, port, want


def assert_cores_agree(port, want, ch_bitwise):
    """The tolerances of the module docstring."""
    np.testing.assert_array_equal(port["tab"], want["tab"])
    if ch_bitwise:
        np.testing.assert_array_equal(port["ch"].view(np.uint32), want["ch"].view(np.uint32))
    else:
        for k in range(render_plane.NCH):
            got, w = port["ch"][:, k], want["ch"][:, k]
            if k in (0, 2):  # y0c = uy0 - ux0*sy, z0c = uz0 - ux0*sz
                prod = np.abs(port["tables"].info["ux0"].numpy() * port["ch"][:, k + 1])
                assert (np.abs(got - w) <= 2.0**-23 * (prod + np.abs(got))).all(), k
            else:
                np.testing.assert_array_equal(got.view(np.uint32), w.view(np.uint32))
    np.testing.assert_array_equal(port["steps"], want["steps"])
    np.testing.assert_array_equal(port["model"], want["model"])
    np.testing.assert_array_equal(port["hit"], want["hit"])
    np.testing.assert_array_equal(port["unresolved"], want["unresolved"])
    assert port["counts"] == want["counts"]
    np.testing.assert_allclose(port["tnear"], want["tnear"], rtol=T_RTOL, atol=0)
    np.testing.assert_allclose(port["depth"], want["depth"], rtol=T_RTOL, atol=0)


@pytest.fixture(scope="module")
def spheres():
    return sphere_values(), 0.1


@pytest.fixture(scope="module")
def forward(spheres):
    """32x128 rays from the -x side (positive marching direction)."""
    values, res = spheres
    shape = np.array(values.shape)
    center = shape * res * 0.5
    pos = center + np.array([-shape[0] * res * 1.5, shape[1] * res * 0.1, shape[2] * res * 0.05])
    o, v = camera(pos, center, 40.0, 32, 128)
    return (o, v) + both_cores(values, res, o.numpy(), v.numpy())


@pytest.fixture(scope="module")
def backward(spheres):
    """24x128 rays from the +x side looking back (negative direction)."""
    values, res = spheres
    shape = np.array(values.shape)
    center = shape * res * 0.5
    pos = center + np.array([shape[0] * res * 1.5, shape[1] * res * 0.1, 0.0])
    o, v = camera(pos, center, 40.0, 24, 128)
    return (o, v) + both_cores(values, res, o.numpy(), v.numpy())


@pytest.mark.parametrize("case", ["forward", "backward"])
def test_plane_core_matches_jax(case, request):
    """Tables, kernel-level steps / model bits / tnear / executed slabs and
    the tail's depth and hit against JAX, with every ray resolved and the
    marching direction as named."""
    _, _, rays, port, want = request.getfixturevalue(case)
    assert port["counts"]["unresolved"] == 0 and port["counts"]["n_act"] > 0
    tc1 = port["ch"][:, 5]
    assert ((tc1 > 0) if case == "forward" else (tc1 < 0)).all()
    assert 0.01 < port["hit"].mean() < 0.5
    assert_cores_agree(port, want, ch_bitwise=True)


@pytest.mark.parametrize("case", ["forward", "backward"])
def test_plane_depth_agrees_with_march(case, request, spheres):
    """The whole path (``render_depth(backend="plane")``) against the port's
    march, with the JAX plane test's bars (tests/test_render_plane.py:76-88),
    and against the core's own output."""
    values, res = spheres
    o, v, rays, port, _ = request.getfixturevalue(case)
    sdf = port_sdf(values, res)
    r = render.render_depth(sdf, o, v, t_max=T_MAX, eps=EPS, backend="plane")
    m = render.render_depth(sdf, o, v, t_max=T_MAX, eps=EPS, backend="march")
    assert r.depth.shape == r.hit.shape == r.steps.shape == o.shape[:-1]
    np.testing.assert_array_equal(r.hit.reshape(-1).numpy(), render_plane._restore(torch.as_tensor(port["hit"]), rays).reshape(-1).numpy())
    h_ps, h_ref = r.hit.numpy().reshape(-1), m.hit.numpy().reshape(-1)
    assert (h_ps == h_ref).mean() > 0.98
    both = h_ps & h_ref
    assert both.sum() > 50
    err = np.abs(r.depth.numpy().reshape(-1) - m.depth.numpy().reshape(-1))[both]
    assert np.quantile(err, 0.95) < 0.5 * res and np.median(err) < 0.1 * res
    assert (r.depth.numpy()[~r.hit.numpy()] == np.float32(T_MAX)).all()
    assert (r.steps.numpy()[r.hit.numpy()] > 0).all()


@pytest.mark.parametrize("case", ["forward", "backward"])
def test_row_tables_match_jax_eager(case, request, spheres):
    """``_row_tables`` on the same grid-frame rays: every output equal to
    the JAX package's (run eagerly), integers and floats."""
    values, res = spheres
    _, _, rays, port, _ = request.getfixturevalue(case)
    info = port["tables"].info
    meta = port_sdf(values, res).meta
    u0, vg, t_start, t_end = render_plane._grid_rays(values.shape, meta, rays.origins, rays.directions, 0.0, T_MAX)
    shapes = [tuple(values.shape[i] for i in render_plane._perm(a)) for a in range(3)]
    supported = [render_plane._axis_supported(s) for s in shapes]
    smax = port["tab"].shape[1] - render_plane.HDR
    want = jrp._row_tables(shapes, supported, *(jnp.asarray(x.numpy()) for x in (u0, vg, t_start, t_end)), res, smax)
    assert set(want) == set(info)
    for key, w in want.items():
        got = info[key].numpy()
        w = np.asarray(w)
        assert got.shape == w.shape, key
        if got.dtype == np.float32:
            np.testing.assert_array_equal(got.view(np.uint32), w.view(np.uint32), err_msg=key)
        else:
            np.testing.assert_array_equal(got, w, err_msg=key)


@pytest.mark.parametrize("hw", [(8, 16), (16, 32), (24, 48)])
@pytest.mark.parametrize("nimg", [1, 3])
def test_tile_permutations_match_jax(hw, nimg):
    h, w = hw
    n = nimg * h * w
    x = np.random.default_rng(h + w + nimg).standard_normal((n, 3)).astype(np.float32)
    perm, inv = render_plane.tile_perm(h, w, n)
    jperm, jinv = jrp.tile_perm(h, w, n)
    np.testing.assert_array_equal(perm.numpy(), jperm)
    np.testing.assert_array_equal(inv.numpy(), jinv)
    grouped = render_plane.tile_regroup(torch.as_tensor(x), h, w)
    np.testing.assert_array_equal(grouped.numpy(), np.asarray(jrp.tile_regroup(jnp.asarray(x), h, w)))
    np.testing.assert_array_equal(grouped.numpy(), x[perm.numpy()])
    np.testing.assert_array_equal(render_plane.tile_ungroup(grouped, h, w).numpy(), x)


@pytest.mark.parametrize(
    "shape", [(64, 64, 256), (256, 64, 64), (64, 256, 64), (17, 56, 256), (16, 56, 256), (64, 64, 64), (512, 512, 512)]
)
def test_plane_sweep_supported_matches_jax(shape):
    assert render_plane.plane_sweep_supported(shape) == jrp.plane_sweep_supported(shape)


def test_plane_sweep_rows_plain_on_cpu_counts_no_launch(forward):
    """On CPU tensors the K8 wrapper runs its plain version (the same
    result) and counts no launch; bad inputs raise."""
    tables = forward[3]["tables"]
    before = dict(_build.LAUNCHES)
    got = render_plane.plane_sweep_rows(tables.tab, tables.ch, tables.vols, EPS, T_MAX)
    want = render_plane.plane_sweep_rows_plain(tables.tab, tables.ch, tables.vols, EPS, T_MAX)
    assert _build.LAUNCHES == before
    for g, w in zip(got, want):
        assert g.shape == (tables.tab.shape[0], render_plane.LANES) and torch.equal(g, w)
    with pytest.raises(ValueError):
        render_plane.plane_sweep_rows(tables.tab.to(torch.int64), tables.ch, tables.vols, EPS, T_MAX)
    with pytest.raises(ValueError):
        render_plane.plane_sweep_rows(tables.tab, tables.ch[:, :9], tables.vols, EPS, T_MAX)
