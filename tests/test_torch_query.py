"""The port's grid geometry and query surface against the JAX package, on
the CPU.

Both packages get the same f32 field (24 x 20 x 16 cells, three spheres)
under an identity origin and under a rotated, translated one (the port's
geometry carried across with ``convert``). Tolerances:

- bitwise: ``GridMeta.grid_to_world``, ``index_to_location(_grid_frame)``,
  ``location_in_bounds``, ``SdfGrid.get_value_by_index`` /
  ``get_value_by_location``, ``corrected_center_distance``,
  ``grid_aligned_gradient``, ``gradient`` and ``full_gradient`` (edge
  gradients on and off, and through ``gradient_function``),
  ``smooth_gradient``, ``distance_to_boundary`` and
  ``project_into_valid_volume``: eager JAX runs the same float operations
  one at a time, as the port does;
- ``grid_aligned_gradient`` against the scalar float64 oracle
  (``sdf_tools_tpu/oracle/reference_query.py``): the same validity, values
  within rtol 1e-6, atol 1e-6 (the oracle multiplies by 1 / (2 res) in
  float64, the packages divide in float32);
- ``project_out_of_collision``: JAX runs its steps in a compiled while loop,
  where XLA's CPU jit contracts products into FMAs, so its points differ
  from the port's by up to about 1.5e-6 here; held to points within atol
  1e-5 and their final distances within 1e-5, and success equal except
  where JAX's own final distance lies within 1e-5 of ``minimum_distance``
  (its loop stops on its compiled distance, its success comes from an
  eager one, and the two disagree there). The port is held bitwise to
  itself with a host check after every step, which is the JAX loop's
  order, and runs exactly ``max_steps`` steps when they are not enough.
  On a 512 x 512 x 1 grid, where some steps are shorter than the spacing
  of float32 coordinates, JAX's points stall short of the distance and
  fail; the port's succeed, within the same 1e-5 of JAX's points.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from sdf_tools_tpu.grid import GridMeta as JaxGridMeta, SdfGrid as JaxSdfGrid, make_origin_transform as jax_origin
from sdf_tools_tpu.ops import query as jquery
from sdf_tools_tpu.oracle.reference_query import OracleSdf
from sdf_tools_tpu_torch import convert
from sdf_tools_tpu_torch.ops import edt, query
from test_torch_render import _port_meta, _rotation

SHAPE = (24, 20, 16)
RES = 0.1
OOB = 1e3
PROJECT_ATOL = 1e-5
MIN_DIST = 0.05
ORIGINS = ("identity", "rotated")


def _values():
    ii = np.indices(SHAPE).transpose(1, 2, 3, 0)
    mask = np.zeros(SHAPE, bool)
    for c, r in (((6, 6, 5), 3.5), ((16, 12, 9), 4.2), ((10, 15, 4), 2.5)):
        mask |= ((ii - np.array(c)) ** 2).sum(-1) <= r * r
    return mask, edt.signed_field_from_masks(torch.as_tensor(mask), RES, "plain")[0].numpy()


@pytest.fixture(scope="module", params=ORIGINS)
def grids(request):
    """(JAX SdfGrid, the port's SdfGrid, filled mask) of the same field."""
    mask, values = _values()
    if request.param == "rotated":
        origin = jax_origin([0.3, -0.2, 0.1], _rotation(20.0, 2) @ _rotation(-10.0, 0))
    else:
        origin = jax_origin([0.0, 0.0, 0.0])
    jmeta = JaxGridMeta.create(origin, RES, SHAPE)
    jsdf = JaxSdfGrid.create(jnp.asarray(values), jmeta, OOB)
    return jsdf, convert.sdf_grid_from_numpy(values, _port_meta(jmeta), OOB), mask


def _grid_points(n, seed):
    """Grid-frame points over the volume and up to a tenth beyond it."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(-0.1, 1.1, (n, 3)) * np.array(SHAPE) * RES).astype(np.float32)


def _world_points(jsdf, n=4000, seed=0):
    return np.array(jsdf.meta.grid_to_world(jnp.asarray(_grid_points(n, seed))))


def _indices(n=4000, seed=1):
    return np.random.default_rng(seed).integers(-2, max(SHAPE) + 2, (n, 3)).astype(np.int32)


def _same(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    if want.dtype == np.float32:
        got, want = got.view(np.uint32), want.view(np.uint32)
    np.testing.assert_array_equal(got, want)


def test_grid_meta_methods_match_jax(grids):
    jsdf, sdf, _ = grids
    pts = _grid_points(4000, 2)
    idx = _indices()
    jm, m = jsdf.meta, sdf.meta
    _same(m.grid_to_world(torch.as_tensor(pts)), jm.grid_to_world(jnp.asarray(pts)))
    _same(m.index_to_location_grid_frame(torch.as_tensor(idx)), jm.index_to_location_grid_frame(jnp.asarray(idx)))
    _same(m.index_to_location(torch.as_tensor(idx)), jm.index_to_location(jnp.asarray(idx)))
    wp = _world_points(jsdf)
    _same(m.location_in_bounds(torch.as_tensor(wp)), jm.location_in_bounds(jnp.asarray(wp)))
    assert sdf.shape == jsdf.shape == SHAPE


def test_get_value_matches_jax(grids):
    jsdf, sdf, _ = grids
    idx = _indices()
    for got, want in zip(sdf.get_value_by_index(torch.as_tensor(idx)), jsdf.get_value_by_index(jnp.asarray(idx))):
        _same(got, want)
    wp = _world_points(jsdf)
    for got, want in zip(sdf.get_value_by_location(torch.as_tensor(wp)), jsdf.get_value_by_location(jnp.asarray(wp))):
        _same(got, want)
    assert not sdf.get_value_by_index(torch.as_tensor(idx))[1].all()  # out-of-bounds cells present


def test_corrected_center_distance_matches_jax(grids):
    jsdf, sdf, _ = grids
    idx = np.clip(_indices(), 0, np.array(SHAPE) - 1)
    got = query.corrected_center_distance(sdf, *torch.as_tensor(idx).unbind(-1))
    _same(got, jquery.corrected_center_distance(jsdf, *jnp.asarray(idx).T))


@pytest.mark.parametrize("edges", [False, True], ids=["interior", "edge_gradients"])
def test_gradients_match_jax_and_oracle(grids, edges):
    jsdf, sdf, _ = grids
    idx = _indices()
    got, valid = query.grid_aligned_gradient(sdf, torch.as_tensor(idx), edges)
    want, want_valid = jquery.grid_aligned_gradient(jsdf, jnp.asarray(idx), edges)
    _same(got, want)
    _same(valid, want_valid)
    for got_w, want_w in zip(query.gradient(sdf, torch.as_tensor(idx), edges),
                             jquery.gradient(jsdf, jnp.asarray(idx), edges)):
        _same(got_w, want_w)
    oracle = OracleSdf(sdf.values.numpy(), RES, np.eye(4), OOB)
    for k in range(0, len(idx), 7):
        og = oracle.grid_aligned_gradient(*(int(i) for i in idx[k]), enable_edge_gradients=edges)
        assert bool(valid[k]) == (og is not None)
        if og is not None:
            np.testing.assert_allclose(got[k].numpy(), og, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("edges", [False, True], ids=["interior", "edge_gradients"])
def test_full_gradient_matches_jax(grids, edges):
    jsdf, sdf, _ = grids
    got = query.full_gradient(sdf, edges)
    assert got.shape == SHAPE + (3,)
    _same(got, jquery.full_gradient(jsdf, edges))


@pytest.mark.parametrize("shape", [(6, 2, 1), (1, 5, 3), (3, 1, 2)])
def test_full_gradient_thin_axes_match_jax(shape):
    """Axes of one cell (zero gradient) and two (both cells one-sided)."""
    values = np.random.default_rng(sum(shape)).normal(size=shape).astype(np.float32)
    jmeta = JaxGridMeta.create(jax_origin([0.1, 0.2, 0.3], _rotation(30.0, 1)), RES, shape)
    jsdf = JaxSdfGrid.create(jnp.asarray(values), jmeta, OOB)
    sdf = convert.sdf_grid_from_numpy(values, _port_meta(jmeta), OOB)
    for edges in (False, True):
        _same(query.full_gradient(sdf, edges), jquery.full_gradient(jsdf, edges))


def test_full_gradient_function_matches_jax(grids):
    """The ``gradient_function`` hook gets the dense int32 index grid."""
    jsdf, sdf, _ = grids

    def port_fn(s, idx, edges):
        assert idx.dtype == torch.int32 and idx.shape == SHAPE + (3,)
        return query.gradient(s, idx, edges)[0] * 2.0

    got = query.full_gradient(sdf, True, gradient_function=port_fn)
    want = jquery.full_gradient(jsdf, True, gradient_function=lambda s, i, e: jquery.gradient(s, i, e)[0] * 2.0)
    _same(got, want)


@pytest.mark.parametrize("window", [0.07, -0.25])
def test_smooth_gradient_matches_jax(grids, window):
    jsdf, sdf, _ = grids
    wp = _world_points(jsdf)
    got = query.smooth_gradient(sdf, torch.as_tensor(wp), window)
    want = jquery.smooth_gradient(jsdf, jnp.asarray(wp), window)
    for g, w in zip(got, want):
        _same(g, w)
    assert got[1].any() and not got[1].all()


def test_distance_to_boundary_matches_jax(grids):
    jsdf, sdf, _ = grids
    wp = _world_points(jsdf)
    for got, want in zip(query.distance_to_boundary(sdf, torch.as_tensor(wp)),
                         jquery.distance_to_boundary(jsdf, jnp.asarray(wp))):
        _same(got, want)


def test_distance_to_boundary_first_axis_at_ties():
    """|displacement| ties between axes: the first axis wins (``jnp.argmin``
    and ``torch.argmin`` both take the first minimum). x is 0.25 outside
    and y 0.25 inside the volume, so the first axis gives -0.25, the last
    +0.25."""
    jmeta = JaxGridMeta.create(jax_origin([0.0, 0.0, 0.0]), 0.5, (8, 8, 8))
    jsdf = JaxSdfGrid.create(jnp.zeros((8, 8, 8)), jmeta, OOB)
    sdf = convert.sdf_grid_from_numpy(np.zeros((8, 8, 8), np.float32), _port_meta(jmeta), OOB)
    pts = np.array([[-0.25, 0.25, 1.5], [0.25, 0.25, 0.25], [1.0, 4.25, -0.25], [3.75, 1.0, 0.25]], np.float32)
    got, inside = query.distance_to_boundary(sdf, torch.as_tensor(pts))
    np.testing.assert_array_equal(got.numpy(), [-0.25, 0.25, -0.25, 0.25])
    np.testing.assert_array_equal(inside.numpy(), [False, True, False, True])
    want, want_inside = jquery.distance_to_boundary(jsdf, jnp.asarray(pts))
    _same(got, want)
    _same(inside, want_inside)


def test_project_into_valid_volume_matches_jax(grids):
    jsdf, sdf, _ = grids
    wp = _world_points(jsdf)
    for md in (0.0, 0.05):
        _same(query.project_into_valid_volume(sdf, torch.as_tensor(wp), md),
              jquery.project_into_valid_volume(jsdf, jnp.asarray(wp), md))


def _collision_points(jsdf, mask, seed=3):
    """Points in filled cells (jittered about their centers) and some
    outside the volume."""
    rng = np.random.default_rng(seed)
    cells = np.argwhere(mask)
    cells = cells[rng.choice(len(cells), 400, replace=False)].astype(np.int32)
    inside = np.asarray(jsdf.meta.index_to_location(jnp.asarray(cells)))
    inside = inside + rng.uniform(-0.4, 0.4, inside.shape) * RES
    return np.concatenate([inside, _world_points(jsdf, 100, seed)]).astype(np.float32)


@pytest.mark.parametrize("max_steps", [1000, 37, 5])
def test_project_out_of_collision_matches_jax(grids, max_steps):
    jsdf, sdf, mask = grids
    pts = _collision_points(jsdf, mask)
    got, ok, diag = query.project_out_of_collision(sdf, torch.as_tensor(pts), MIN_DIST, max_steps=max_steps, diag=True)
    want, want_ok = jquery.project_out_of_collision(jsdf, jnp.asarray(pts), MIN_DIST, max_steps=max_steps)
    want, want_ok = np.asarray(want), np.asarray(want_ok)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=PROJECT_ATOL)
    d_got = query.estimate_distance(sdf, got)[0].numpy()
    d_want = np.asarray(jquery.estimate_distance(jsdf, jnp.asarray(want))[0])
    np.testing.assert_allclose(d_got, d_want, rtol=0, atol=PROJECT_ATOL)
    clear = np.abs(d_want - MIN_DIST) > PROJECT_ATOL
    np.testing.assert_array_equal(ok.numpy()[clear], want_ok[clear])
    assert diag["steps"] <= max_steps
    assert diag["host_checks"] == -(-diag["steps"] // query.PROJECT_CHECK_EVERY) + (diag["steps"] < max_steps)
    if max_steps == 1000:
        assert ok.float().mean() > 0.95 and (d_got[ok.numpy()] > MIN_DIST).all()
    else:
        assert diag["steps"] == max_steps and not ok.all()  # too few steps: exactly max_steps run


def test_project_out_of_collision_check_interval_changes_nothing(grids, monkeypatch):
    """Checking for active points after every step (the JAX loop's order)
    and every PROJECT_CHECK_EVERY steps give the same points bit for bit."""
    jsdf, sdf, mask = grids
    pts = torch.as_tensor(_collision_points(jsdf, mask, seed=4))
    got = query.project_out_of_collision(sdf, pts, MIN_DIST, diag=True)
    monkeypatch.setattr(query, "PROJECT_CHECK_EVERY", 1)
    each = query.project_out_of_collision(sdf, pts, MIN_DIST, diag=True)
    _same(got[0], each[0].numpy())
    _same(got[1], each[1].numpy())
    assert each[2]["steps"] <= got[2]["steps"] < each[2]["steps"] + 16
    assert each[2]["host_checks"] == each[2]["steps"] + 1


def test_project_out_of_collision_steps_below_float32_spacing():
    """A disk of radius 100 cells on a 512 x 512 x 1 grid (res 0.05): grid
    coordinates reach 25.6 m, where float32 values lie 1.9e-6 apart, and
    the margin above ``minimum_distance`` is res / 8 * 1e-4 = 6.25e-7. The
    last steps of many points move no coordinate, and the JAX loop repeats
    them until ``max_steps``: it fails on about a fifth of the points, each
    stopped within 1e-6 of ``minimum_distance``. The port takes the
    smallest step that moves such a point instead and succeeds on all of
    them, every one within 1e-5 of JAX's point."""
    n = 512
    ii = np.arange(n)
    mask = (((ii[:, None] - 300.3) ** 2 + (ii[None, :] - 310.7) ** 2) <= 100.0 ** 2)[:, :, None]
    values = edt.signed_field_from_masks(torch.as_tensor(mask), RES / 2, "plain")[0].numpy()
    jmeta = JaxGridMeta.create(jax_origin([0.0, 0.0, 0.0]), RES / 2, mask.shape)
    jsdf = JaxSdfGrid.create(jnp.asarray(values), jmeta, OOB)
    sdf = convert.sdf_grid_from_numpy(values, _port_meta(jmeta), OOB)
    rng = np.random.default_rng(3)
    cells = np.argwhere(mask)
    cells = cells[rng.choice(len(cells), 300, replace=False)]
    pts = ((cells + 0.5 + rng.uniform(-0.4, 0.4, cells.shape)) * RES / 2).astype(np.float32)
    got, ok = query.project_out_of_collision(sdf, torch.as_tensor(pts), RES / 2)
    want, want_ok = jquery.project_out_of_collision(jsdf, jnp.asarray(pts), RES / 2)
    want, want_ok = np.asarray(want), np.asarray(want_ok)
    assert ok.all() and (query.estimate_distance(sdf, got)[0] > RES / 2).all()
    assert 0.1 < 1 - want_ok.mean() < 0.4
    d_want = np.asarray(jquery.estimate_distance(jsdf, jnp.asarray(want))[0])
    assert ((d_want[~want_ok] > RES / 2 - 1e-6) & (d_want[~want_ok] <= RES / 2)).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=PROJECT_ATOL)
