"""Float-to-int casts of non-finite and out-of-range coordinates, against the
JAX package on the CPU.

Every float-to-int cast of the port goes through ``grid.float_to_int32``
(``floor_to_int32`` after a floor), which follows XLA's ``convert``:
truncation, saturated to the int32 limits, NaN -> 0. Held bitwise against
``jnp.astype(jnp.int32)`` and, through ``location_to_index``, against the
JAX package's grid.

Non-finite points are out of bounds in the port everywhere: in
``location_in_bounds``, ``get_value_by_location``, the trilinear stencil
(``estimate_distance``, ``smooth_gradient``), ``voxelize_points`` and
``soft_voxelize_points``, and a ray with a non-finite origin misses in the
march. The JAX package maps a NaN point to cell 0 and calls it in bounds:
that is its fault, pinned here beside the port's answer. For +-inf, +-1e30
and 3e9 the two agree bitwise (out of bounds, the oob value).
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from sdf_tools_tpu.grid import GridMeta as JaxGridMeta, SdfGrid as JaxSdfGrid, make_origin_transform as jax_origin
from sdf_tools_tpu.ops import query as jquery, voxelize as jvoxelize
from sdf_tools_tpu_torch import convert, grid
from sdf_tools_tpu_torch.ops import query, render, voxelize
from test_torch_query import OOB, RES, SHAPE, _values
from test_torch_render import _port_meta

NAN, INF = float("nan"), float("inf")
# one bad coordinate per point, the others in the grid: (x, 1, 1) etc.
BAD = (NAN, INF, -INF, 1e30, -1e30, 3e9, -3e9)


def _bad_points():
    pts = []
    for v in BAD:
        for ax in range(3):
            p = [1.0, 1.0, 0.8]
            p[ax] = v
            pts.append(p)
    pts.append([1.0, 1.0, 0.8])  # one good point
    return np.asarray(pts, np.float32)


def _nan_rows(pts):
    return np.isnan(pts).any(-1)


@pytest.fixture(scope="module")
def grids():
    _, values = _values()
    jmeta = JaxGridMeta.create(jax_origin([0.0, 0.0, 0.0]), RES, SHAPE)
    jsdf = JaxSdfGrid.create(jnp.asarray(values), jmeta, OOB)
    return jsdf, convert.sdf_grid_from_numpy(values, _port_meta(jmeta), OOB)


def test_float_to_int32_is_xla_convert():
    x = np.array([NAN, INF, -INF, 1e30, -1e30, 3e9, -3e9, 2147483520.0, 2147483648.0, -2147483648.0,
                  -0.5, 0.5, 2.7, -2.7, -1.0, 0.0, -0.0, 1e-30], np.float32)
    got = grid.float_to_int32(torch.as_tensor(x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jnp.asarray(x).astype(jnp.int32)))
    floor = grid.floor_to_int32(torch.as_tensor(x))
    np.testing.assert_array_equal(floor.numpy(), np.asarray(jnp.floor(jnp.asarray(x)).astype(jnp.int32)))
    # float64 saturates at the same limits and keeps values near 2^31 exact
    x64 = torch.tensor([NAN, INF, -INF, 2147483647.5, -2147483648.5, 2147483646.0], dtype=torch.float64)
    assert grid.float_to_int32(x64).tolist() == [0, 2147483647, -2147483648, 2147483647, -2147483648, 2147483646]


def test_location_to_index_matches_jax(grids):
    jsdf, sdf = grids
    pts = _bad_points()
    got = sdf.meta.location_to_index(torch.as_tensor(pts)).numpy()
    want = np.asarray(jsdf.meta.location_to_index(jnp.asarray(pts)))
    np.testing.assert_array_equal(got, want)
    # XLA's numbers: NaN -> 0 (a NaN or inf coordinate makes every grid
    # coordinate NaN through the rotation's zero entries), +inf / 1e30 /
    # 3e9 -> 2^31 - 1, the negatives -> -2^31
    assert (got[_nan_rows(pts)] == 0).all() and (got[3:6][~np.eye(3, dtype=bool)] == 0).all()
    assert got[3, 0] == got[9, 0] == got[15, 0] == 2147483647
    assert got[6, 0] == got[12, 0] == got[18, 0] == -2147483648


def _check_pinned(got_ok, want_ok, pts):
    """The port: only the good point is in bounds. JAX: the NaN points too
    (its fault); every other point agrees."""
    nan = _nan_rows(pts)
    assert not got_ok[:-1].any() and got_ok[-1]
    assert want_ok[nan].all()
    np.testing.assert_array_equal(got_ok[~nan], want_ok[~nan])


def test_location_in_bounds_non_finite(grids):
    jsdf, sdf = grids
    pts = _bad_points()
    got = sdf.meta.location_in_bounds(torch.as_tensor(pts)).numpy()
    _check_pinned(got, np.asarray(jsdf.meta.location_in_bounds(jnp.asarray(pts))), pts)


def _u32(x):
    return np.asarray(x, np.float32).view(np.uint32)


def test_get_value_by_location_non_finite(grids):
    jsdf, sdf = grids
    pts = _bad_points()
    v, ok = sdf.get_value_by_location(torch.as_tensor(pts))
    jv, jok = jsdf.get_value_by_location(jnp.asarray(pts))
    v, ok, jv, jok = v.numpy(), ok.numpy(), np.asarray(jv), np.asarray(jok)
    _check_pinned(ok, jok, pts)
    nan = _nan_rows(pts)
    assert (v[:-1] == OOB).all()
    # JAX reads the NaN point's cell [0, 0, 0]
    assert (jv[nan] == sdf.values[0, 0, 0].item()).all()
    np.testing.assert_array_equal(_u32(v[~nan]), _u32(jv[~nan]))


@pytest.mark.parametrize("fn", ["estimate_distance", "smooth_gradient"])
def test_queries_non_finite(grids, fn):
    jsdf, sdf = grids
    pts = _bad_points()
    if fn == "estimate_distance":
        v, ok = query.estimate_distance(sdf, torch.as_tensor(pts))
        jv, jok = jquery.estimate_distance(jsdf, jnp.asarray(pts))
    else:
        v, ok = query.smooth_gradient(sdf, torch.as_tensor(pts), RES)
        jv, jok = jquery.smooth_gradient(jsdf, jnp.asarray(pts), RES)
    v, ok, jv, jok = v.numpy(), ok.numpy(), np.asarray(jv), np.asarray(jok)
    _check_pinned(ok, jok, pts)
    nan = _nan_rows(pts)
    # JAX answers NaN, valid, at a NaN point; the port the oob value / zeros
    assert np.isnan(jv[nan]).all()
    assert np.isfinite(v).all()
    np.testing.assert_array_equal(_u32(v[~nan]), _u32(jv[~nan]))


def test_interpolation_stencil_non_finite(grids):
    jsdf, sdf = grids
    pts = _bad_points()
    *_, ok = query.interpolation_stencil(sdf, torch.as_tensor(pts))
    *_, jok = jquery.interpolation_stencil(jsdf, jnp.asarray(pts))
    _check_pinned(ok.numpy(), np.asarray(jok), pts)


def test_voxelize_points_non_finite(grids):
    jsdf, sdf = grids
    pts = _bad_points()
    got = voxelize.voxelize_points(torch.as_tensor(pts), sdf.meta).numpy()
    want = np.asarray(jvoxelize.voxelize_points(jnp.asarray(pts), jsdf.meta))
    cell = tuple(sdf.meta.location_to_index(torch.as_tensor(pts[-1])).tolist())
    assert got.sum() == 1 and got[cell] == 1
    # JAX fills the NaN points' cell [0, 0, 0] (and [-1, -1, -1] for the
    # out-of-bounds ones, tests/test_torch_render.py)
    assert want[0, 0, 0] == 1 and want[cell] == 1
    assert want.sum() > got.sum()


def test_soft_voxelize_points_non_finite(grids):
    jsdf, sdf = grids
    pts = _bad_points()
    got = voxelize.soft_voxelize_points(torch.as_tensor(pts), sdf.meta).numpy()
    good = voxelize.soft_voxelize_points(torch.as_tensor(pts[-1:]), sdf.meta).numpy()
    want = np.asarray(jvoxelize.soft_voxelize_points(jnp.asarray(pts), jsdf.meta))
    np.testing.assert_array_equal(_u32(got), _u32(good))
    assert np.isnan(want).any()  # JAX deposits the NaN point's NaN weights


def test_march_non_finite_rays_miss(grids):
    _, sdf = grids
    o = torch.as_tensor(_bad_points())
    v = torch.zeros_like(o)
    v[:, 2] = 1.0
    o[:, 2] = -0.5
    depth, hit, steps = render._trace_depth(sdf, o, v, 0.0, 5.0, 1e-3, 32, None)
    bad = ~torch.isfinite(o).all(-1)
    assert not hit[bad].any() and (depth[bad] == 5.0).all() and (steps[bad] == 0).all()
    # the finite rays answer as they do alone
    good = ~bad
    d1, h1, s1 = render._trace_depth(sdf, o[good], v[good], 0.0, 5.0, 1e-3, 32, None)
    assert torch.equal(depth[good], d1) and torch.equal(hit[good], h1) and torch.equal(steps[good], s1)
