"""The port's training-path pieces against the JAX package, on the CPU:
kernels K6 (winner envelope) and K7 (winner segment sum) through their
plain versions, the feature transform, the occupancy-gradient surrogates
and the soft voxelizer.

Tolerances:
  * K7 plain vs the Pallas kernels (interpret mode): bitwise. Both add each
    output's contributions in ascending i from 0.0.
  * K6 plain vs the Pallas kernel: d^2 bitwise; winners and carried
    payloads equal wherever the minimum is unique (numpy brute force);
    elsewhere each winner is a witness, f[w] + (i-w)^2 == out[i]. The TPU
    relaxation's winner at a tie is neither the first nor the last
    minimiser, and any minimiser is a correct feature.
  * Feature transform: d^2 bitwise, features as witnesses.
  * FT routing given JAX's own winner maps: bitwise.
  * FT gradient end to end: total routed mass within rtol 1e-4, and the
    gradient within the tolerance of the JAX package's own
    test_ft_backward_pallas_matches_scatter (rtol 1e-4, atol 2e-2) on its
    scene; FT forward values bitwise equal to the K1-K3 field.
  * Straight-through gradients: rtol 1e-6. Soft voxelizer: values within
    rtol=atol=1e-6, point gradients within rtol=atol=1e-5.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from sdf_tools_tpu.grid import GridMeta as JaxGridMeta, make_origin_transform as jax_origin
from sdf_tools_tpu.ops import diff as jdiff, edt as jedt, edt_pallas, feature as jfeature, voxelize as jvoxelize
from sdf_tools_tpu_torch import convert
from sdf_tools_tpu_torch.ops import diff, edt, edt_cuda, feature, voxelize

RES = 0.1


def _bits(x):
    return np.ascontiguousarray(x).view(np.uint32)


# ---- K7 ---------------------------------------------------------------------

# tests/test_diff.py's six cases: the windowed TPU body needs n % 64 == 0 and
# n > 64 (axis lengths 128, 128, 128, 256), the simple body takes the others
SEGSUM_CASES = [((6, 8, 128), 2), ((16, 24, 32), 1), ((12, 10, 8), 0),
                ((128, 8, 128), 0), ((4, 128, 16), 1), ((6, 8, 256), 2)]


@pytest.mark.parametrize("monotone", [True, False], ids=["monotone", "random"])
@pytest.mark.parametrize("shape,axis", SEGSUM_CASES, ids=[f"{'x'.join(map(str, s))}-axis{a}" for s, a in SEGSUM_CASES])
def test_winner_segment_sum_plain_matches_pallas(shape, axis, monotone):
    rng = np.random.default_rng(sum(shape) + axis)
    n = shape[axis]
    g = rng.standard_normal(shape).astype(np.float32)
    win = rng.integers(0, n, shape)
    if monotone:
        win = np.sort(win, axis=axis)
    win = win.astype(np.int32)
    want = edt_pallas.winner_segment_sum_pallas(jnp.asarray(g), jnp.asarray(win), axis, interpret=True)
    for dtype in (torch.int32, torch.int16):
        got = edt_cuda.winner_segment_sum_plain(torch.tensor(g), torch.tensor(win).to(dtype), axis)
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_winner_segment_sum_edge_cases():
    """Out-of-range winners add nowhere; an axis of length 1 returns g (as
    the TPU wrapper does); signed zeros sum as from 0.0."""
    g = torch.tensor([[[1.0, -0.0, 2.0, 4.0]]]).reshape(1, 1, 4)
    win = torch.tensor([[[3, 0, -1, 7]]], dtype=torch.int32)
    out = edt_cuda.winner_segment_sum_plain(g, win, 2)
    assert out.flatten().tolist() == [0.0, 0.0, 0.0, 1.0]
    assert not torch.signbit(out).any()
    g1 = torch.tensor([[[-0.0]], [[3.0]]])
    out1 = edt_cuda.winner_segment_sum_plain(g1, torch.full((2, 1, 1), 5, dtype=torch.int32), 1)
    assert torch.equal(out1.view(torch.int32), g1.view(torch.int32))


# ---- K6 ---------------------------------------------------------------------


def _line_d2(mask):
    f, _ = edt.line_seed_d2(torch.as_tensor(mask), 0)
    return f.numpy()


def _ties(f, axis):
    """(min, ties [..., i, j]) along ``axis`` by numpy brute force, in the
    layout with ``axis`` moved last."""
    fm = np.moveaxis(f, axis, -1).astype(np.int64)
    i = np.arange(fm.shape[-1])
    cand = fm[..., None, :] + (i[:, None] - i[None, :]) ** 2
    best = cand.min(-1)
    return best, cand == best[..., None]


def _check_winners(f, axis, out, win, want_out, want_win):
    """d^2 bitwise vs JAX and the brute minimum; winners equal to JAX's
    where the minimum is unique; every winner (the port's and JAX's) a
    witness; the port's winner the first minimiser. Returns (share of cells
    with a tied minimum, share of those where JAX's winner is the first
    minimiser, share where it is the last)."""
    np.testing.assert_array_equal(out, want_out)
    best, ties = _ties(f, axis)
    np.testing.assert_array_equal(np.moveaxis(out, axis, -1), best)
    w = np.moveaxis(win, axis, -1)
    jw = np.moveaxis(want_win, axis, -1)
    unique = ties.sum(-1) == 1
    np.testing.assert_array_equal(w[unique], jw[unique])
    for ww in (w, jw):
        assert np.take_along_axis(ties, ww[..., None].astype(np.int64), -1).all()
    first = ties.argmax(-1)
    last = ties.shape[-1] - 1 - ties[..., ::-1].argmax(-1)
    np.testing.assert_array_equal(w, first)
    tied = ~unique
    return tied.mean(), (jw == first)[tied].mean(), (jw == last)[tied].mean()


def _envelope_case(shape, fill, axis):
    """(line d^2 input, JAX (out, win), port (out, win)) of one case."""
    mask = np.random.default_rng(sum(shape) + int(fill * 10)).random(shape) < fill
    mask[:, :, 5] = False  # seedless axis-1 lines
    mask[:, 2, :] = False  # seedless axis-2 lines
    f = _line_d2(mask)
    jout, jwin = edt_pallas.envelope_argmin_pallas(jnp.asarray(f), axis, interpret=True)
    out, win = edt_cuda.envelope_argmin_plain(torch.tensor(f), axis)
    return f, (np.asarray(jout), np.asarray(jwin)), (out, win)


ENVELOPE_CASES = [((4, 16, 32), 0.1), ((4, 16, 32), 0.3), ((4, 32, 16), 0.1), ((4, 32, 16), 0.3)]


@pytest.mark.parametrize("axis", [1, 2])
@pytest.mark.parametrize("shape,fill", ENVELOPE_CASES, ids=[f"{'x'.join(map(str, s))}-{p}" for s, p in ENVELOPE_CASES])
def test_envelope_argmin_plain_matches_pallas(shape, fill, axis):
    f, (jout, jwin), (out, win) = _envelope_case(shape, fill, axis)
    tied, _, _ = _check_winners(f, axis, out.numpy(), win.numpy(), jout, jwin)
    assert tied > 0.0  # the inputs do exercise ties
    seedless = (0, slice(None), 5) if axis == 1 else (0, 2, slice(None))
    assert (out[seedless] == edt.INF_D2).all()
    assert torch.equal(win[seedless], torch.arange(shape[axis], dtype=torch.int32))


@pytest.mark.parametrize("shape,axis", [((4, 1, 16), 1), ((4, 16, 1), 2)])
def test_envelope_argmin_plain_axis_of_length_one(shape, axis):
    f = _line_d2(np.random.default_rng(1).random(shape) < 0.3)
    jout, jwin = edt_pallas.envelope_argmin_pallas(jnp.asarray(f), axis, interpret=True)
    out, win = edt_cuda.envelope_argmin_plain(torch.tensor(f), axis)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(win.numpy(), np.asarray(jwin))
    jcarried = edt_pallas.envelope_carry_pallas(jnp.asarray(f), (jnp.asarray(f + 3),), axis, interpret=True)
    carried = edt_cuda.envelope_carry_plain(torch.tensor(f), (torch.tensor(f + 3),), axis)
    for got, want in zip(carried, jcarried):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("axis", [1, 2])
def test_envelope_carry_plain_matches_pallas(axis):
    """Two payloads carried along the second pass of a real chain (the
    axis-1 envelope feeds axis 2): carried values equal JAX's where the
    minimum is unique; at ties each side carries the payload of one of
    its minimisers."""
    rng = np.random.default_rng(40 + axis)
    shape = (4, 24, 32)
    f = _line_d2(rng.random(shape) < 0.15)
    if axis == 2:
        f = edt_cuda.envelope_argmin_plain(torch.tensor(f), 1)[0].numpy()
    pays = [rng.integers(-1000, 1000, shape).astype(np.int32) for _ in range(2)]
    jouts = edt_pallas.envelope_carry_pallas(jnp.asarray(f), tuple(map(jnp.asarray, pays)), axis, interpret=True)
    outs = edt_cuda.envelope_carry_plain(torch.tensor(f), tuple(map(torch.tensor, pays)), axis)
    np.testing.assert_array_equal(outs[0].numpy(), np.asarray(jouts[0]))
    _, ties = _ties(f, axis)
    unique = ties.sum(-1) == 1
    _, win = edt_cuda.envelope_argmin_plain(torch.tensor(f), axis)
    w = np.moveaxis(win.numpy(), axis, -1).astype(np.int64)
    for p, got, want in zip(pays, outs[1:], jouts[1:]):
        pm = np.moveaxis(p, axis, -1)
        g = np.moveaxis(got.numpy(), axis, -1)
        jg = np.moveaxis(np.asarray(want), axis, -1)
        np.testing.assert_array_equal(g, np.take_along_axis(pm, w, -1))
        np.testing.assert_array_equal(g[unique], jg[unique])
        # JAX's carried value at a tie is the payload of some minimiser
        options = np.where(ties, pm[..., None, :], np.iinfo(np.int64).min)
        assert (options == jg[..., None]).any(-1).all()


# ---- feature transform ------------------------------------------------------


@pytest.mark.parametrize("shape,fill", [((16, 24, 32), 0.05), ((8, 16, 64), 0.25), ((9, 7, 11), 0.02)])
def test_feature_transform_matches_pallas(shape, fill):
    mask = np.random.default_rng(11).random(shape) < fill
    mask[0, 0, 0] = True
    jd2, jfeat = jfeature.feature_transform(jnp.asarray(mask), backend="pallas")
    for backend in ("auto", "plain"):
        d2, feat = feature.feature_transform(torch.as_tensor(mask), backend)
        np.testing.assert_array_equal(d2.numpy(), np.asarray(jd2))
        fp = feat.numpy()
        assert mask[fp[..., 0], fp[..., 1], fp[..., 2]].all()
        ix, iy, iz = np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")
        dist = (ix - fp[..., 0]) ** 2 + (iy - fp[..., 1]) ** 2 + (iz - fp[..., 2]) ** 2
        np.testing.assert_array_equal(dist, np.asarray(jd2))


def test_feature_transform_seedless_and_bad_backend():
    """A seedless volume: INF_D2 everywhere and, as JAX's pallas branch
    gives, feature (0, y, z) (every seedless line's winner is the cell)."""
    mask = np.zeros((5, 6, 7), bool)
    jd2, jfeat = jfeature.feature_transform(jnp.asarray(mask), backend="pallas")
    d2, feat = feature.feature_transform(torch.as_tensor(mask))
    assert (d2 == edt.INF_D2).all()
    np.testing.assert_array_equal(feat.numpy(), np.asarray(jfeat))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        feature.feature_transform(torch.zeros((5, 6, 7), dtype=torch.bool), "stencil")


def test_line_seed_matches_jax():
    """The x-line seed (JAX's feature._line_seed_x) and the squared line
    distance of the FT forward (JAX's _per_axis_argmin_ft)."""
    mask = np.random.default_rng(2).random((17, 6, 5)) < 0.2
    mask[:, 1, 1] = False
    jd, jx0 = jfeature._line_seed_x(jnp.asarray(mask))
    d2, x0 = edt.line_seed_d2(torch.as_tensor(mask), 0)
    jd = np.asarray(jd)
    np.testing.assert_array_equal(d2.numpy(), np.where(jd >= 1 << 24, edt.INF_D2, jd * jd))
    np.testing.assert_array_equal(x0.numpy(), np.asarray(jx0))


# ---- FT surrogate -----------------------------------------------------------


def _jax_ft_residuals(mask):
    d2_f, x0_f, jy_f, kz_f = jdiff._per_axis_argmin_ft(jnp.asarray(mask))
    d2_g, x0_g, jy_g, kz_g = jdiff._per_axis_argmin_ft(jnp.asarray(~mask))
    winners = tuple(tuple(np.asarray(w).astype(np.int16) for w in ws) for ws in ((x0_f, jy_f, kz_f), (x0_g, jy_g, kz_g)))
    valids = (np.asarray(d2_f) < edt.INF_D2, np.asarray(d2_g) < edt.INF_D2)
    return winners, valids


@pytest.mark.parametrize("shape,fill", [((10, 14, 8), 0.2), ((12, 12, 12), 0.05)])
def test_ft_routing_bitwise_given_jax_winners(shape, fill):
    """Given the JAX forward's own winner maps, the port's backward (K7's
    plain version three times per field) equals JAX's _ft_bwd bit for bit."""
    rng = np.random.default_rng(19)
    mask = rng.random(shape) < fill
    g = rng.standard_normal(shape).astype(np.float32)
    winners, valids = _jax_ft_residuals(mask)
    jres = (jnp.asarray(mask), tuple(tuple(map(jnp.asarray, ws)) for ws in winners),
            tuple(map(jnp.asarray, valids)), jnp.asarray(RES, jnp.float32))
    want, _ = jdiff._ft_bwd("pallas", jres, jnp.asarray(g))
    t = lambda ws: tuple(torch.tensor(w) for w in ws)  # noqa: E731
    got = diff.ft_backward(
        torch.tensor(g), torch.tensor(mask), (t(winners[0]), t(winners[1])),
        tuple(map(torch.tensor, valids)), RES, "plain",
    )
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def _jax_grad(fn, occ, cot):
    return np.asarray(jax.grad(lambda o: jnp.sum(fn(o, jnp.float32(RES), "pallas") * cot))(jnp.asarray(occ)))


def _port_grad(fn, occ, cot, backend="auto"):
    o = torch.tensor(occ, requires_grad=True)
    values = fn(o, RES, backend)
    (values * torch.tensor(cot)).sum().backward()
    return values.detach(), o.grad.numpy()


def _tied_features(mask, chunk=512):
    """Cells whose nearest opposite-side cell is not unique (numpy brute
    force, in chunks of cells): only there may the port route a cotangent
    elsewhere than JAX."""
    cells = np.argwhere(np.ones(mask.shape, bool))
    flat = mask.reshape(-1)
    tied = np.empty(flat.shape, bool)
    for s in range(0, len(cells), chunk):
        d2 = ((cells[s : s + chunk, None, :] - cells[None, :, :]) ** 2).sum(-1)
        d2 = np.where(flat[None, :] != flat[s : s + chunk, None], d2, np.iinfo(np.int64).max)
        tied[s : s + chunk] = (d2 == d2.min(-1, keepdims=True)).sum(-1) > 1
    return tied.reshape(mask.shape)


@pytest.mark.parametrize("scene", ["isolated", "random"])
def test_ft_gradient_matches_jax(scene):
    """"isolated": tests/test_diff.py::test_ft_backward_pallas_matches_scatter's
    scene and tolerance. With the cotangent zero on cells with tied
    features, the port's gradient equals JAX's (allclose at that tolerance,
    and in fact bitwise: the routes are the same); with the full cotangent
    the total routed mass is the same."""
    n = 12
    rng = np.random.default_rng(7)
    if scene == "isolated":
        occ = np.zeros((n, n, n), np.float32)
        occ[5, 5, 5] = 1.0
        occ[1, 2, 9] = 1.0
    else:
        occ = (rng.random((n, n, n)) < 0.1).astype(np.float32) * 0.9 + 0.05
    cot = rng.standard_normal((n, n, n)).astype(np.float32)
    tied = _tied_features(occ > 0.5)
    assert 0 < tied.sum() < tied.size
    cot_unique = np.where(tied, 0.0, cot).astype(np.float32)
    want = _jax_grad(jdiff.sdf_from_occupancy_ft, occ, cot)
    want_unique = _jax_grad(jdiff.sdf_from_occupancy_ft, occ, cot_unique)
    for backend in ("auto", "plain"):
        _, got = _port_grad(diff.sdf_from_occupancy_ft, occ, cot, backend)
        np.testing.assert_allclose(got.sum(), want.sum(), rtol=1e-4)
        _, got_unique = _port_grad(diff.sdf_from_occupancy_ft, occ, cot_unique, backend)
        np.testing.assert_allclose(got_unique, want_unique, rtol=1e-4, atol=2e-2)
        np.testing.assert_array_equal(_bits(got_unique), _bits(want_unique))


def test_ft_gradient_mass_and_forward_on_random_scene():
    rng = np.random.default_rng(19)
    occ = (rng.random((10, 14, 8)) < 0.2).astype(np.float32) * 0.9 + 0.05
    cot = rng.standard_normal(occ.shape).astype(np.float32)
    want = _jax_grad(jdiff.sdf_from_occupancy_ft, occ, cot)
    values, got = _port_grad(diff.sdf_from_occupancy_ft, occ, cot)
    np.testing.assert_allclose(got.sum(), want.sum(), rtol=1e-4)
    # every valid cotangent is routed exactly once (both fields have seeds)
    np.testing.assert_allclose(got.sum(), -2 * RES * cot.astype(np.float64).sum(), rtol=1e-4)
    field, _, _ = edt.signed_field_from_masks(torch.tensor(occ > 0.5), RES)
    assert torch.equal(values.view(torch.int32), field.view(torch.int32))
    jvalues = jdiff.sdf_from_occupancy_ft(jnp.asarray(occ), jnp.float32(RES), "pallas")
    np.testing.assert_array_equal(_bits(values.numpy()), _bits(jvalues))


def test_st_gradients_match_jax():
    rng = np.random.default_rng(3)
    occ = (rng.random((8, 9, 10)) < 0.3).astype(np.float32)
    cot = rng.standard_normal(occ.shape).astype(np.float32)
    want = _jax_grad(jdiff.sdf_from_occupancy_st, occ, cot)
    values, got = _port_grad(diff.sdf_from_occupancy_st, occ, cot)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    ft_values, _ = _port_grad(diff.sdf_from_occupancy_ft, occ, cot)
    assert torch.equal(values.view(torch.int32), ft_values.view(torch.int32))

    fwd = lambda o: edt.signed_field_from_masks(o > 0.5, RES)[0]  # noqa: E731
    jfwd = lambda o: jedt.signed_field_from_masks(o > 0.5, RES, "pallas")[0]  # noqa: E731
    jst = jdiff.straight_through_sdf(jfwd, RES)
    want = np.asarray(jax.grad(lambda o: jnp.sum(jst(o) * cot))(jnp.asarray(occ)))
    o = torch.tensor(occ, requires_grad=True)
    out = diff.straight_through_sdf(fwd, RES)(o)
    assert torch.equal(out.detach(), fwd(torch.tensor(occ)))
    (out * torch.tensor(cot)).sum().backward()
    np.testing.assert_allclose(o.grad.numpy(), want, rtol=1e-6)


@pytest.mark.parametrize("fn", [diff.sdf_from_occupancy_st, diff.sdf_from_occupancy_ft], ids=["st", "ft"])
def test_surrogates_reject_unported_backends(fn):
    """"pallas" names the TPU kernels and raises for both surrogates; the
    FT's winner envelope exists only for "auto" and "plain" (the ST runs
    any ported EDT backend)."""
    with pytest.raises(NotImplementedError, match="'auto'"):
        fn(torch.zeros((4, 4, 4)), RES, "pallas")
    if fn is diff.sdf_from_occupancy_ft:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            fn(torch.zeros((4, 4, 4)), RES, "stencil")


# ---- soft voxelizer ---------------------------------------------------------


def test_soft_voxelize_points_matches_jax():
    jmeta = JaxGridMeta.create(jax_origin([0.1, -0.2, 0.05]), 0.05, (12, 10, 14))
    meta = convert.grid_meta_from_numpy(
        np.asarray(jmeta.origin_transform), np.asarray(jmeta.inv_origin_transform),
        np.asarray(jmeta.resolution), jmeta.shape, device="cpu",
    )
    rng = np.random.default_rng(5)
    # some points beyond the grid, whose corners are partly out of bounds
    pts = (rng.uniform(-0.1, 0.75, (300, 3)) + np.array([0.1, -0.2, 0.05])).astype(np.float32)
    cot = rng.standard_normal(jmeta.shape).astype(np.float32)
    f = lambda p: jnp.sum(jvoxelize.soft_voxelize_points(p, jmeta, 0.5) * cot)  # noqa: E731
    want = np.asarray(jvoxelize.soft_voxelize_points(jnp.asarray(pts), jmeta, 0.5))
    want_grad = np.asarray(jax.grad(f)(jnp.asarray(pts)))
    p = torch.tensor(pts, requires_grad=True)
    occ = voxelize.soft_voxelize_points(p, meta, 0.5)
    (occ * torch.tensor(cot)).sum().backward()
    assert 0.0 < occ.max() < 1.0
    np.testing.assert_allclose(occ.detach().numpy(), want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(p.grad.numpy(), want_grad, rtol=1e-5, atol=1e-5)


if __name__ == "__main__":
    # How the TPU kernel breaks ties, on the K6 test cases (CPU, interpret mode):
    #   JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_diff.py
    for (shape, fill), axis in [(c, a) for c in ENVELOPE_CASES for a in (1, 2)]:
        f, (jout, jwin), (out, win) = _envelope_case(shape, fill, axis)
        tied, first, last = _check_winners(f, axis, out.numpy(), win.numpy(), jout, jwin)
        print(f"shape {shape} fill {fill} axis {axis}: tied {tied:.1%} of cells; at ties JAX's winner is"
              f" the first minimiser on {first:.1%}, the last on {last:.1%}")
