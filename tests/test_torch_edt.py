"""The port's signed-field chain (sdf_tools_tpu_torch.ops.edt / edt_cuda)
against the JAX package, on the CPU.

The three kernels' plain PyTorch versions are held against the Pallas
kernels they replace, run in interpret mode, and the signed field against
JAX ``backend="pallas"``. Tolerance everywhere: bitwise (int32 fields equal;
f32 fields compared as uint32 bit patterns). On the CPU the wrappers run the
plain versions; the CUDA kernels themselves are held against the same plain
versions on the card by ``chip_smoke.py``.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from bench import make_scene
from sdf_tools_tpu.grid import GridMeta as JaxGridMeta, make_origin_transform as jax_origin
from sdf_tools_tpu.ops import edt as jedt, edt_pallas
from sdf_tools_tpu_torch import convert
from sdf_tools_tpu_torch.ops import edt, edt_cuda

RES = 0.07
# tests/test_edt.py's dual-field shapes (degenerate and odd ones included),
# plus an all-empty and an all-full mask
CASES = [
    ("random", (16, 24, 32)),
    ("random", (8, 40, 1)),
    ("random", (1, 16, 128)),
    ("random", (5, 7, 9)),
    ("random", (33, 64, 129)),
    ("empty", (16, 24, 32)),
    ("full", (16, 24, 32)),
]
CASE_IDS = [f"{kind}-{'x'.join(map(str, shape))}" for kind, shape in CASES]


def _mask(kind, shape):
    if kind == "empty":
        return np.zeros(shape, bool)
    if kind == "full":
        return np.ones(shape, bool)
    return np.random.default_rng(sum(shape)).random(shape) < 0.12


def _bits(x):
    return np.asarray(x).view(np.uint32)


def _jax_line_pass(m):
    return edt_pallas.line_pass_dual_pallas(jnp.asarray(m), interpret=True)


@pytest.mark.parametrize("kind,shape", CASES, ids=CASE_IDS)
def test_line_pass_dual_plain_matches_pallas(kind, shape):
    m = _mask(kind, shape)
    ja, jb = _jax_line_pass(m)
    pa, pb = edt_cuda.line_pass_dual_plain(torch.as_tensor(m))
    np.testing.assert_array_equal(pa.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(pb.numpy(), np.asarray(jb))


@pytest.mark.parametrize("kind,shape", CASES, ids=CASE_IDS)
def test_line_pass_dual_plain_linear_matches_pallas(kind, shape):
    """K1's linear mode: distances with the 1 << 24 sentinel (the form the
    sharded line pass combines across shards before squaring)."""
    m = _mask(kind, shape)
    ja, jb = edt_pallas.line_pass_dual_pallas(jnp.asarray(m), interpret=True, square=False)
    pa, pb = edt_cuda.line_pass_dual_plain(torch.as_tensor(m), square=False)
    np.testing.assert_array_equal(pa.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(pb.numpy(), np.asarray(jb))


@pytest.mark.parametrize("axis", [1, 2])
@pytest.mark.parametrize("kind,shape", CASES, ids=CASE_IDS)
def test_envelope_dual_plain_matches_pallas(kind, shape, axis):
    ja, jb = _jax_line_pass(_mask(kind, shape))
    ea, eb = edt_pallas.envelope_dual_pallas(ja, jb, axis, interpret=True)
    pa, pb = edt_cuda.envelope_dual_plain(torch.tensor(np.asarray(ja)), torch.tensor(np.asarray(jb)), axis)
    np.testing.assert_array_equal(pa.numpy(), np.asarray(ea))
    np.testing.assert_array_equal(pb.numpy(), np.asarray(eb))


@pytest.mark.parametrize("kind,shape", CASES, ids=CASE_IDS)
def test_envelope_dual_combine_plain_matches_pallas(kind, shape):
    ja, jb = _jax_line_pass(_mask(kind, shape))
    ja, jb = edt_pallas.envelope_dual_pallas(ja, jb, 1, interpret=True)
    want = edt_pallas.envelope_dual_combine_pallas(ja, jb, RES, interpret=True)
    got = edt_cuda.envelope_dual_combine_plain(torch.tensor(np.asarray(ja)), torch.tensor(np.asarray(jb)), RES)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_seedless_lines_are_exactly_inf():
    """Seedless columns and seedless grids give exactly INF_D2 (the JAX
    tests only assert >= INF_D2)."""
    m = np.random.default_rng(3).random((9, 6, 5)) < 0.3
    m[:, 2, 3] = False  # a column with no True seed
    m[:, 4, 1] = True  # a column with no False seed
    a, b = edt_cuda.line_pass_dual_plain(torch.as_tensor(m))
    assert (a[:, 2, 3] == edt.INF_D2).all()
    assert (b[:, 4, 1] == edt.INF_D2).all()
    a, b = edt.squared_edt_both(torch.zeros((6, 7, 8), dtype=torch.bool))
    assert (a == edt.INF_D2).all() and (b == 0).all()
    a, b = edt.squared_edt_both(torch.ones((6, 7, 8), dtype=torch.bool))
    assert (a == 0).all() and (b == edt.INF_D2).all()


@pytest.mark.parametrize("axis", [1, 2])
def test_envelope_chunks_agree(axis):
    """The plain envelope gives the same field however it chunks its lines."""
    rng = np.random.default_rng(5)
    f = rng.integers(0, 900, (7, 30, 26)).astype(np.int32)
    f[rng.random(f.shape) < 0.6] = edt.INF_D2
    f = torch.as_tensor(f)
    whole = edt.envelope_pass_brute(f, axis)
    for budget in (1, 30 * 30 * 5 + 1):
        assert torch.equal(edt.envelope_pass_brute(f, axis, max_temp_elems=budget), whole)


def test_squared_edt_both_matches_jax():
    m = np.random.default_rng(11).random((12, 9, 7)) < 0.1
    ja, jb = jedt.squared_edt_both(jnp.asarray(m), "pallas")
    pa, pb = edt.squared_edt_both(torch.as_tensor(m))
    np.testing.assert_array_equal(pa.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(pb.numpy(), np.asarray(jb))


@pytest.fixture(scope="module")
def scene64():
    return make_scene(64)


@pytest.mark.parametrize("backend", ["auto", "plain"])
def test_signed_field_matches_jax_pallas(scene64, backend):
    jd, jmx, jmn = jedt.signed_field_from_masks(jnp.asarray(scene64), 0.05, "pallas")
    d, mx, mn = edt.signed_field_from_masks(torch.as_tensor(scene64), 0.05, backend)
    np.testing.assert_array_equal(_bits(d.numpy()), _bits(jd))
    assert _bits(mx.numpy()) == _bits(jmx) and _bits(mn.numpy()) == _bits(jmn)
    filled = torch.as_tensor(scene64)
    assert (d[filled] <= -0.05).all() and (d[~filled] >= np.float32(0.05)).all()


@pytest.mark.parametrize("virtual_border", [False, True], ids=["plain-border", "virtual-border"])
def test_extract_signed_distance_field_matches_jax(scene64, virtual_border):
    jmeta = JaxGridMeta.create(jax_origin([0.1, -0.2, 0.3]), 0.05, scene64.shape)
    jsdf, (jmx, jmn) = jedt.extract_signed_distance_field(
        jnp.asarray(scene64), jmeta, oob_value=7.0, add_virtual_border=virtual_border, backend="pallas"
    )
    meta = convert.grid_meta_from_numpy(
        np.asarray(jmeta.origin_transform), np.asarray(jmeta.inv_origin_transform),
        np.asarray(jmeta.resolution), jmeta.shape, device="cpu",
    )
    sdf, (mx, mn) = edt.extract_signed_distance_field(
        torch.as_tensor(scene64), meta, oob_value=7.0, add_virtual_border=virtual_border
    )
    np.testing.assert_array_equal(_bits(sdf.values.numpy()), _bits(jsdf.values))
    assert _bits(mx.numpy()) == _bits(jmx) and _bits(mn.numpy()) == _bits(jmn)
    assert float(sdf.oob_value) == 7.0 and sdf.meta is meta


def test_wrappers_on_cpu_run_plain_and_count_no_launch():
    m = torch.as_tensor(_mask("random", (5, 7, 9)))
    before = dict(edt_cuda.LAUNCHES)
    a, b = edt_cuda.line_pass_dual(m)
    pa, pb = edt_cuda.line_pass_dual_plain(m)
    assert torch.equal(a, pa) and torch.equal(b, pb)
    a8, b8 = edt_cuda.line_pass_dual(m.to(torch.uint8))
    assert torch.equal(a8, pa) and torch.equal(b8, pb)
    la, lb = edt_cuda.line_pass_dual(m.to(torch.uint8) * 7, square=False)
    assert all(torch.equal(x, y) for x, y in zip((la, lb), edt_cuda.line_pass_dual_plain(m, square=False)))
    ea, eb = edt_cuda.envelope_dual(a, b, 1)
    assert all(torch.equal(x, y) for x, y in zip((ea, eb), edt_cuda.envelope_dual_plain(a, b, 1)))
    d = edt_cuda.envelope_dual_combine(ea, eb, RES)
    assert torch.equal(d.view(torch.int32), edt_cuda.envelope_dual_combine_plain(ea, eb, RES).view(torch.int32))
    for axis in (1, 2):
        got = edt_cuda.envelope_argmin(a, axis)
        assert all(torch.equal(x, y) for x, y in zip(got, edt_cuda.envelope_argmin_plain(a, axis)))
        pays = (b, a + 1, torch.full_like(a, 7))
        got = edt_cuda.envelope_carry(a, pays, axis)
        assert len(got) == 4
        assert all(torch.equal(x, y) for x, y in zip(got, edt_cuda.envelope_carry_plain(a, pays, axis)))
    g = torch.randn(a.shape, generator=torch.Generator().manual_seed(0))
    for axis in (0, 1, 2):
        w = ea.to(torch.int16) % a.shape[axis]
        want = edt_cuda.winner_segment_sum_plain(g, w, axis)
        assert torch.equal(edt_cuda.winner_segment_sum(g, w, axis).view(torch.int32), want.view(torch.int32))
    assert edt_cuda.LAUNCHES == before


def _bad_inputs():
    f = torch.zeros((4, 5, 6), dtype=torch.int32)
    return [
        ("line_pass_dual", lambda: edt_cuda.line_pass_dual(torch.zeros((4, 5, 6), dtype=torch.float32)), TypeError),
        ("line_pass_dual", lambda: edt_cuda.line_pass_dual(torch.zeros((4, 5), dtype=torch.bool)), ValueError),
        ("line_pass_dual", lambda: edt_cuda.line_pass_dual(torch.zeros((4, 5, 6), dtype=torch.bool).transpose(0, 2)), ValueError),
        ("line_pass_dual", lambda: edt_cuda.line_pass_dual(torch.zeros((0, 5, 6), dtype=torch.bool)), ValueError),
        ("envelope_dual", lambda: edt_cuda.envelope_dual(f, f.to(torch.int64), 1), TypeError),
        ("envelope_dual", lambda: edt_cuda.envelope_dual(f, torch.zeros((4, 5, 7), dtype=torch.int32), 1), ValueError),
        ("envelope_dual", lambda: edt_cuda.envelope_dual(f, f, 0), ValueError),
        ("envelope_dual", lambda: edt_cuda.envelope_dual(f.transpose(1, 2), f.transpose(1, 2), 1), ValueError),
        ("envelope_dual_combine", lambda: edt_cuda.envelope_dual_combine(f, f[:, :, :3], RES), ValueError),
        ("envelope_argmin", lambda: edt_cuda.envelope_argmin(f.float(), 1), TypeError),
        ("envelope_argmin", lambda: edt_cuda.envelope_argmin(f, 0), ValueError),
        ("envelope_argmin", lambda: edt_cuda.envelope_argmin(f.transpose(1, 2), 1), ValueError),
        ("envelope_carry", lambda: edt_cuda.envelope_carry(f, (f,) * 4, 1), ValueError),
        ("envelope_carry", lambda: edt_cuda.envelope_carry(f, (f[:, :, :3],), 2), ValueError),
        ("envelope_carry", lambda: edt_cuda.envelope_carry(f, (f.to(torch.int16),), 2), TypeError),
        ("winner_segment_sum", lambda: edt_cuda.winner_segment_sum(f, f, 0), TypeError),
        ("winner_segment_sum", lambda: edt_cuda.winner_segment_sum(f.float(), f.to(torch.int64), 0), TypeError),
        ("winner_segment_sum", lambda: edt_cuda.winner_segment_sum(f.float(), f[:, :, :3], 0), ValueError),
        ("winner_segment_sum", lambda: edt_cuda.winner_segment_sum(f.float(), f, 3), ValueError),
    ]


@pytest.mark.parametrize("idx", range(len(_bad_inputs())))
def test_wrappers_reject_bad_inputs(idx):
    _, call, exc = _bad_inputs()[idx]
    with pytest.raises(exc):
        call()


@pytest.mark.parametrize("backend", ["stencil", "scan", "cht", "reference", "brute", "pallas"])
def test_unported_backends_raise(backend):
    """Every JAX backend but "pallas" is ported: "pallas" (the TPU kernels)
    raises and points to "auto"; the others give the plain signed field
    ("reference" its own field from the native library, which is never
    below the exact one, or raises where the library cannot be built)."""
    from sdf_tools_tpu_torch import native

    m = torch.as_tensor(_mask("random", (5, 7, 9)))
    if backend == "pallas":
        with pytest.raises(NotImplementedError, match="'auto'"):
            edt.signed_field_from_masks(m, RES, backend)
        return
    if backend == "reference" and not native.available():
        with pytest.raises(RuntimeError, match="native"):
            edt.signed_field_from_masks(m, RES, backend)
        return
    d, _, _ = edt.signed_field_from_masks(m, RES, backend)
    want, _, _ = edt.signed_field_from_masks(m, RES, "plain")
    if backend == "reference":
        assert (d.abs() >= want.abs()).all()
    else:
        assert torch.equal(d.view(torch.int32), want.view(torch.int32))
