"""The port's single-field EDT (K4 line pass, K5 envelope, ``squared_edt``
and its backends) against the JAX package, on the CPU.

K4's and K5's plain PyTorch versions are held against the Pallas kernels
they replace, run in interpret mode; ``squared_edt`` for every backend
against the JAX ``squared_edt`` with the matching backend (the port's
``"auto"`` and ``"plain"`` against JAX ``"pallas"``); the signed field of
the non-fused backends against JAX. Tolerance everywhere: bitwise (int32
fields equal; f32 fields compared as uint32 bit patterns). The CUDA kernels
are held against the same plain versions on the card by ``chip_smoke.py``.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from sdf_tools_tpu.ops import edt as jedt, edt_pallas
from sdf_tools_tpu_torch import native
from sdf_tools_tpu_torch.ops import edt, edt_cuda

RES = 0.07
# chip_smoke.py's SMALL_SHAPES less its 128^3 (degenerate and odd shapes
# included; the line pass takes the 128^3 too), plus an all-empty and an
# all-full mask
CASES = [
    ("random", (16, 24, 32)),
    ("random", (8, 40, 1)),
    ("random", (1, 16, 128)),
    ("random", (5, 7, 9)),
    ("random", (33, 64, 129)),
    ("empty", (16, 24, 32)),
    ("full", (16, 24, 32)),
]
LINE_CASES = CASES + [("random", (128, 128, 128))]  # chip_smoke.py's SMALL_SHAPES in full
LINE_IDS = [f"{kind}-{'x'.join(map(str, shape))}" for kind, shape in LINE_CASES]
# tests/test_edt.py's envelope shapes for the [0, 900) u INF_D2 inputs
ENVELOPE_SHAPES = [(8, 32, 128), (4, 24, 256), (3, 40, 128), (8, 5, 128), (8, 16, 1)]
# port backend -> JAX backend computing the same function
BACKENDS = {
    "auto": "pallas", "plain": "pallas", "cht": "cht", "stencil": "stencil",
    "scan": "scan", "brute": "brute", "reference": "reference",
}


def _mask(kind, shape):
    if kind == "empty":
        return np.zeros(shape, bool)
    if kind == "full":
        return np.ones(shape, bool)
    return np.random.default_rng(sum(shape)).random(shape) < 0.12


def _bits(x):
    return np.ascontiguousarray(x).view(np.uint32)


@pytest.mark.parametrize("square", [True, False], ids=["squared", "linear"])
@pytest.mark.parametrize("kind,shape", LINE_CASES, ids=LINE_IDS)
def test_line_pass_plain_matches_pallas(kind, shape, square):
    m = _mask(kind, shape)
    want = edt_pallas.line_pass_pallas(jnp.asarray(m), interpret=True, square=square)
    got = edt_cuda.line_pass_plain(torch.as_tensor(m), square)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _envelope_inputs():
    """(id, int32 field): line d^2 of random masks, and uniform [0, 900)
    values with 60% INF_D2."""
    out = []
    for kind, shape in CASES[:5]:
        f = edt_cuda.line_pass_plain(torch.as_tensor(_mask(kind, shape))).numpy()
        out.append((f"line-d2-{'x'.join(map(str, shape))}", f))
    rng = np.random.default_rng(17)
    for shape in ENVELOPE_SHAPES:
        f = rng.integers(0, 900, shape).astype(np.int32)
        f[rng.random(shape) < 0.6] = edt.INF_D2
        out.append((f"u900-{'x'.join(map(str, shape))}", f))
    return out


ENVELOPE_INPUTS = _envelope_inputs()


@pytest.mark.parametrize("axis", [1, 2])
@pytest.mark.parametrize("idx", range(len(ENVELOPE_INPUTS)), ids=[i for i, _ in ENVELOPE_INPUTS])
def test_envelope_plain_matches_pallas(idx, axis):
    f = ENVELOPE_INPUTS[idx][1]
    want = edt_pallas.envelope_pass_pallas(jnp.asarray(f), axis, interpret=True)
    got = edt_cuda.envelope_plain(torch.as_tensor(f), axis)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _edt_mask():
    m = np.random.default_rng(23).random((12, 20, 16)) < 0.03
    m[0] = False  # seedless x-lines (INF propagation)
    m[:, 3, :] = False
    return m


@pytest.mark.parametrize("backend", list(BACKENDS))
def test_squared_edt_matches_jax(backend):
    jax_backend = BACKENDS[backend]
    if backend == "reference" and not native.available():
        with pytest.raises(RuntimeError, match="native"):
            edt.squared_edt(torch.zeros((4, 4, 4), dtype=torch.bool), backend)
        return
    for m in (_edt_mask(), np.zeros((6, 9, 7), bool)):
        want = np.asarray(jedt.squared_edt(jnp.asarray(m), jax_backend))
        got = edt.squared_edt(torch.as_tensor(m), backend)
        assert got.dtype == torch.int32 and got.shape == m.shape
        np.testing.assert_array_equal(got.numpy(), want)


def test_squared_edt_numpy_mask_needs_device():
    m = _edt_mask()
    with pytest.raises(ValueError, match="device"):
        edt.squared_edt(m)
    got = edt.squared_edt(m, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(jedt.squared_edt(jnp.asarray(m), "pallas")))


def test_scan_clamps_to_inf_plus_2n2():
    """The scan's output clamp INF_D2 + 2n^2 (not INF_D2): visible on lines
    whose every value lies above it; the JAX scan gives the same."""
    f = np.full((3, 6, 5), 1 << 30, np.int32)
    f[1, 2, 3] = 40
    for axis in (1, 2):
        want = np.asarray(jedt.envelope_pass_scan(jnp.asarray(f), axis))
        got = edt.envelope_pass_scan(torch.as_tensor(f), axis).numpy()
        np.testing.assert_array_equal(got, want)
        n = f.shape[axis]
        assert (got == edt.INF_D2 + 2 * n * n).sum() > 0


@pytest.mark.parametrize("axis", [1, 2])
def test_stencil_envelope_matches_jax(axis):
    f = ENVELOPE_INPUTS[5][1]
    want = np.asarray(jedt.envelope_pass_stencil(jnp.asarray(f), axis))
    np.testing.assert_array_equal(edt.envelope_pass_stencil(torch.as_tensor(f), axis).numpy(), want)


@pytest.mark.parametrize("backend", ["cht", "stencil", "scan"])
def test_signed_field_matches_jax(backend):
    m = np.random.default_rng(4).random((16, 24, 16)) < 0.05
    jd, jmx, jmn = jedt.signed_field_from_masks(jnp.asarray(m), RES, backend=backend)
    d, mx, mn = edt.signed_field_from_masks(torch.as_tensor(m), RES, backend)
    np.testing.assert_array_equal(_bits(d.numpy()), _bits(np.asarray(jd)))
    assert _bits(mx.numpy()) == _bits(jmx) and _bits(mn.numpy()) == _bits(jmn)
    ja, jb = jedt.squared_edt_both(jnp.asarray(m), backend)
    a, b = edt.squared_edt_both(torch.as_tensor(m), backend)
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(b.numpy(), np.asarray(jb))


def test_every_backend_but_plain_runs_k4():
    """The line pass of every single-field backend is K4's wrapper (the
    kernel on a CUDA tensor, its plain version on a CPU tensor); "plain"
    keeps the plain version on any device."""
    for backend in ("auto", "cht", "stencil", "scan", "brute"):
        assert edt._single_field(backend)[0] is edt_cuda.line_pass
    assert edt._single_field("plain")[0] is edt_cuda.line_pass_plain


def test_single_wrappers_on_cpu_run_plain_and_count_no_launch():
    m = torch.as_tensor(_mask("random", (5, 7, 9)))
    before = dict(edt_cuda.LAUNCHES)
    for square in (True, False):
        want = edt_cuda.line_pass_plain(m, square)
        assert torch.equal(edt_cuda.line_pass(m, square), want)
        assert torch.equal(edt_cuda.line_pass(m.to(torch.uint8), square), want)
    f = edt_cuda.line_pass(m)
    for axis in (1, 2):
        assert torch.equal(edt_cuda.envelope(f, axis), edt_cuda.envelope_plain(f, axis))
        assert torch.equal(edt_cuda.envelope_cht(f, axis), edt_cuda.envelope_cht_plain(f, axis))
    assert edt_cuda.LAUNCHES == before


def _bad_inputs():
    f = torch.zeros((4, 5, 6), dtype=torch.int32)
    return [
        ("line_pass float", lambda: edt_cuda.line_pass(torch.zeros((4, 5, 6))), TypeError),
        ("line_pass 2d", lambda: edt_cuda.line_pass(torch.zeros((4, 5), dtype=torch.bool)), ValueError),
        ("line_pass strided", lambda: edt_cuda.line_pass(torch.zeros((4, 5, 6), dtype=torch.bool).transpose(0, 2)),
         ValueError),
        ("envelope int64", lambda: edt_cuda.envelope(f.to(torch.int64), 1), TypeError),
        ("envelope axis 0", lambda: edt_cuda.envelope(f, 0), ValueError),
        ("envelope strided", lambda: edt_cuda.envelope(f.transpose(1, 2), 1), ValueError),
        ("envelope_cht float", lambda: edt_cuda.envelope_cht(f.float(), 1), TypeError),
        ("envelope_cht axis 0", lambda: edt_cuda.envelope_cht(f, 0), ValueError),
        ("squared_edt pallas", lambda: edt.squared_edt(f.bool(), "pallas"), NotImplementedError),
        ("squared_edt unknown", lambda: edt.squared_edt(f.bool(), "fast"), ValueError),
        ("squared_edt 2d", lambda: edt.squared_edt(torch.zeros((4, 5), dtype=torch.bool)), ValueError),
        ("slabbed reference", lambda: next(edt.squared_edt_slabbed(f.bool(), 2, "reference")), ValueError),
    ]


@pytest.mark.parametrize("idx", range(len(_bad_inputs())), ids=[n for n, _, _ in _bad_inputs()])
def test_single_wrappers_reject_bad_inputs(idx):
    _, call, exc = _bad_inputs()[idx]
    with pytest.raises(exc):
        call()
