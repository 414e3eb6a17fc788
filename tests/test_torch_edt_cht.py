"""The port's convex-hull envelope K9 (``edt_cuda.envelope_cht``) against
the JAX CHT kernel (``edt_cht.envelope_pass_cht``, interpret mode), on the
CPU.

The JAX kernel keeps its hull in K register slots and falls back to the
relaxation for blocks that overflow them; the port's kernel keeps the whole
hull, so there is no K. Both compute the exact envelope with outputs above
3 * 1024^2 + 1024 set to INF_D2, on the JAX kernel's inputs (each value at
most 2 * 1024^2 or exactly INF_D2). Tolerance: bitwise. The CUDA kernel is
held against the same plain version on the card by ``chip_smoke.py``.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from sdf_tools_tpu.ops import edt as jedt, edt_cht
from sdf_tools_tpu_torch.ops import edt, edt_cuda

DRAWS = 10  # as many as tests/test_edt_cht.py draws


def _random_inputs():
    """The draws of tests/test_edt_cht.py's random test: squared values up
    to 2 * n^2 with 10% INF_D2."""
    rng = np.random.default_rng(7)
    out = []
    for _ in range(DRAWS):
        X = int(rng.choice([2, 5, 8, 16]))
        Y = int(rng.choice([2, 7, 16, 32]))
        Z = int(rng.choice([1, 2, 8, 16]))
        nmax = max(X, Y, Z)
        f = (rng.integers(0, int(np.sqrt(2) * nmax) + 1, (X, Y, Z)) ** 2).astype(np.int32)
        out.append(np.where(rng.random((X, Y, Z)) < 0.1, edt.INF_D2, f).astype(np.int32))
    return out


@pytest.mark.parametrize("k", [2, 4, 8])
def test_cht_plain_matches_jax_random(k):
    for f in _random_inputs():
        for axis in (1, 2):
            if f.shape[axis] == 1:
                continue
            want = np.asarray(edt_cht.envelope_pass_cht(jnp.asarray(f), axis, K=k))
            got = edt_cuda.envelope_cht_plain(torch.as_tensor(f), axis)
            np.testing.assert_array_equal(got.numpy(), want)


def test_cht_plain_matches_jax_overflow_profile():
    """The convex profile keeps every parabola on the hull: the JAX kernel
    overflows K = 2 and returns its relaxation's values; the port's
    function agrees, and both equal the brute envelope (no value is above
    the clamp)."""
    X, Y, Z = 4, 64, 8
    j = np.arange(Y)
    f = ((j - 32) ** 2 * 3).astype(np.int32)[None, :, None] * np.ones((X, 1, Z), np.int32)
    want = np.asarray(edt_cht.envelope_pass_cht(jnp.asarray(f), 1, K=2))
    got = edt_cuda.envelope_cht_plain(torch.as_tensor(f), 1)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, np.asarray(jedt.envelope_pass_brute(jnp.asarray(f), 1)))


@pytest.mark.parametrize("shape", [(4, 1, 8), (4, 9, 1), (3, 1, 1), (1, 12, 1)], ids=lambda s: "x".join(map(str, s)))
def test_cht_plain_matches_jax_degenerate(shape):
    """Y < 2 or Z == 1: the JAX function returns its input or runs the
    relaxation kernel; on its inputs that is the port's function too."""
    rng = np.random.default_rng(sum(shape))
    f = rng.integers(0, 2 * 1024**2, shape).astype(np.int32)
    f[rng.random(shape) < 0.3] = edt.INF_D2
    for axis in (1, 2):
        want = np.asarray(edt_cht.envelope_pass_cht(jnp.asarray(f), axis))
        got = edt_cuda.envelope_cht_plain(torch.as_tensor(f), axis)
        np.testing.assert_array_equal(got.numpy(), want)


def test_cht_clamps_above_contract_bound():
    """A value above 3 * 1024^2 + 1024 comes from no source: INF_D2 (the
    JAX kernel's sentinel rule), whatever n is."""
    f = np.full((2, 5, 3), edt.INF_D2, np.int32)
    c = edt_cuda.CHT_CLAMP
    f[:, 0, :] = c - 4  # reaches the bound at i = 2, passes it from i = 3
    got = edt_cuda.envelope_cht_plain(torch.as_tensor(f), 1).numpy()
    np.testing.assert_array_equal(got[0, :, 0], [c - 4, c - 3, c, edt.INF_D2, edt.INF_D2])


@pytest.mark.parametrize("axis", [1, 2])
def test_cht_rejects_axis_over_1024(axis):
    shape = [2, 3, 3]
    shape[axis] = 1025
    f = torch.zeros(shape, dtype=torch.int32)
    for fn in (edt_cuda.envelope_cht, edt_cuda.envelope_cht_plain):
        with pytest.raises(ValueError, match="1024"):
            fn(f, axis)
    with pytest.raises(ValueError, match="1024"):
        jnp_f = jnp.zeros((2, 1025, 3), jnp.int32)
        edt_cht.envelope_pass_cht(jnp_f, 1)
