"""The level-order monotone row-minimum search of the envelope kernels
(K2, K3, K5: ``sdf_tools_tpu_torch/csrc/edt_envelope.cu``; K6:
``csrc/edt_carry.cu``; the search itself: ``csrc/envelope_search.cuh``),
emulated in numpy on the CPU.

The CUDA kernels cannot run here, so this pins the argument they rely on:
the leftmost minimiser J(i) of f[j] + (i - j)^2 never decreases along a
line, so solving rows level by level, each over [J(i - s), J(i + s)] of rows
solved before, finds every row's leftmost minimiser. The emulation follows
the kernel's level order exactly. Its envelope is held bitwise against
``edt_cuda.envelope_plain`` and the JAX Pallas envelope kernel in interpret
mode, and its J against the first minimiser of ``envelope_argmin_plain``
(K6's winner) and the payloads read at J against ``envelope_carry_plain``
(K6's carry form), on tie-heavy, seedless, near-INF_D2 and single-seed
lines of length up to 64, along axes 1 and 2. The kernels themselves are
held against the plain versions on the card by ``chip_smoke.py``.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from sdf_tools_tpu.ops import edt_pallas
from sdf_tools_tpu_torch import _build
from sdf_tools_tpu_torch.ops import edt_cuda
from sdf_tools_tpu_torch.ops.edt import INF_D2


def search_envelope(f: np.ndarray):
    """(envelope, J) of lines f [lines, n] by the kernel's level order."""
    lines, n = f.shape
    f = f.astype(np.int64)
    j = np.arange(n)
    J = np.full((lines, n), -1)

    def solve(i, lo, hi):
        assert (lo >= 0).all() and (hi >= lo).all()  # bounds from solved rows
        v = np.where((j >= lo[:, None]) & (j <= hi[:, None]), f + (i - j) ** 2, np.iinfo(np.int64).max)
        J[:, i] = v.argmin(axis=1)  # the first of equal minima: the leftmost

    K = 0 if n == 1 else (n - 1).bit_length()
    ends = np.zeros(lines, int), np.full(lines, n - 1)
    for k in range(K):
        s = 1 << (K - 1 - k)
        for i in range(s, n, 2 * s):
            solve(i, J[:, i - s] if i - s > 0 else ends[0], J[:, i + s] if i + s < n else ends[1])
    solve(0, ends[0], J[:, 1] if n > 1 else ends[0])
    out = np.take_along_axis(f, J, axis=1) + (j - J) ** 2
    return out.astype(np.int32), J


def _lines(f: np.ndarray, axis: int) -> np.ndarray:
    return np.moveaxis(f, axis, -1).reshape(-1, f.shape[axis])


def _inputs():
    """(id, int32 field [X, Y, Z]) with the scanned axis of length n on both
    axes 1 and 2 (the field is n x n in y and z)."""
    rng = np.random.default_rng(6)
    out = []
    for n in (1, 2, 3, 17, 63, 64):
        shape = (3, n, n)
        ties = rng.choice(np.array([0, 1, 4, INF_D2], np.int32), shape)
        out.append((f"ties-{n}", ties))
        seedless = np.full(shape, INF_D2, np.int32)
        seedless[1] = rng.choice(np.array([2, INF_D2], np.int32), (n, n), p=[0.1, 0.9])
        out.append((f"seedless-{n}", seedless))
        near_inf = (INF_D2 - rng.integers(0, 8, shape)).astype(np.int32)
        near_inf[rng.random(shape) < 0.5] = INF_D2
        out.append((f"near-inf-{n}", near_inf))
        single = np.full(shape, INF_D2, np.int32)
        for x in range(3):  # a permutation: one seed on every line along y and along z
            single[x, np.arange(n), rng.permutation(n)] = rng.integers(0, 3 * n, n)
        out.append((f"single-seed-{n}", single))
    return out


INPUTS = _inputs()


@pytest.mark.parametrize("axis", [1, 2])
@pytest.mark.parametrize("idx", range(len(INPUTS)), ids=[i for i, _ in INPUTS])
def test_search_matches_plain_and_first_minimiser(idx, axis):
    f = INPUTS[idx][1]
    out, J = search_envelope(_lines(f, axis))
    assert (np.diff(J, axis=1) >= 0).all(), "J decreases along a line"
    want = edt_cuda.envelope_plain(torch.as_tensor(f), axis).numpy()
    np.testing.assert_array_equal(out, _lines(want, axis))
    _, first = edt_cuda.envelope_argmin_plain(torch.as_tensor(f), axis)
    np.testing.assert_array_equal(J, _lines(first.numpy(), axis))


@pytest.mark.parametrize("axis", [1, 2])
@pytest.mark.parametrize("idx", range(len(INPUTS)), ids=[i for i, _ in INPUTS])
def test_search_carries_payloads_as_plain(idx, axis):
    """K6's carry form: three int32 payloads read at each cell's J (same
    line) equal ``envelope_carry_plain``'s, and so does the envelope."""
    f = INPUTS[idx][1]
    out, J = search_envelope(_lines(f, axis))
    rng = np.random.default_rng(idx + 10 * axis)
    pays = [rng.integers(-(1 << 31), 1 << 31, f.shape, dtype=np.int64).astype(np.int32) for _ in range(3)]
    want = edt_cuda.envelope_carry_plain(torch.as_tensor(f), [torch.as_tensor(p) for p in pays], axis)
    np.testing.assert_array_equal(out, _lines(want[0].numpy(), axis))
    for p, w in zip(pays, want[1:]):
        np.testing.assert_array_equal(np.take_along_axis(_lines(p, axis), J, axis=1), _lines(w.numpy(), axis))


# the JAX kernel in interpret mode costs seconds per call: one shape per kind
JAX_INPUTS = [i for i, (name, _) in enumerate(INPUTS) if name.endswith(("-3", "-64"))]


@pytest.mark.parametrize("axis", [1, 2])
@pytest.mark.parametrize("idx", JAX_INPUTS, ids=[INPUTS[i][0] for i in JAX_INPUTS])
def test_search_matches_pallas(idx, axis):
    f = INPUTS[idx][1]
    out, _ = search_envelope(_lines(f, axis))
    want = np.asarray(edt_pallas.envelope_pass_pallas(jnp.asarray(f), axis, interpret=True))
    np.testing.assert_array_equal(out, _lines(want, axis))


def test_seedless_lines_come_out_inf():
    """A line with no finite entry gives exactly INF_D2 (the j == i term)."""
    f = np.full((4, 37), INF_D2, np.int32)
    f[1, 5] = 0
    out, J = search_envelope(f)
    assert (out[[0, 2, 3]] == INF_D2).all()
    assert (J[[0, 2, 3]] == np.arange(37)).all()
    np.testing.assert_array_equal(out[1], (np.arange(37) - 5) ** 2)


def test_library_name_hashes_the_search_header(tmp_path, monkeypatch):
    """The kernels include ``csrc/envelope_search.cuh``, so an edit to it must
    name (and so build) a new library, as an edit to a ``.cu`` does."""
    for src in (*_build.CSRC.glob("*.cu"), *_build.CSRC.glob("*.cuh")):
        (tmp_path / src.name).write_bytes(src.read_bytes())
    assert (tmp_path / "envelope_search.cuh").exists()
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build.library_path()
    header = tmp_path / "envelope_search.cuh"
    header.write_bytes(header.read_bytes() + b"\n")
    assert _build.library_path() != before
