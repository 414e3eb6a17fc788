"""The banded lower envelope of K9 (``sdf_tools_tpu_torch/csrc/edt_cht.cu``),
emulated in numpy on the CPU.

The CUDA kernel cannot run here, so this pins its algorithm in the
kernel's order: 32 bands of ceil(n / 32) cells, each band's forward stack
kept in place (``down`` and ``up`` links at the entries' own cells, -1 for
a removed entry), five merge rounds by the left group's lane, the hull
compacted by flags and a prefix sum, each band's start entry found by binary
search and its cells walked forward, with the ``CHT_CLAMP`` -> ``INF_D2``
rule. The emulation is held bitwise against ``edt_cuda.envelope_cht_plain``
on lines of length 1, 2, 3, 31, 32, 33, 64, 200 and 1024 (random draws,
seedless lines, sources around the clamp, the convex profile on which
every source stays on the hull), and against the JAX CHT kernel
(``edt_cht.envelope_pass_cht``, interpret mode) at two shapes. The kernel
itself is held against the plain version on the card by ``chip_smoke.py``.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from sdf_tools_tpu.ops import edt_cht
from sdf_tools_tpu_torch.ops import edt_cuda
from sdf_tools_tpu_torch.ops.edt import INF_D2

CLAMP = edt_cuda.CHT_CLAMP
LANES = 32


def _hidden(a, ga, b, gb, q, gq):
    """Parabola b (a < b < q) is nowhere strictly below both: s(b, q) <= s(a, b)."""
    return (gq - gb) * (b - a) <= (gb - ga) * (q - b)


def hull_line(f):
    """(envelope with the clamp rule, number of hull entries) of one line of
    int32 values, in the kernel's order."""
    n = len(f)
    f = [int(v) for v in f]

    def g(q):
        return f[q] + q * q

    B = (n + LANES - 1) // LANES
    band = [(min(b * B, n), min(b * B + B, n)) for b in range(LANES)]
    down, up = [None] * n, [None] * n
    bot, top = [-1] * LANES, [-1] * LANES

    # 1. each band's lower envelope, a stack in place
    for lane, (c0, c1) in enumerate(band):
        b = t = -1
        for q in range(c0, c1):
            if f[q] > CLAMP:
                down[q] = -1
                continue
            while t != b and _hidden(down[t], g(down[t]), t, g(t), q, g(q)):
                s = down[t]
                down[t] = -1
                t = s
            if t < 0:
                b, down[q] = q, q
            else:
                down[q], up[t] = t, q
            t = q
        bot[lane], top[lane] = b, t

    # 2. five merge rounds by the left group's lane
    step = 1
    while step < LANES:
        for lane in range(0, LANES, 2 * step):
            rb, rt = bot[lane + step], top[lane + step]
            if top[lane] < 0:
                bot[lane], top[lane] = rb, rt
            elif rt >= 0:
                t, u = top[lane], rb
                while True:
                    if t != bot[lane] and _hidden(down[t], g(down[t]), t, g(t), u, g(u)):
                        s = down[t]
                        down[t] = -1
                        t = s
                        continue
                    if u != rt and _hidden(t, g(t), u, g(u), up[u], g(up[u])):
                        v = up[u]
                        down[u] = -1
                        u = v
                        continue
                    break
                up[t], down[u] = u, t
                top[lane] = rt
        step *= 2

    # 3. compact by flags and a prefix sum, then each band from its start entry
    counts = [sum(down[q] >= 0 for q in range(c0, c1)) for c0, c1 in band]
    offsets = np.concatenate([[0], np.cumsum(counts)])
    hull = [0] * int(offsets[-1])
    for lane, (c0, c1) in enumerate(band):
        flagged = [q for q in range(c0, c1) if down[q] >= 0]
        hull[offsets[lane] : offsets[lane] + len(flagged)] = flagged
    total = len(hull)

    def at(k, i):
        return f[hull[k]] + (i - hull[k]) ** 2

    out = np.empty(n, np.int64)
    for c0, c1 in band:
        if c0 >= c1:
            continue
        if total == 0:
            out[c0:c1] = INF_D2
            continue
        lo, hi = 0, total - 1
        while lo < hi:
            mid = (lo + hi) // 2
            if at(mid + 1, c0) <= at(mid, c0):
                lo = mid + 1
            else:
                hi = mid
        k = 0  # the search finds where a walk from the hull's first entry stops
        while k + 1 < total and at(k + 1, c0) <= at(k, c0):
            k += 1
        assert k == lo
        for i in range(c0, c1):
            while k + 1 < total and at(k + 1, i) <= at(k, i):
                k += 1
            v = at(k, i)
            out[i] = INF_D2 if v > CLAMP else v
    assert all(hull[k] < hull[k + 1] for k in range(total - 1))
    assert all(f[q] <= CLAMP for q in hull) and all(f[q] < 1 << 22 for q in hull)  # the compact entry's bits
    return out.astype(np.int32), total


def hull_lines(f: np.ndarray, axis: int):
    """(emulated K9 output, hull sizes) of every line of f along ``axis``."""
    lines = np.moveaxis(f, axis, -1).reshape(-1, f.shape[axis])
    outs, sizes = zip(*(hull_line(line) for line in lines))
    out = np.stack(outs).reshape(np.moveaxis(f, axis, -1).shape)
    return np.moveaxis(out, -1, axis), np.array(sizes)


def _line_cases(n: int, rng):
    """(label, [4, n] lines) along the last axis: random squared values with
    INF_D2 mixed in, seedless, sources at and around the clamp, one source,
    and the convex profile."""
    j = np.arange(n)
    random = (rng.integers(0, int(np.sqrt(2) * n) + 1, (4, n)) ** 2).astype(np.int32)
    random[rng.random((4, n)) < 0.3] = INF_D2
    near_clamp = rng.choice(np.array([CLAMP - 4, CLAMP - 1, CLAMP, CLAMP + 1, CLAMP + 4, INF_D2], np.int32), (4, n))
    near_clamp[:, 0] = CLAMP - 4  # reaches the clamp two cells on
    single = np.full((4, n), INF_D2, np.int32)
    single[np.arange(4), rng.integers(0, n, 4)] = rng.integers(0, 3 * n, 4)
    convex = np.tile((3 * (j - n // 2) ** 2).astype(np.int32), (4, 1))
    return [
        ("random", random), ("seedless", np.full((4, n), INF_D2, np.int32)), ("near-clamp", near_clamp),
        ("single", single), ("convex", convex),
    ]


def _cases():
    rng = np.random.default_rng(9)
    return [(f"{label}-{n}", f) for n in (1, 2, 3, 31, 32, 33, 64, 200) for label, f in _line_cases(n, rng)]


CASES = _cases()


@pytest.mark.parametrize("axis", [1, 2])
@pytest.mark.parametrize("idx", range(len(CASES)), ids=[c for c, _ in CASES])
def test_hull_matches_plain(idx, axis):
    """The lines as axis ``axis`` of a [2, n, n] or [2, 2, n]-shaped field."""
    label, lines = CASES[idx]
    n = lines.shape[1]
    f = lines.reshape(2, 2, n)
    f = np.moveaxis(f, -1, axis) if axis == 1 else f
    got, sizes = hull_lines(f, axis)
    want = edt_cuda.envelope_cht_plain(torch.as_tensor(np.ascontiguousarray(f)), axis).numpy()
    np.testing.assert_array_equal(got, want)
    if label.startswith("convex"):
        assert (sizes == n).all()  # every source stays on the hull
    if label.startswith("seedless"):
        assert (sizes == 0).all() and (got == INF_D2).all()


def test_hull_matches_plain_at_1024():
    """The full axis (bands of 32 cells, every merge round busy), on four
    lines of each case; numpy only."""
    rng = np.random.default_rng(10)
    for label, lines in _line_cases(1024, rng):
        got = np.stack([hull_line(line)[0] for line in lines])
        want = edt_cuda.envelope_cht_plain(torch.as_tensor(lines[:, None, :]), 2).numpy()[:, 0]
        np.testing.assert_array_equal(got, want, err_msg=label)


def test_hull_near_clamp_keeps_sources_at_or_below_it():
    """A source at f = CLAMP stays on the hull (its own cell reads CLAMP); one
    at CLAMP + 1 is left out."""
    f = np.full(5, INF_D2, np.int32)
    f[1], f[3] = CLAMP, CLAMP + 1
    out, size = hull_line(f)
    assert size == 1
    np.testing.assert_array_equal(out, [INF_D2, CLAMP, INF_D2, INF_D2, INF_D2])


@pytest.mark.parametrize("shape", [(2, 33, 5), (3, 6, 64)], ids=lambda s: "x".join(map(str, s)))
def test_hull_matches_jax_cht(shape):
    """Against the JAX CHT kernel in interpret mode on its inputs (squared
    values up to 2 n^2, 10% INF_D2), along both axes."""
    rng = np.random.default_rng(sum(shape))
    n = max(shape)
    f = (rng.integers(0, int(np.sqrt(2) * n) + 1, shape) ** 2).astype(np.int32)
    f[rng.random(shape) < 0.1] = INF_D2
    for axis in (1, 2):
        want = np.asarray(edt_cht.envelope_pass_cht(jnp.asarray(f), axis, K=4))
        np.testing.assert_array_equal(hull_lines(f, axis)[0], want)
