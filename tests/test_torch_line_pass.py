"""The blocked line-pass scan of K1 and K4 (``sdf_tools_tpu_torch/csrc/
edt_line_pass.cu``), emulated in numpy on the CPU.

The CUDA kernel cannot run here, so this follows it step by step on every
column of a mask: the thread geometry (chunks of 32 rows, C chunks a thread,
at most 32 warps), the chunk words (bit i = row i; field b's word is
``~word & valid``), each thread's first and last seed (``__ffs`` /
``__clz``), the carries over the other warps' summaries, the forward-only
look-ahead over later chunks of a thread's range, and the per-row walk (the
last seed carried along, the next one the highest set bit of
``brev(word) << i``), in the kernel's unsigned 32-bit arithmetic. It checks
that each output is written exactly once and that a chunk's mask bytes are
read once (C == 1) or at most once more a field (C > 1), and holds the
outputs, one field and two, squared and linear, bitwise against
``edt_cuda.line_pass_plain`` / ``line_pass_dual_plain`` at X from 1 to 2049,
and against the Pallas kernels in interpret mode at X <= 65. The masks are
uint8 with seed values 1..255 and hold, column by column, seedless and full
columns, seeds only on chunk edges (rows 0, 31 and 32 of a chunk), one seed
in the last chunk, seeds far apart with seedless chunks between them, and
random densities; 3 x 11 columns (YZ not a multiple of 32 or 4). The kernel
itself is held against the plain versions on the card by ``chip_smoke.py``.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from sdf_tools_tpu.ops import edt_pallas
from sdf_tools_tpu_torch.ops import edt_cuda
from sdf_tools_tpu_torch.ops.edt import INF_D2

ROWS = 32  # rows of a chunk
MAX_WARPS = 32
NONE_AFTER = 0xFFFFFFFF
LINE_SENTINEL = 1 << 24
M32 = np.uint64(0xFFFFFFFF)
X_LENGTHS = (1, 2, 31, 32, 33, 63, 64, 65, 1023, 1024, 1025, 2049)
PALLAS_MAX_X = 65  # the Pallas kernels in interpret mode cost ~0.3 s a call


def geometry(X: int):
    """(chunks, chunks a thread C, warps W), as ``launch`` picks them."""
    nchunks = (X - 1) // ROWS + 1
    C = -(-nchunks // MAX_WARPS)
    return nchunks, C, -(-nchunks // C)


def bit_length(v: np.ndarray) -> np.ndarray:
    """Exact for v < 2^53: v = m * 2^e with m in [0.5, 1)."""
    return np.frexp(v.astype(np.float64))[1].astype(np.int64)


def clz(v: np.ndarray) -> np.ndarray:
    return 32 - bit_length(v)


def ffs(v: np.ndarray) -> np.ndarray:
    """1 + the lowest set bit's index, 0 for 0 (CUDA's ``__ffs``)."""
    return bit_length(v & ((~v + np.uint64(1)) & M32))


def brev(v: np.ndarray) -> np.ndarray:
    out = np.zeros_like(v)
    for b in range(32):
        out |= ((v >> np.uint64(b)) & np.uint64(1)) << np.uint64(31 - b)
    return out


def valid_rows(X: int, k: int) -> np.uint64:
    n = X - k * ROWS
    return M32 if n >= ROWS else np.uint64((1 << n) - 1)


def field_word(w: np.ndarray, valid: np.uint64, f: int) -> np.ndarray:
    return w if f == 0 else ~w & valid


def emulate(mask: np.ndarray, n_fields: int):
    """The kernel on ``mask`` [X, Y, Z]: (squared, linear) outputs, each a
    list of ``n_fields`` int32 [X, Y, Z] arrays."""
    X = mask.shape[0]
    cols = mask.reshape(X, -1) != 0
    n = cols.shape[1]
    nchunks, C, W = geometry(X)
    padded = np.zeros((nchunks * ROWS, n), np.uint64)
    padded[:X] = cols
    reads = np.zeros((nchunks, n), np.int64)

    def load_word(k):  # one read of the chunk's 32 mask bytes, every column
        reads[k] += 1
        return (padded[k * ROWS : (k + 1) * ROWS] << np.arange(ROWS, dtype=np.uint64)[:, None]).sum(0)

    sq = [np.zeros((X, n), np.int64) for _ in range(n_fields)]
    lin = [np.zeros((X, n), np.int64) for _ in range(n_fields)]
    writes = np.zeros((X, n), np.int64)
    # phase 1: each warp's range [k0, k1) of chunks; its first and last seed
    first = np.full((n_fields, W, n), NONE_AFTER, np.int64)
    last = np.full((n_fields, W, n), -X, np.int64)
    w0 = []
    for warp in range(W):
        k0, k1 = warp * C, min(warp * C + C, nchunks)
        for k in range(k0, k1):
            w = load_word(k)
            if k == k0:
                w0.append(w)
            for f in range(n_fields):
                wf = field_word(w, valid_rows(X, k), f)
                hit = wf != 0
                first[f, warp] = np.where(hit & (first[f, warp] == NONE_AFTER), k * ROWS + ffs(wf) - 1, first[f, warp])
                last[f, warp] = np.where(hit, k * ROWS + 31 - clz(wf), last[f, warp])
    for warp in range(W):
        k0, k1 = warp * C, min(warp * C + C, nchunks)
        # phase 2: the carries over the other warps' summaries
        prev = [last[f, :warp].max(0, initial=-X) for f in range(n_fields)]
        right = [first[f, warp + 1 :].min(0, initial=NONE_AFTER) for f in range(n_fields)]
        ahead = [np.zeros(n, np.int64) for _ in range(n_fields)]  # stale
        scan = [np.full(n, k0 + 1) for _ in range(n_fields)]
        # phase 3: the walk
        for k in range(k0, k1):
            base = k * ROWS
            w = w0[warp] if k == k0 else load_word(k)
            rw = []
            for f in range(n_fields):
                rw.append(brev(field_word(w, valid_rows(X, k), f)))
                stale = ahead[f] < base + ROWS
                ahead[f] = np.where(stale, right[f], ahead[f])
                looking = stale.copy()
                stop = np.where(stale, k1, scan[f])
                for j in range(k + 1, k1):
                    reading = looking & (j >= scan[f])
                    if not reading.any():
                        continue
                    wj = field_word(load_word(j), valid_rows(X, j), f)
                    reads[j] -= ~reading  # columns that did not read chunk j
                    found = reading & (wj != 0)
                    ahead[f] = np.where(found, j * ROWS + ffs(wj) - 1, ahead[f])
                    stop = np.where(found, j, stop)
                    looking &= ~found
                scan[f] = np.where(stale, stop + 1, scan[f])
            for i in range(min(ROWS, X - base)):
                x = base + i
                seed = ((w >> np.uint64(i)) & np.uint64(1)).astype(bool)
                prev[0] = np.where(seed, x, prev[0])
                if n_fields == 2:
                    prev[1] = np.where(seed, prev[1], x)
                writes[x] += 1
                for f in range(n_fields):
                    t = (rw[f] << np.uint64(i)) & M32
                    nxt = np.where(t != 0, x + clz(t), ahead[f])
                    d = np.minimum((x - prev[f]) % 2**32, (nxt - x) % 2**32)
                    none = d >= X
                    sq[f][x] = np.where(none, INF_D2, (d * d) % 2**32)
                    lin[f][x] = np.where(none, LINE_SENTINEL, d)
    assert (writes == 1).all(), "an output is written more or less than once"
    assert (reads >= 1).all() and (reads <= (1 if C == 1 else 2 + n_fields)).all(), "mask read too often"

    def back(outs):
        return [o.astype(np.uint32).view(np.int32).reshape(mask.shape) for o in outs]

    return back(sq), back(lin)


def make_mask(X: int, seed: int) -> np.ndarray:
    """[X, 3, 11] uint8: one kind of column each (seed values 1..255)."""
    rng = np.random.default_rng(seed)
    x = np.arange(X)
    last_chunk = ((X - 1) // ROWS) * ROWS
    kinds = [
        np.zeros(X, bool),  # seedless
        np.ones(X, bool),  # full
        x % ROWS == 0,  # a chunk's row 0
        x % ROWS == ROWS - 1,  # a chunk's row 31
        x == min(ROWS, X - 1),  # row 32: the second chunk's row 0
        x == rng.integers(last_chunk, X),  # one seed in the last chunk
        x == X - 1,
        x == 0,
        (x == 3) | (x == X - 4),  # far apart: seedless chunks between
        (x == min(5, X - 1)) | (x == X // 2),
        x % 300 == 150,
    ]
    kinds += [~k for k in kinds[2:10]]  # the same edges for field b
    kinds += [rng.random(X) < p for p in (0.002, 0.02, 0.1, 0.5, 0.9, 0.98, 0.998)]
    while len(kinds) < 33:
        kinds.append(rng.random(X) < rng.random())
    cols = np.stack(kinds[:33], axis=1)
    values = rng.integers(1, 256, cols.shape).astype(np.uint8)
    return np.where(cols, values, 0).astype(np.uint8).reshape(X, 3, 11)


MASKS = {X: make_mask(X, X) for X in X_LENGTHS}


def test_masks_cover_the_edges():
    for X, m in MASKS.items():
        assert m.shape == (X, 3, 11) and (m[m != 0] > 1).any()
    assert geometry(1024)[1:] == (1, 32) and geometry(1025)[1:] == (2, 17) and geometry(2049)[1:] == (3, 22)


@pytest.mark.parametrize("n_fields", [1, 2], ids=["K4", "K1"])
@pytest.mark.parametrize("X", X_LENGTHS)
def test_emulation_matches_plain(X, n_fields):
    m = MASKS[X]
    got_sq, got_lin = emulate(m, n_fields)
    t = torch.as_tensor(m)
    for square, got in ((True, got_sq), (False, got_lin)):
        if n_fields == 1:
            want = [edt_cuda.line_pass_plain(t, square)]
        else:
            want = edt_cuda.line_pass_dual_plain(t, square)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w.numpy())


@pytest.mark.parametrize("n_fields", [1, 2], ids=["K4", "K1"])
@pytest.mark.parametrize("X", [X for X in X_LENGTHS if X <= PALLAS_MAX_X])
def test_emulation_matches_pallas(X, n_fields):
    m = MASKS[X]
    got_sq, got_lin = emulate(m, n_fields)
    for square, got in ((True, got_sq), (False, got_lin)):
        if n_fields == 1:
            want = [edt_pallas.line_pass_pallas(jnp.asarray(m), interpret=True, square=square)]
        else:
            want = edt_pallas.line_pass_dual_pallas(jnp.asarray(m), interpret=True, square=square)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, np.asarray(w))


def test_lookahead_reads_each_later_chunk_once():
    """Several chunks a thread (X = 4097: C = 5): a column whose seeds sit
    at both ends of a thread's range, with seedless chunks between, gives
    the same as plain, and the look-ahead reads each chunk at most once a
    field (``emulate`` asserts the read counts)."""
    X = 4097
    m = np.zeros((X, 1, 3), np.uint8)
    m[[0, 159, 160, 4096], 0, 0] = 9
    m[::97, 0, 1] = 200
    m[:, 0, 2] = np.random.default_rng(1).random(X) < 0.001
    for n_fields in (1, 2):
        got_sq, _ = emulate(m, n_fields)
        want = edt_cuda.line_pass_dual_plain(torch.as_tensor(m))[:n_fields]
        for g, w in zip(got_sq, want):
            np.testing.assert_array_equal(g, w.numpy())
