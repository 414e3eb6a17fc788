"""The envelope-design probes of the port (``sdf_tools_tpu_torch/scripts/
bench_micro_gather{,2,3}.py``, kernels in ``csrc/micro_gather.cu``) against
the JAX scripts' TPU probes (``scripts/bench_micro_gather{,2,3}.py``), on
the CPU.

  * Each port probe's ``build`` gives the JAX probe's inputs, bit for bit.
  * Each plain version, on those numpy inputs, equals the JAX probe run
    with its ``pallas_call`` in interpret mode, bitwise (int32 throughout;
    no probe's sum overflows at these inputs).
  * Each kernel's launch arguments, run through a numpy emulation of its C
    entry point (the kernel's own index arithmetic: the [outer, n, inner]
    view, the stepped modulus, the unsigned sums, the one-hot loops, the
    scan), equal the plain version on a batch of 2; the CUDA source itself
    runs only on the card (``chip_smoke.py`` phase 13).
  * Every kernel block by block, as its launch geometry tiles it
    (``_micro.gather_geometry``, ``onehot_min_geometry``,
    ``onehot_write_geometry``, ``row_scan_geometry``, ``lane_geometry``):
    at B = 1 on an H100's 132 SMs, on both sides of the geometry's first
    switch (one SM, so that it comes at a small batch), and on probes
    whose steps are no multiple of the unroll or of the chunk; every
    (output, step) gather or one-hot select, every one-hot step's store
    and every row scan element's read and write is taken exactly once, a
    shared block's staged rows fit what the launch gives it, and the
    result equals the plain version. The one-hot minimum's one load a step
    equals the one-hot form on indices outside [0, D) and values past
    2^30; the row scan's blocked min-plus scan equals the plain recurrence
    on x over the whole int32 range for runs of 1, 3, 16 and n rows; G8's
    chain where the doubling wraps.
  * The wrapper: a batch of 3 equals three batches of 1 and instance 0 is
    the JAX probe's; a CPU tensor takes the plain version and counts no
    launch; bad inputs raise; each module's ``main`` runs on the CPU and
    labels every time "not measured".

The JAX scripts are loaded by path (``scripts/`` is no package) and stay
as they are.
"""
import ctypes
import functools
import importlib.util
import math
from functools import partial
from pathlib import Path

import numpy as np
import pytest

import jax
from jax.experimental import pallas as jpl
import torch

import chip_smoke

from sdf_tools_tpu_torch import _build
from sdf_tools_tpu_torch.scripts import _micro, bench_micro_gather, bench_micro_gather2, bench_micro_gather3

REPO = Path(__file__).resolve().parents[1]
H100_SMS = 132
MODULES = (bench_micro_gather, bench_micro_gather2, bench_micro_gather3)
PROBES = {p.key: p for m in MODULES for p in m.PROBES}
# the arguments of bench_micro_gather3.py's `make` for each H probe (its lines 75-85)
H_MAKE = {
    "H1": ((8, 128), (8, 128), 0, 8), "H2": ((64, 128), (64, 128), 0, 64),
    "H3": ((512, 128), (512, 128), 0, 512), "H4": ((8, 512), (8, 512), 1, 512),
    "H5": ((8, 256), (8, 256), 1, 256), "H6": ((8, 128), (8, 1), 1, 128),
    "H7": ((64, 128), (64, 128), 1, 128), "H8": ((512, 128), (512, 128), 1, 128),
}


@functools.cache
def _jax_script(name: str):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _jax_build(key: str):
    """The JAX script's probe ``key``: (jitted run, its inputs)."""
    if key.startswith("E"):
        return getattr(_jax_script("bench_micro_gather"), key.lower())()
    if key.startswith("G"):
        return getattr(_jax_script("bench_micro_gather2"), key.lower())()
    return _jax_script("bench_micro_gather3").make(*H_MAKE[key])()


@pytest.fixture(autouse=True)
def one_thread():
    """The plain versions loop over hundreds of small ops: one intra-op
    thread each, so that the test workers sharing the host's cores do not
    oversubscribe them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def interpret(monkeypatch):
    """``pallas_call`` in interpret mode for the JAX scripts' kernels."""
    monkeypatch.setattr(jpl, "pallas_call", functools.partial(jpl.pallas_call, interpret=True))


def _batched(arrays):
    return [torch.from_numpy(np.ascontiguousarray(a))[None] for a in arrays]


def test_every_probe_once():
    assert list(PROBES) == [p.key for m in MODULES for p in m.PROBES]
    assert {p.kernel for p in PROBES.values()} == set(_micro.KERNELS)


@pytest.mark.parametrize("key", list(PROBES))
def test_build_gives_the_jax_inputs(key):
    _, jargs = _jax_build(key)
    ours = PROBES[key].build()
    assert len(ours) == len(jargs)
    for a, j in zip(ours, jargs):
        j = np.asarray(j)
        assert a.dtype == j.dtype == np.int32 and a.shape == j.shape
        np.testing.assert_array_equal(a, j)


@pytest.mark.parametrize("key", list(PROBES))
def test_plain_equals_the_jax_probe(key, interpret):
    run, jargs = _jax_build(key)
    want = np.asarray(run(*jargs))
    p = PROBES[key]
    got = p.plain(*_batched(p.build()))[0].numpy()
    assert got.dtype == want.dtype == np.int32 and got.shape == want.shape == p.out_shape
    np.testing.assert_array_equal(got, want)


# ---- the C entry points emulated in numpy ------------------------------------


def _view(ptr: int, count: int) -> np.ndarray:
    return np.ctypeslib.as_array(ctypes.cast(ptr, ctypes.POINTER(ctypes.c_int32)), shape=(count,))


def _emu_ops(x, out, B, elems, steps, tile, taken=None):
    """``sdf_micro_ops``: blocks of ``tile`` lanes of every instance, a
    thread a lane, its steps in order: acc = min(2 acc + 1, x + i), x + i
    stepped beside the chain, both wrapping. ``taken`` (a list) receives
    ("reads and writes", the count of each (instance, lane)'s load of x
    and store of out)."""
    tile = min(tile, elems)
    assert B <= 65535 and _threads_for(tile) <= 1024
    xs = _view(x, B * elems).reshape(B, elems)
    os_ = _view(out, B * elems).reshape(B, elems)
    count = np.zeros((2, B, elems), np.uint8)
    for e0 in range(0, elems, tile):  # each block's lanes; their chains side by side
        xi = xs[:, e0:e0 + tile].astype(np.uint32)
        acc = np.zeros_like(xi)
        for _ in range(steps):
            acc = np.minimum((acc * 2 + 1).view(np.int32), xi.view(np.int32)).view(np.uint32)
            xi = xi + np.uint32(1)
        os_[:, e0:e0 + tile] = acc.view(np.int32)
        count[:, :, e0:e0 + tile] += 1
    if taken is not None:
        taken.append(("reads and writes", count))


def _threads_for(items: int) -> int:
    return min(1024, max(32, -(-items // 32) * 32))


def _emu_gather(x, q, out, B, outer, n, inner, m, steps, mod, shared, ow, kw, mw, groups, chunk, taken=None):
    """``sdf_micro_gather``: a block a tile of every instance, a tile a box
    of the outputs (``ow`` rows o; or ``kw`` columns k of one o, every j; or
    ``mw`` outputs j of one column); its threads in ``groups`` groups, group
    g over the steps [g chunk, (g + 1) chunk), 8 accumulators (1 in one group
    of under 16 steps) and the tail into the first; the groups' partial sums
    added in shared memory; a
    shared block stages its box's columns of x first. ``taken`` (a list)
    receives ("gathers", the count of each (instance, output, step)). The
    tiles' gathers are taken side by side (every (row, column) a block reads
    lies in its box's columns: r indexes the rows of the output's own
    column)."""
    assert shared == int(4 * outer * n * inner <= _micro.SMEM_MAX)
    assert (ow == 1 or (kw >= inner and mw >= m)) and (kw == 1 or mw >= m)
    os_max, kn_max, ms_max = min(ow, outer), min(kw, inner), min(mw, m)
    tiles_m, tiles_k = -(-m // ms_max), -(-inner // kn_max)
    tiles = -(-outer // os_max) * tiles_k * tiles_m
    box = os_max * ms_max * kn_max  # a block's outputs at most
    threads = box * groups if groups > 1 else _threads_for(box)
    assert threads <= 1024 and groups * chunk >= steps and tiles_k <= 65535 and -(-outer // os_max) * B <= 65535
    unroll = 1 if groups == 1 and chunk < 16 else 8  # one group of under two rounds of 8: unrolled once
    smem = (os_max * n * kn_max if shared else 0) + (groups * box if groups > 1 else 0)
    assert 4 * smem <= _micro.SMEM_MAX
    q_count, line = outer * m * inner, n * inner
    xs = _view(x, B * outer * line).reshape(B, outer, n, inner)
    qs = _view(q, B * q_count).reshape(B, outer, m, inner)
    os_ = _view(out, B * q_count).reshape(B, outer, m, inner)
    count = np.zeros((B, outer, m, inner, steps), np.uint8)
    for t in range(tiles):  # each block's box of outputs and each group's steps
        tk, j0 = t // tiles_m, t % tiles_m * ms_max
        o0, k0 = tk // tiles_k * os_max, tk % tiles_k * kn_max
        for g in range(groups):
            count[:, o0:o0 + os_max, j0:j0 + ms_max, k0:k0 + kn_max, g * chunk:(g + 1) * chunk] += 1
    total = np.zeros(qs.shape, np.uint32)
    for g in range(groups):  # the groups' partial sums, every tile side by side
        i0 = g * chunk
        length = max(0, min(steps - i0, chunk))
        r = qs % mod + i0 % mod  # numpy's % is the floor modulo, as the kernel's
        r = np.where(r >= mod, r - mod, r)
        acc = np.zeros((unroll, *r.shape), np.uint32)
        main = length - length % unroll
        for i in range(length):
            acc[i % unroll if i < main else 0] += np.take_along_axis(xs, r, axis=2).view(np.uint32)
            r = np.where(r + 1 == mod, 0, r + 1)
        total += acc.sum(axis=0, dtype=np.uint32)  # in shared memory
    os_[:] = total.view(np.int32)
    if taken is not None:
        taken.append(("gathers", count.reshape(B, q_count, steps)))


def _emu_onehot_min(x, q, out, B, D, inner, steps, mod, shared, kw, groups, chunk, taken=None):
    """``sdf_micro_onehot_min``: a block ``kw`` columns of an instance, the
    blocks in a shuffled order; its threads in ``groups`` groups, group g
    over the steps [g chunk, (g + 1) chunk), 8 accumulators (1 in one group
    of under 16 steps) and the tail into the first; a step one indexed load,
    min(x[r_i, k], 2^30), or 2^30 where r_i is no row; the groups' partial
    sums added in shared memory. ``taken`` (a list) receives ("gathers", the
    count of each (instance, column, step))."""
    assert shared == int(4 * D * inner <= _micro.SMEM_MAX)
    kn_max = min(kw, inner)
    tiles = -(-inner // kn_max)
    threads = kn_max * groups if groups > 1 else _threads_for(kn_max)
    assert threads <= 1024 and groups * chunk >= steps and B <= 65535
    assert 4 * ((D * kn_max if shared else 0) + (groups * kn_max if groups > 1 else 0)) <= _micro.SMEM_MAX
    unroll = 1 if groups == 1 and chunk < 16 else 8
    xs = _view(x, B * D * inner).reshape(B, D, inner)
    qs = _view(q, B * inner).reshape(B, inner)
    os_ = _view(out, B * inner).reshape(B, inner)
    count = np.zeros((B, inner, steps), np.uint8)
    order = [(b, t) for b in range(B) for t in range(tiles)]
    np.random.default_rng(tiles).shuffle(order)
    for b, t in order:
        k0 = t * kn_max
        k1 = min(inner, k0 + kn_max)
        cols, lane = xs[b, :, k0:k1], np.arange(k1 - k0)  # the block's columns (staged where shared)
        part = np.zeros((groups, k1 - k0), np.uint32)
        for g in range(groups):
            i0 = g * chunk
            length = max(0, min(steps - i0, chunk))
            r = qs[b, k0:k1].astype(np.int64)
            if mod:
                r = r % mod + i0 % mod  # numpy's % is the floor modulo, as the kernel's
                r = np.where(r >= mod, r - mod, r)
            acc = np.zeros((unroll, k1 - k0), np.uint32)
            main = length - length % unroll
            for i in range(length):
                row = (r >= 0) & (r < D)
                load = np.minimum(cols[np.clip(r, 0, D - 1), lane], _micro.BIG)
                acc[i % unroll if i < main else 0] += np.where(row, load, _micro.BIG).astype(np.uint32)
                count[b, k0:k1, i0 + i] += 1
                if mod:
                    r = np.where(r + 1 == mod, 0, r + 1)
            part[g] = acc.sum(axis=0, dtype=np.uint32)
        os_[b, k0:k1] = part.sum(axis=0, dtype=np.uint32).view(np.int32)  # in shared memory
    if taken is not None:
        taken.append(("gathers", count))


def _emu_onehot_write(x, q, v, out, B, D, inner, steps, mod, out_rows, shared, tile, taken=None):
    """``sdf_micro_onehot_write``. Shared: blocks of ``tile`` columns, each
    staged whole (D rows), each step one store w[r_i, k] = val (none where
    r_i lies outside [0, D)), then the out rows. Device memory (one step):
    blocks of ``tile`` rows streamed, each element d == r ? val : x.
    ``taken`` receives ("stores", the count of each (instance, column,
    step)) or ("writes", the count of each (instance, row, column))."""
    assert shared == int(4 * D * inner <= _micro.SMEM_MAX)
    xs = _view(x, B * D * inner).reshape(B, D, inner)
    qs = _view(q, B * inner).reshape(B, inner)
    vs = None if v is None else _view(v, B * inner).reshape(B, inner)
    os_ = _view(out, B * out_rows * inner).reshape(B, out_rows, inner)
    if shared:
        cols = min(tile, inner)
        assert D * cols * 4 <= _micro.SMEM_MAX
        count = np.zeros((B, inner, steps), np.uint8)
        for k0 in range(0, inner, cols):
            k1 = min(inner, k0 + cols)
            w = xs[:, :, k0:k1].copy()  # the staged columns
            r = qs[:, None, k0:k1] % mod if mod else qs[:, None, k0:k1].copy()
            for i in range(steps):
                hit = (r >= 0) & (r < D)
                val = np.full(r.shape, i, np.int32) if vs is None else vs[:, None, k0:k1]
                rc = np.clip(r, 0, D - 1)
                np.put_along_axis(w, rc, np.where(hit, val, np.take_along_axis(w, rc, axis=1)), axis=1)
                count[:, k0:k1, i] += hit[:, 0]
                if mod:
                    r = np.where(r + 1 == mod, 0, r + 1)
            os_[:, :, k0:k1] = w[:, :out_rows]
    else:
        assert steps <= 1 and out_rows == D
        rows = min(tile, D)
        assert _threads_for(rows * inner // (4 if inner % 4 == 0 else 1)) <= 1024
        count = np.zeros((B, D, inner), np.uint8)
        r = qs[:, None] % mod if mod else qs[:, None]
        val = np.zeros_like(r) if vs is None else vs[:, None]
        for d0 in range(0, D, rows):
            d1 = min(D, d0 + rows)
            d = np.arange(d0, d1).reshape(1, -1, 1)
            os_[:, d0:d1] = np.where((steps > 0) & (d == r), val, xs[:, d0:d1])
            count[:, d0:d1] += 1
    if taken is not None:
        taken.append(("stores" if shared else "writes", count))


def _emu_row_scan(x, out, B, outer, n, inner, ow, kw, runs, r, taken=None):
    """``sdf_micro_row_scan``: blocks of a box of columns (``ow`` rows o, or
    ``kw`` columns k of one o), the rows in chunks of ``runs`` runs of ``r``.
    With runs == 1 each column's recurrence row by row; else each run's m,
    the recurrence from n over its x clamped at n, the exclusive prefix
    minimum of m_i - (i + 1) r in int64 from the chunk's carry, each run's
    carry j r + that, applied to its rows, and the next chunk's carry from
    the whole chunk. The boxes' columns are taken side by side (a column's
    result depends on no other). ``taken`` (a list) receives ("reads and
    writes", the count of each (instance, element)'s load and store)."""
    assert 0 < n < 1 << 30 and (ow == 1 or kw >= inner) and (runs == 1 or r <= _micro.ROW_SCAN_RUN)
    os_max, kn_max, r = min(ow, outer), min(kw, inner), n if runs == 1 else min(r, n)  # runs == 1: r unused
    assert os_max * kn_max * runs <= 1024 and -(-outer // os_max) * B <= 65535
    xs = _view(x, B * outer * n * inner).reshape(B, outer, n, inner)
    os_ = _view(out, xs.size).reshape(xs.shape)
    count = np.zeros((2, B, outer, n, inner), np.uint8)
    chunk = runs * r
    for o0 in range(0, outer, os_max):  # each block's threads: its box's columns in each run of each chunk
        for k0 in range(0, inner, kn_max):
            for a in range(0, n, chunk):
                for j in range(runs):
                    count[:, :, o0:o0 + os_max, a + j * r:min(n, a + (j + 1) * r), k0:k0 + kn_max] += 1
    carry = np.zeros((B, outer, inner), np.int64)
    for a in range(0, n, chunk):
        if runs == 1:
            for i in range(a, min(n, a + r)):
                carry = np.minimum(carry + 1, xs[:, :, i])
                os_[:, :, i] = carry
            continue
        lows = []
        for j in range(runs):
            m = np.full(carry.shape, n, np.int64)
            for i in range(a + j * r, min(n, a + (j + 1) * r)):
                m = np.minimum(m + 1, np.minimum(xs[:, :, i], n))
            lows.append(m - (j + 1) * r)
        low = carry
        for j in range(runs):
            o = j * r + low  # the run's carry-in, from the prefix before it
            for i in range(a + j * r, min(n, a + (j + 1) * r)):
                o = np.minimum(o + 1, xs[:, :, i])
                assert o.min() >= -(1 << 31) and o.max() <= i + 1
                os_[:, :, i] = o
            low = np.minimum(low, lows[j])
        carry = chunk + low
    if taken is not None:
        taken.append(("reads and writes", count.reshape(2, B, -1)))


EMULATED = {
    "sdf_micro_ops": _emu_ops, "sdf_micro_gather": _emu_gather, "sdf_micro_onehot_min": _emu_onehot_min,
    "sdf_micro_onehot_write": _emu_onehot_write, "sdf_micro_row_scan": _emu_row_scan,
}


@pytest.mark.parametrize("key", list(PROBES))
def test_kernel_arguments_emulated(key, monkeypatch):
    """The kernel's launch on CPU tensors, its C entry point emulated: the
    arguments in ``SIGNATURES`` order and the kernel's index arithmetic
    give the plain version's result."""
    calls = []

    def emulate(name, device, fn, *args):
        assert len(args) + 1 == len(_build.SIGNATURES[fn])  # + the stream
        calls.append(name)
        EMULATED[fn](*args)

    monkeypatch.setattr(_build, "launch", emulate)
    monkeypatch.setattr(_micro, "sm_count", lambda device: H100_SMS)
    p = PROBES[key]
    args = p.inputs(2, "cpu")
    got = p.launch(*args)
    assert calls == [f"probe_{key}"]
    want = p.plain(*args)
    assert got.dtype == want.dtype and got.shape == want.shape == (2, *p.out_shape)
    assert torch.equal(got, want)


def _uneven_inputs(x_shape, q_shape, mod):
    x = np.arange(np.prod(x_shape), dtype=np.int32).reshape(x_shape) * 3 - 1000
    q = (np.arange(np.prod(q_shape), dtype=np.int32).reshape(q_shape) * 13 - 7) % mod
    return x, q


# steps no multiple of the kernel's 8-load unroll or of the geometry's chunk; one-hot writes
# and minima with a modulus under D and over it (indices past the last row write nothing,
# select nothing), columns no multiple of a warp, and a streamed pass whose rows are no
# multiple of 4 wide; a row scan whose columns are no multiple of 8 and rows no multiple of a
# run, and G8's chain on lanes no multiple of a warp, both on x at the int32 extremes (phase
# 13's `chip_smoke.extreme_probes`, keys X-scan and X-ops)
UNEVEN = {
    "U1": _micro.gather("U1", "x (64,128) ax0 idx (8,128), 37 steps", "-",
                        partial(_uneven_inputs, (64, 128), (8, 128), 64), axis=0, steps=37, mod=64),
    "U2": _micro.gather("U2", "x (512,128) ax1 idx (512,3), 100 steps", "-",
                        partial(_uneven_inputs, (512, 128), (512, 3), 128), axis=1, steps=100, mod=128),
    "U3": _micro.gather("U3", "x (8,48) ax1, 19 steps", "-", partial(_uneven_inputs, (8, 48), (8, 48), 48), axis=1,
                        steps=19, mod=48),
    "U4": _micro.onehot_write("U4", "one-hot write (64,96), 37 steps mod 50", "-",
                              partial(_uneven_inputs, (64, 96), (1, 96), 50), steps=37, mod=50, first_row=True),
    "U5": _micro.onehot_write("U5", "one-hot write (5,40), 9 steps mod 7", "-",
                              partial(_uneven_inputs, (5, 40), (1, 40), 7), steps=9, mod=7),
    "U6": _micro.onehot_write("U6", "one-hot scatter [512,1,125]", "-",
                              lambda: (*_uneven_inputs((512, 1, 125), (1, 1, 125), 512),
                                       np.arange(125, dtype=np.int32).reshape(1, 1, 125) + 5)),
    "U7": _micro.onehot_min("U7", "one-hot min (50,40), 37 steps mod 61", "-",
                            partial(_uneven_inputs, (50, 40), (1, 40), 61), steps=37, mod=61),
    "U8": _micro.onehot_min("U8", "one-hot min [5,3,40], 9 steps at q", "-",
                            partial(_uneven_inputs, (5, 3, 40), (1, 3, 40), 5), steps=9),
    **{p.key: p for p in chip_smoke.extreme_probes()},
}
REDESIGNED = [k for k, p in PROBES.items() if p.geometry is not None]


def _geometry_cases():
    """(probe, batch, SMs): B = 1 on an H100, and the two batches either
    side of the first switch of the geometry on one SM (B = 2 for a probe
    whose launch never switches)."""
    cases = []
    for key in [*REDESIGNED, *UNEVEN]:
        p = PROBES.get(key) or UNEVEN[key]
        switch = _micro.switch_batch(p, 1) or 2
        cases += [(key, 1, H100_SMS), *[(key, b, 1) for b in sorted({max(1, switch - 1), switch})]]
    return cases


@pytest.mark.parametrize("key, batch, sms", _geometry_cases())
def test_geometry_emulated(key, batch, sms, monkeypatch):
    """A redesigned kernel's launch emulated block by block as its geometry
    tiles it: every (output, step) gather, or every step's store of a
    column (every element's write of a one-step pass), is taken exactly
    once, and the result is the plain version's."""
    p = PROBES.get(key) or UNEVEN[key]
    taken = []

    def emulate(name, device, fn, *args):
        assert len(args) + 1 == len(_build.SIGNATURES[fn])
        EMULATED[fn](*args, taken=taken)

    monkeypatch.setattr(_build, "launch", emulate)
    monkeypatch.setattr(_micro, "sm_count", lambda device: sms)
    args = p.inputs(batch, "cpu")
    got = p.launch(*args)
    want = p.plain(*args)
    assert got.shape == want.shape == (batch, *p.out_shape) and torch.equal(got, want)
    ((kind, count),) = taken
    if kind == "stores":  # one store each step whose index is a row
        q = args[1].reshape(batch, -1).numpy()
        D, mod = p.in_shapes[0][0], p.index[1]
        r = (q[:, :, None] % mod + np.arange(p.steps).reshape(1, 1, -1)) % mod
        np.testing.assert_array_equal(count, (r < D).astype(np.uint8))
    else:  # every gather of an (output, step), or every element of a streamed pass, once
        assert (count == 1).all()
        if kind == "gathers":
            assert count.shape == (batch, math.prod(args[1].shape[1:]), p.steps)
    g = p.geometry(batch, sms)
    if g.groups > 1 and p.kernel == "micro_row_scan":  # a column's rows split: runs of r rows held a thread
        runs, r = g.args[-2:]
        assert g.groups == runs and r <= _micro.ROW_SCAN_RUN and r * (runs - 1) < p.steps
    elif g.groups > 1:  # the steps split: every group takes some, each as many but the last
        chunk = g.args[-1]
        assert p.kernel in ("micro_gather", "micro_onehot_min")
        assert chunk * (g.groups - 1) < p.steps <= chunk * g.groups


@pytest.mark.parametrize("D, inner, steps, mod, sms", [
    (64, 1024, 64, None, H100_SMS), (64, 128, 512, 64, H100_SMS), (7, 40, 9, None, 1), (7, 96, 37, 11, H100_SMS),
    (12, 33, 20, 5, 1), (3, 64, 1, None, H100_SMS)])
def test_onehot_min_select_is_one_load(D, inner, steps, mod, sms, monkeypatch):
    """A one-hot minimum step as one indexed load, min(x[r_i, k], 2^30),
    2^30 where r_i is no row: on seeded x with values over 2^30 (and under
    0) and q under 0 and at or past D (no modulus; with one, the modulus
    under D and past it), the kernel's launch, emulated block by block,
    equals ``onehot_min_plain`` at B = 3, unsigned sums wrapping alike."""
    rng = np.random.default_rng(D * 1000 + inner + steps)
    x = rng.integers(-(1 << 31), (1 << 31) - 1, (3, D, inner), dtype=np.int64)
    x[:, :, ::3] = rng.integers(1 << 30, (1 << 31) - 1, (3, D, len(range(0, inner, 3))))  # at or past 2^30
    q = rng.integers(-2 * D, 2 * D, (3, 1, inner))
    q[:, :, :4] = [-1, D, 0, D - 1]
    x, q = (torch.from_numpy(a.astype(np.int32)) for a in (x, q))
    assert (q < 0).any() and (q >= D).any() and (x >= _micro.BIG).any()
    taken = []
    monkeypatch.setattr(_build, "launch", lambda name, device, fn, *args: _emu_onehot_min(*args, taken=taken))
    monkeypatch.setattr(_micro, "sm_count", lambda device: sms)
    got = _micro.onehot_min_kernel("T", x, q, steps, mod)
    assert torch.equal(got, _micro.onehot_min_plain(x, q, steps, mod))
    ((_, count),) = taken
    assert (count == 1).all() and count.shape == (3, inner, steps)


ROW_SCAN_BOXES = {"columns": (1, 8), "rows": (2, 13)}  # (ow, kw) on x [3, 2, n, 13]: 8 columns k, or whole rows o


@pytest.mark.parametrize("box", list(ROW_SCAN_BOXES))
@pytest.mark.parametrize("r", [1, 3, 16, "n"])
@pytest.mark.parametrize("n", [1, 2, 37, 512, 1000])
def test_row_scan_min_plus_decomposition(n, r, box):
    """The blocked min-plus scan of ``micro_row_scan``, emulated block by
    block: on x over the whole int32 range with runs of INT32_MIN and
    INT32_MAX, columns no multiple of 8, runs of 1, 3 and 16 rows (as many
    runs as a block holds, so that long columns take several chunks) and a
    thread a column (r = n), at B = 3 it equals ``row_scan_plain``
    bitwise, and every element is read once and written once."""
    ow, kw = ROW_SCAN_BOXES[box]
    x = torch.from_numpy(chip_smoke.int32_extremes((3, 2, n, 13), n))
    runs = 1 if r == "n" else min(-(-n // r), 1024 // (min(ow, 2) * kw))
    r = n if r == "n" else r
    out = torch.empty_like(x)
    taken = []
    _emu_row_scan(x.data_ptr(), out.data_ptr(), 3, 2, n, 13, ow, kw, runs, r, taken=taken)
    assert torch.equal(out, _micro.row_scan_plain(x, axis=1))
    assert (x == np.iinfo(np.int32).min).any() and (x == np.iinfo(np.int32).max).any()
    ((_, count),) = taken
    assert (count == 1).all() and count.shape == (2, 3, x[0].numel())


@pytest.mark.parametrize("sms", [1, H100_SMS])
def test_ops_chain_wraps_at_the_extremes(sms, monkeypatch):
    """G8's chain, emulated block by block as ``lane_geometry`` tiles it, on
    x at the int32 extremes (x + i and the doubling wrap) at B = 3 equals
    ``ops_plain``, each lane read and written once."""
    x = torch.from_numpy(chip_smoke.int32_extremes((3, 40), 8))
    assert (x == np.iinfo(np.int32).max).any() and (x == np.iinfo(np.int32).min).any()
    taken = []
    monkeypatch.setattr(_build, "launch", lambda name, device, fn, *args: _emu_ops(*args, taken=taken))
    monkeypatch.setattr(_micro, "sm_count", lambda device: sms)
    got = _micro.ops_kernel("T", x, 512)
    assert torch.equal(got, _micro.ops_plain(x, 512))
    ((_, count),) = taken
    assert (count == 1).all() and count.shape == (2, 3, 40)


def test_geometry_rule():
    """B = 1 spreads an instance over the card; B_fill takes one block an
    instance, the one-block design's launch (its steps in one group but
    where an instance has under 256 outputs)."""
    fill = _micro.FILL_BLOCKS_PER_SM * H100_SMS
    for key in REDESIGNED:
        p = PROBES[key]
        g = p.geometry(fill, H100_SMS)
        assert g.tiles == 1 and (g.groups == 1 or math.prod(p.out_shape) < 256)
        g = p.geometry(1, H100_SMS)
        assert g.tiles < 2 * fill  # 4 x SMs blocks wanted, rounded up to whole boxes
    geometry = {k: tuple(PROBES[k].geometry(1, H100_SMS)) for k in ("E1b", "G1", "G5", "H2", "H3", "H8", "E6")}
    assert geometry["E1b"] == (128, 32, (1, 8, 1, 32, 16))  # 8 columns a block, 32 groups of 16 steps
    assert geometry["G1"] == (128, 32, (1, 1, 8, 32, 16))  # one column k, its 8 outputs j
    assert geometry["H2"] == (640, 16, (1, 1, 13, 16, 16))  # 13 outputs j of a column; its 64 rows staged
    assert geometry["H3"] == (640, 3, (1, 1, 103, 3, 86))  # 103 outputs j of a column of x, in 3 groups
    assert geometry["H8"] == (1024, 3, (1, 1, 64, 3, 86))  # 64 outputs j of a row of x, in 3 groups
    assert geometry["G5"] == (4, 1, (32,)) and geometry["E6"] == (512, 1, (1,))
    assert _micro.switch_batch(PROBES["E1b"], H100_SMS) == 5  # from there fewer tiles than 128
    assert _micro.switch_batch(PROBES["H6"], H100_SMS) is None  # one block of 16 groups at every batch
    # the row scans: boxes of 8 columns, 32 runs of 16 rows (E4b and G7 as E4); G8: a warp a block
    geometry = {k: tuple(PROBES[k].geometry(1, H100_SMS)) for k in ("E4", "E4b", "G6", "G7", "G8")}
    assert geometry["E4"] == geometry["E4b"] == geometry["G7"] == (128, 32, (1, 8, 32, 16))
    assert geometry["G6"] == (16, 32, (1, 8, 32, 16)) and geometry["G8"] == (32, 1, (32,))
    assert [_micro.switch_batch(PROBES[k], H100_SMS) for k in ("E4", "E4b", "G6", "G7", "G8")] == [5, 5, 36, 5, 18]
    for key, (outer, n, inner) in {"E4": (8, 512, 128), "E4b": (1, 512, 1024), "G6": (1, 512, 128),
                                   "G7": (1, 512, 1024)}.items():  # from B_fill on: a thread a column, all rows
        ow, kw, runs, r = PROBES[key].geometry(fill, H100_SMS).args
        assert (min(ow, outer) * min(kw, inner), runs, r) == (outer * inner, 1, n)
    assert PROBES["G8"].geometry(fill, H100_SMS).args == (1024,)
    for outer, inner in ((3, 600), (2, 3000), (40, 40)):  # wider than a block: boxes of 1024 columns at most
        ow, kw, runs, _ = _micro.row_scan_geometry(fill, outer, 10, inner, H100_SMS).args
        assert min(ow, outer) * min(kw, inner) * runs <= 1024


# ---- the wrapper ----------------------------------------------------------------


@pytest.mark.parametrize("key", list(PROBES))
def test_batch_of_three_is_three_calls(key):
    p = PROBES[key]
    args = p.inputs(3, "cpu")
    for a, b in zip(args, _batched(p.build())):
        assert torch.equal(a[:1], b)  # instance 0 is the JAX probe's
    assert not torch.equal(args[0][0], args[0][1])
    got = p(*args)
    assert got.shape == (3, *p.out_shape)
    for b in range(3):
        assert torch.equal(got[b : b + 1], p(*[a[b : b + 1].contiguous() for a in args]))


@pytest.mark.parametrize("key", [k for k, p in PROBES.items() if p.library is not None])
def test_library_call_computes_the_probe(key):
    """``torch.gather`` (E1-E3), ``torch.sum`` over the gathered axis where
    the window covers it (E1b, G1, G2, H5) and ``Tensor.scatter`` (E6), the
    calls timed beside the kernels on the card, equal the plain version at
    B = 1, 2 and 3."""
    p = PROBES[key]
    for batch in (1, 2, 3):
        args = p.inputs(batch, "cpu")
        assert torch.equal(p.library(*p.library_args(args)), p.plain(*args))


def test_cpu_takes_the_plain_version_and_counts_no_launch(monkeypatch):
    def refuse(*args):
        raise AssertionError("a CPU tensor reached a kernel launch")

    monkeypatch.setattr(_build, "launch", refuse)
    _build.reset_launches()
    for name in _micro.KERNELS:  # the dispatch is the Probe's, one probe of each kernel
        p = next(p for p in PROBES.values() if p.kernel == name)
        args = p.inputs(1, "cpu")
        assert torch.equal(p(*args), p.plain(*args))
    assert not any(_build.LAUNCHES.values())


def test_wrapper_rejects_bad_inputs():
    p = PROBES["E3"]
    x, q = p.inputs(2, "cpu")
    with pytest.raises(TypeError):
        p(x.long(), q)
    with pytest.raises(TypeError):
        p(x)
    with pytest.raises(ValueError):
        p(x, q[:1])
    with pytest.raises(ValueError):
        p(x.transpose(1, 2), q)
    with pytest.raises(TypeError):
        p(x[0], q[0])


def test_bound_counts_each_byte_once():
    """Each needed input element read once, the output written once: of
    x, only the elements the output depends on (this data's)."""
    def x_needed(p):  # elements of x (the first input) the output depends on: the rest of the own bytes
        shared, own, shared_ops = p.need
        assert shared == shared_ops == 0
        return own // 4 - sum(math.prod(s) for s in p.in_shapes[1:])

    p = PROBES["E6"]  # x [512, 8, 128], q and v [1, 8, 128] in, x's shape out; row 77 overwritten
    assert x_needed(p) == 511 * 1024 and p.bytes() == 4 * (511 * 1024 + 2 * 1024 + 512 * 1024)
    assert x_needed(PROBES["E1"]) == x_needed(PROBES["E2"]) == 1024  # one row of x gathered
    assert x_needed(PROBES["E5"]) == 1024  # every step selects row 7
    assert x_needed(PROBES["G5"]) == 0  # row 0 is overwritten in every column
    assert x_needed(PROBES["E1b"]) == x_needed(PROBES["E4"]) == 512 * 1024
    ms, by = p.bound(528)
    assert by == "bytes" and ms == pytest.approx(528 * p.bytes() / 3.35e12 * 1e3)
    g8 = PROBES["G8"]  # 4 operations an element-step, 8 KiB moved
    assert g8.ops == 4 * 1024 * 512 and g8.bound()[1] == "operations"
    # a one-hot min is x[q_i]: the select and the sum an element-step (E5), q + i and the modulus besides (G4)
    assert PROBES["E5"].ops == 2 * 1024 * 64 and PROBES["G4"].ops == 4 * 128 * 512
    # a one-hot write changes one row a column: the write (E6), q + i and the modulus besides (G5)
    assert p.ops == 1024 and PROBES["G5"].ops == 3 * 128 * 512
    assert [PROBES[k].bound()[1] for k in ("E5", "G4", "G5")] == ["bytes", "bytes", "operations"]
    assert {p.memory for p in PROBES.values() if p.kernel == "micro_gather"} == {
        "shared memory (staged once)", "device memory through L1/L2"}
    assert [k for k, p in PROBES.items() if p.memory.startswith("device memory through")] == [
        "E2", "E1", "E1b", "E5", "E6", "G1", "G2", "H3", "H8"]


@pytest.mark.parametrize("module", MODULES, ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_main_on_the_cpu(module, capsys):
    result = module.main(["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert result["device"] == "cpu" and result["b_fill"] == _micro.NOT_MEASURED
    assert list(result["probes"]) == [p.key for p in module.PROBES]
    for p, text in zip(module.PROBES, lines[1:]):
        assert text.startswith(f"{p.label}: OK not measured")
        rec = result["probes"][p.key]
        assert all(rec[k] == _micro.NOT_MEASURED
                   for k in ("ms", "launch_ms", "us_per_step", "fill_ms", "ns_per_element_step"))
