"""The render-design probes of the port (``sdf_tools_tpu_torch/scripts/
probe_smem_block.py``, ``probe_dma_align.py``, ``bench_micro_render{,2,3,4,5,6}.py``;
kernels in ``csrc/micro_render.cu``) against the JAX scripts' TPU probes
(``scripts/`` of the same names), on the CPU.

  * Each builder gives the JAX script's inputs, bit for bit (its ``main``'s
    draws, captured where it hands them to its kernel; R6's volume cut to
    its first 16 planes, the rest of its draws skipped on both sides).
  * Each plain version, on those numpy inputs, meets the JAX probe run with
    its ``pallas_call`` in interpret mode, at the cut sizes ROWS, STEPS = 8,
    2 (R4: 8 rows, G = 2), 16 iterations (R5, R6) and a (16, 512, 512)
    volume with x-bases below 7 (R6): bitwise where both add in one order,
    else within the ulps stated in JAX_ULPS (the order of XLA's CPU
    reductions; R6 ``sample9``: XLA's FMA contraction of its combine,
    which a numpy FMA form reproduces bit for bit).
  * ``mxu`` equals ``full``, ``unroll8`` equals ``dyn2d``, ``dma_ovl``
    equals ``dma``.
  * Each kernel's launch arguments, run through a numpy emulation of its C
    entry point (the kernel's index arithmetic, its summation tree, its
    chain, the bulk copies' runs and dma_ovl's ring), equal the plain
    version on a batch of 2; the CUDA source itself runs only on the card
    (``chip_smoke.py`` phase 14).
  * The kernels that spread an instance over blocks (the band sums, the
    sampler, R6's copies) block by block in a shuffled order, as their
    geometry tiles them: every item or iteration taken once, then the
    chain; R6 ``smem_rw``'s counters start where a count from iteration 0
    has them.
  * The wrapper: a batch of 3 equals three batches of 1 and instance 0 is
    the JAX probe's; a CPU tensor takes the plain version and counts no
    launch; each module's ``main`` runs on the CPU.
  * The three faults of the JAX probes (ROADMAP C) are pinned: R2 ``mxu``
    raises; R3 ``dynrot`` reads another band than ``dyn2d`` at zbase 128;
    R6 ``smem_rw`` reads counters it never initialises (the port
    zero-fills them).

The JAX scripts are loaded by path (``scripts/`` is no package) and stay
as they are.
"""
import contextlib
import ctypes
import functools
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.experimental import pallas as jpl
from jax.experimental.pallas import tpu as pltpu
import torch

from sdf_tools_tpu_torch import _build
from sdf_tools_tpu_torch.scripts import (_micro, _sampler, bench_micro_render, bench_micro_render2, bench_micro_render3,
                                         bench_micro_render4, bench_micro_render5, bench_micro_render6, probe_dma_align,
                                         probe_smem_block)

REPO = Path(__file__).resolve().parents[1]
MODULES = (probe_smem_block, probe_dma_align, bench_micro_render, bench_micro_render2, bench_micro_render3,
           bench_micro_render4, bench_micro_render5, bench_micro_render6)
PROBES = {p.key: p for m in MODULES for p in m.PROBES}
ROWS, STEPS, GROUPS, ITERS, NX = 8, 2, 2, 16, 16  # the cut sizes
H100_SMS = 132
STEPS_OF = {"R1": 256, "R2": 128, "R3": 128}  # the nested probes' steps, which repeat their ROWS items
# ulps between the plain version and the JAX probe in interpret mode at the cut sizes (0 elsewhere): the
# order of XLA's CPU reductions of a band, of a column gather or of a row's samples; R6 sample9: XLA's FMAs
JAX_ULPS = {"R2-loadtaa": 3, "R3-smalldyn": 1, "R3-dynrow": 3, "R3-dyncol": 1, "R4-tab_full": 1, "R6-sample9": 2}
V, S = pltpu.VMEM, pltpu.SMEM


def cut(key: str) -> _micro.Probe:
    """The probe ``key`` at the cut sizes (S1, S2, D1: as they are)."""
    family, _, variant = key.partition("-")
    if family == "R1":
        return bench_micro_render.probe(ROWS, STEPS)
    if family == "R2":
        return bench_micro_render2.probe(variant, ROWS, STEPS)
    if family == "R3":
        return bench_micro_render3.probe(variant, ROWS, STEPS)
    if family == "R4":
        return bench_micro_render4.probe(variant, ROWS, GROUPS)
    if family == "R5":
        return bench_micro_render5.probe(variant, ITERS, None)
    if family == "R6":
        return bench_micro_render6.probe(variant, ITERS, None, NX)
    return PROBES[key]


@pytest.fixture(autouse=True)
def one_thread():
    """The plain versions loop over many small ops: one intra-op thread
    each, so that the test workers sharing the host's cores do not
    oversubscribe them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@contextlib.contextmanager
def _interpret(record=None):
    """``pallas_call`` in interpret mode; with ``record``, each call's
    arguments and output appended to it."""
    real = jpl.pallas_call

    def patched(*a, **kw):
        fn = real(*a, **{**kw, "interpret": True})
        if record is None:
            return fn

        def run(*args):
            out = fn(*args)
            record.append(([np.asarray(x) for x in args], np.asarray(out)))
            return out

        return run

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpl, "pallas_call", patched)
        yield


def _load(name: str):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@functools.cache
def _jax_script(name: str):
    return _load(name)


@functools.cache
def _smem_block_calls():
    """probe_smem_block.py runs both probes when imported: their arguments
    and outputs, and its printed lines."""
    calls = []
    with _interpret(calls), contextlib.redirect_stdout(None):
        _load("probe_smem_block")
    return calls


@functools.cache
def _dma_align_call():
    calls = []
    with _interpret(calls), contextlib.redirect_stdout(None):
        _jax_script("probe_dma_align").main()
    return calls[0]


def _call(kernel, args, in_specs, out_shape=(1, 1), out_space=S, scratch=()):
    return np.asarray(jpl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct(out_shape, jnp.float32),
        in_specs=[jpl.BlockSpec(memory_space=m) for m in in_specs], out_specs=jpl.BlockSpec(memory_space=out_space),
        scratch_shapes=scratch, interpret=True)(*args))


def _r6_scratch():
    P, BY, BZ = _sampler.R6_BAND
    return [pltpu.VMEM((P, BY, BZ), jnp.bfloat16), pltpu.VMEM((P, BY, BZ), jnp.bfloat16), pltpu.SMEM((128,), jnp.int32),
            pltpu.SemaphoreType.DMA, pltpu.SemaphoreType.DMA]


def _jax_args(key: str):
    args = list(cut(key).build())
    if key.startswith("R6"):
        args[1] = jnp.asarray(args[1], jnp.bfloat16)
    return args


@functools.cache
def jax_output(key: str) -> np.ndarray:
    """The JAX probe ``key`` at the cut sizes, in interpret mode, on the
    port's cut inputs (S1, S2, D1: the scripts' own calls)."""
    if key in ("S1", "S2"):
        return _smem_block_calls()[0 if key == "S1" else 1][1]
    if key == "D1":
        return _dma_align_call()[1]
    family, _, variant = key.partition("-")
    args = _jax_args(key)
    with pytest.MonkeyPatch.context() as mp:
        if family == "R1":
            m = _jax_script("bench_micro_render")
            mp.setattr(m, "ROWS", ROWS)
            mp.setattr(m, "STEPS", STEPS)
            return _call(m.kernel, args, [V] * 3)
        if family in ("R2", "R3"):
            m = _jax_script("bench_micro_render2" if family == "R2" else "bench_micro_render3")
            mp.setattr(m, "ROWS", ROWS)
            mp.setattr(m, "STEPS", STEPS)
            kernel = m.make_unroll_kernel() if variant == "unroll8" else m.make_kernel(variant)
            return _call(kernel, args, [V] * 3)
        if family == "R4":
            m = _jax_script("bench_micro_render4")
            mp.setattr(m, "ROWS", ROWS)
            mp.setattr(m, "G", GROUPS)
            return _call(m.make_kernel(variant), args, [S, S, V, V, V])
        if family == "R5":
            return _call(_jax_script("bench_micro_render5").make_kernel(variant, ITERS), args, [S, S, V, V, V, V])
        return _call(_jax_script("bench_micro_render6").make_kernel(variant, ITERS), args, [S, jpl.ANY, V, V],
                     (1, 128), V, _r6_scratch())


def _ulps(a, b) -> int:
    a = np.ascontiguousarray(a, np.float32).ravel().view(np.int32).astype(np.int64)
    b = np.ascontiguousarray(b, np.float32).ravel().view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max())


def _plain1(p: _micro.Probe) -> np.ndarray:
    return p.plain(*p.inputs(1, "cpu"))[0].numpy()


def test_every_variant_once():
    assert len(PROBES) == 30 and list(PROBES) == [p.key for m in MODULES for p in m.PROBES]
    assert {p.kernel for p in PROBES.values()} == set(_sampler.KERNELS)
    assert {k: sum(p.kernel == k for p in PROBES.values()) for k in _sampler.KERNELS} == {
        "micro_band_sum": 16, "micro_sampler": 8, "micro_band_copy": 6}
    assert all(p.lo is not None for k, p in PROBES.items() if k[:2] in ("R5", "R6"))


# ---- the builders give the JAX scripts' inputs ---------------------------------------


class _Captured(Exception):
    pass


def _capture(*args):
    raise _Captured(args)


class _CutRng:
    """A generator whose (512, 512, 512) draw keeps its first NX planes and
    skips the rest (one 64-bit draw a double), as the port's cut builder."""

    def __init__(self, rng):
        self._rng = rng

    def random(self, size=None):
        if size == (512, 512, 512):
            out = self._rng.random((NX, 512, 512))
            self._rng.bit_generator.advance((512 - NX) * 512 * 512)
            return out
        return self._rng.random(size)

    def __getattr__(self, name):
        return getattr(self._rng, name)


def _main_inputs(name: str):
    """The inputs the JAX script's ``main`` hands to its kernel."""
    m = _jax_script(name)
    real_rng = np.random.default_rng
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(m, "run" if name == "bench_micro_render" else "run_variant", _capture)
        if name == "bench_micro_render6":
            mp.setattr(np.random, "default_rng", lambda seed: _CutRng(real_rng(seed)))
        mp.setattr(sys, "argv", [name])
        with pytest.raises(_Captured) as got:
            m.main()
    args = got.value.args[0]
    args = args[1] if name in ("bench_micro_render5", "bench_micro_render6") else args[int(name != "bench_micro_render"):]
    return [np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a) for a in args]


@pytest.mark.parametrize("module", MODULES, ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_build_gives_the_jax_inputs(module):
    name = module.__name__.rsplit(".", 1)[1]
    if name == "probe_smem_block":
        want = [_smem_block_calls()[0][0], _smem_block_calls()[1][0]]
        got = [probe_smem_block.s1_inputs(), probe_smem_block.s2_inputs()]
    elif name == "probe_dma_align":
        want, got = [_dma_align_call()[0]], [probe_dma_align.inputs()]
    else:
        want, got = [_main_inputs(name)], [module.PROBES[0].build() if name != "bench_micro_render6" else
                                           bench_micro_render6.inputs(NX)]
    for w, g in zip(want, got):
        assert len(w) == len(g)
        for j, (a, b) in enumerate(zip(w, g)):
            if name == "bench_micro_render6" and j == 0:  # the cut: x-bases modulo NX - 9
                a = (a // 65536) % (NX - 9) * 65536 + a % 65536
            if name == "bench_micro_render6" and j == 1:  # the probe's bfloat16, as JAX rounds it
                b = torch.from_numpy(b).to(torch.bfloat16).float().numpy()
            assert a.shape == b.shape and a.dtype == b.dtype, (j, a.shape, b.shape, a.dtype, b.dtype)
            np.testing.assert_array_equal(a, b)


# ---- the plain versions against the JAX probes ------------------------------------------


@pytest.mark.parametrize("key", list(PROBES))
def test_plain_equals_the_jax_probe(key):
    p = cut(key)
    got = _plain1(p)
    want_key = "R2-full" if key == "R2-mxu" else key  # JAX's mxu does not trace (test_jax_mxu_raises)
    if key == "R6-smem_rw":  # JAX's output is its uninitialised counters' (test_jax_smem_rw_reads_its_fill)
        want = np.full((1, 128), float(sum(i // 128 for i in range(ITERS))), np.float32)
    else:
        want = jax_output(want_key).reshape(p.out_shape)
    assert got.dtype == np.float32 and got.shape == want.shape == p.out_shape
    assert np.isfinite(got).all()
    assert _ulps(got, want) == JAX_ULPS.get(key, 0), (key, got.ravel()[:4], want.ravel()[:4])


@pytest.mark.parametrize("a,b", [("R2-mxu", "R2-full"), ("R3-unroll8", "R3-dyn2d"), ("R6-dma_ovl", "R6-dma")])
def test_variant_pairs_are_equal(a, b):
    pa, pb = cut(a), cut(b)
    assert PROBES[a].in_shapes == PROBES[b].in_shapes and PROBES[a].steps == PROBES[b].steps
    args = pa.inputs(2, "cpu")
    assert torch.equal(pa.plain(*args), pb.plain(*args))


def test_sample9_differs_from_jax_by_its_fma_contraction():
    """JAX's interpret-mode sample9 contracts the combine's products and sums
    into FMAs (XLA on the CPU): a numpy form with those FMAs equals it bit
    for bit; the port's plain version and kernel round each op apart
    (-fmad=false)."""
    tab, vol, y, z = cut("R6-sample9").build()
    volb = torch.from_numpy(vol).to(torch.bfloat16).float().numpy()
    f32, f64 = np.float32, np.float64
    acc = np.zeros(128, f32)
    for i in range(ITERS):
        pk = int(tab[i])
        xb, yb, zb = pk // 65536, (pk // 4) % 64 * 8, pk % 4 * 128
        y0, z0 = np.floor(y[i & 127]).astype(np.int32), np.floor(z[i & 127]).astype(np.int32)
        ry, zi = np.clip(y0 % 32, 0, 30), np.clip(z0 % 128, 0, 253)
        v00, v10 = volb[xb + 3, yb + ry, zb + zi], volb[xb + 3, yb + ry + 1, zb + zi]
        fy, fz = y[i & 127] - y0.astype(f32), z[i & 127] - z0.astype(f32)
        gy, gz = f32(1) - fy, f32(1) - fz
        F = (f64(v00 * gy * gz) + f64(v00 * gy) * f64(fz)).astype(f32)
        F = (f64(F) + f64(v10 * fy) * f64(gz)).astype(f32)
        F = (f64(F) + f64(v10 * fy) * f64(fz)).astype(f32)
        acc = acc + F
    assert _ulps(acc, jax_output("R6-sample9")) == 0
    assert _ulps(_plain1(cut("R6-sample9")), jax_output("R6-sample9")) == JAX_ULPS["R6-sample9"]


# ---- the three faults of the JAX probes --------------------------------------------------


def test_jax_mxu_raises():
    """R2 ``mxu``'s ``pltpu.roll(sel, shift=-1)`` does not trace; the port's
    mxu is full's function (test_variant_pairs_are_equal)."""
    m = _jax_script("bench_micro_render2")
    with pytest.MonkeyPatch.context() as mp, pytest.raises(ValueError, match="shift must be non-negative"):
        mp.setattr(m, "ROWS", ROWS)
        mp.setattr(m, "STEPS", STEPS)
        _call(m.make_kernel("mxu"), _jax_args("R2-full"), [V] * 3)


def test_dynrot_at_zbase_128_differs_from_dyn2d():
    """On rays with z in [140, 240) (zbase 128), R3 ``dynrot`` reads lanes
    (j - 128) mod 512, ``dyn2d`` lanes 128 + j: the port follows JAX in
    both, and they differ (on main's inputs every zbase is 0)."""
    plane, y, z = bench_micro_render3.inputs(ROWS)
    z = (z - 10) / 2 + 140  # [10, 210) -> [140, 240)
    build = lambda: (plane, y, z)  # noqa: E731
    m = _jax_script("bench_micro_render3")
    got = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(m, "ROWS", ROWS)
        mp.setattr(m, "STEPS", STEPS)
        for v in ("dyn2d", "dynrot"):
            p = bench_micro_render3.probe(v, ROWS, STEPS, build=build)
            got[v] = _plain1(p), _call(m.make_kernel(v), list(build()), [V] * 3)
    # the port within the band sum's stated ulp of JAX (XLA's reduction order), in each
    assert _ulps(*got["dynrot"]) <= 1 and _ulps(*got["dyn2d"]) <= 1
    # 2 steps of 16413.658 and of 16540.404 (8 rows)
    assert got["dynrot"][1].item() == pytest.approx(2 * 16413.658) and got["dyn2d"][1].item() == pytest.approx(
        2 * 16540.404)


def test_jax_smem_rw_reads_its_fill():
    """R6 ``smem_rw`` never initialises its counters: in interpret mode they
    hold -2^31, so every lane is ITERS * -2^31 and carries no count. The
    port zero-fills them: every lane is the sum over i of i // 128."""
    assert np.array_equal(jax_output("R6-smem_rw"), np.full((1, 128), ITERS * -(2.0 ** 31), np.float32))
    full = bench_micro_render6.probe("smem_rw", 16384, None, NX)  # main's count (the volume is not read)
    args = full.inputs(1, "cpu")
    assert torch.equal(full.plain(*args), torch.full((1, 1, 128), 1040384.0))
    assert sum(i // 128 for i in range(16384)) == 1040384


# ---- the C entry points emulated in numpy ---------------------------------------------


def _view(ptr, count: int, ctype=ctypes.c_int32) -> np.ndarray:
    return np.ctypeslib.as_array(ctypes.cast(ptr, ctypes.POINTER(ctype)), shape=(count,))


def _f32(ptr, count):
    return _view(ptr, count).view(np.float32)


def _bf16(ptr, count):
    return (_view(ptr, count, ctypes.c_uint16).astype(np.uint32) << 16).view(np.float32)


def _tree(x: np.ndarray) -> np.float32:
    """A warp-group's sum: lane t adds x[t], x[t + 128], ... from 0, then
    (p[l] + p[l + 64]) + (p[l + 32] + p[l + 96]) in the first warp and its
    shuffles down by 16, ..., 1."""
    p = np.zeros(128, np.float32)
    for k in range(0, x.size, 128):
        p = p + x[k:k + 128]
    v = (p[:32] + p[64:96]) + (p[32:64] + p[96:128])
    for o in (16, 8, 4, 2, 1):
        v = v[:o] + v[o:2 * o]
    return v[0]


def _row_bases(y, z):
    return int(np.floor(y).astype(np.int32).min()) // 8 * 8, int(np.floor(z).astype(np.int32).min()) // 128 * 128


def _blocks(B, tiles):
    """The (instance, tile) blocks of a launch, in an order of their own:
    a block's terms do not depend on when it runs."""
    order = [(b, tile) for b in range(B) for tile in range(tiles)]
    np.random.default_rng(tiles).shuffle(order)
    return order


def _chain(terms, A, steps, fixed=None):
    """An instance's chain, one thread's: its addends in order (the fixed
    band's sum before each item's A addends), then the part added ``steps``
    times."""
    f32 = np.float32
    part = f32(0)
    for e, x in enumerate(terms):
        if fixed is not None and e % A == 0:
            part = f32(part + fixed)
        part = f32(part + x)
    total = f32(0)
    for _ in range(steps):
        total = f32(total + part)
    return total


def _taken(taken, B, M):
    count = np.zeros((B, M), np.int64)
    if taken is not None:
        taken.append(count)
    return count


def _emu_band_sum(data, R, C, y, z, ytab, ztab, out, terms, stride, B, steps, per_step, rows, tab_len, base, H, W,
                  row_base, col_mode, add_y, extra, tiles, chunk, taken=None):
    D = _f32(data, R * C).reshape(R, C) if data else None
    Y = _f32(y, B * rows * 128).reshape(B, rows, 128) if y else None
    Z = _f32(z, B * rows * 128).reshape(B, rows, 128) if z else None
    YT = _view(ytab, B * tab_len).reshape(B, tab_len) if ytab else None
    ZT = _view(ztab, B * tab_len).reshape(B, tab_len) if ztab else None
    fixed = bool(H) and not row_base and col_mode == 0 and not add_y
    A = int(bool(H) and not fixed) + {0: 0, 1: 2, 2: 1, 3: 1, 4: 1}[extra]
    assert A and tiles * chunk >= per_step > (tiles - 1) * chunk and stride >= -(-per_step * A // 4) * 4 + 4
    T = _f32(terms, B * stride).reshape(B, stride)
    n, slot = per_step * A, -(-per_step * A // 4) * 4
    count = _taken(taken, B, per_step)

    def band(yb, zb):
        row0 = min(max(yb, 0), R - H) if row_base else 0
        j = np.arange(W)
        cols = (j - zb) % C if col_mode == 2 else (min(max(zb, 0), C - W) if col_mode == 1 else 0) + j
        v = D[row0:row0 + H][:, cols]
        return _tree((v + np.float32(yb) if add_y else v).reshape(-1))

    for b, tile in _blocks(B, tiles):
        if fixed and tile == 0:  # the band that depends on no item, once an instance
            T[b, slot] = band(0, 0)
        for m in range(tile * chunk, min(per_step, (tile + 1) * chunk)):  # an item a warp
            count[b, m] += 1
            yb = zb = 0
            if base == 1:
                yb, zb = _row_bases(Y[b, m], Z[b, m])
            elif base == 2:
                yb, zb = int(YT[b, m]) // 8 * 8, int(ZT[b, m]) // 128 * 128
            addends = [band(yb, zb)] if H and not fixed else []
            addends += {0: [], 1: [yb, zb], 2: [yb + zb], 3: [zb], 4: [1]}[extra]
            T[b, m * A:(m + 1) * A] = np.array(addends, np.float32)
    o = _f32(out, B)
    for b in range(B):  # the instance's last block
        o[b] = _chain(T[b, :n], A, steps, T[b, slot] if fixed else None)


def _combine(v00, v01, v10, v11, fy, fz):
    gy, gz = np.float32(1) - fy, np.float32(1) - fz
    return ((v00 * gy * gz + v01 * gy * fz) + v10 * fy * gz) + v11 * fy * fz


def _emu_sampler(data, R, C, vol, nx, ny, nz, y, z, rows, ytab, ztab, tab_len, out, terms, stride, B, steps, per_step,
                 G, K, variant, tiles, chunk, taken=None):
    name = _sampler.VARIANTS[variant]
    D = _f32(data, R * C).reshape(R, C) if data else None
    Y = _f32(y, B * rows * 128).reshape(B, rows, 128)
    Z = _f32(z, B * rows * 128).reshape(B, rows, 128)
    YT = _view(ytab, B * tab_len).reshape(B, tab_len) if ytab else None
    ZT = _view(ztab, B * tab_len).reshape(B, tab_len) if ztab else None
    f32 = np.float32
    assert tiles * chunk >= per_step > (tiles - 1) * chunk
    count = _taken(taken, B, per_step)
    if name == "sample9":
        VOL = _bf16(vol, nx * ny * nz).reshape(nx, ny, nz)
        o = _f32(out, B * 128).reshape(B, 128)
        assert (terms is None) == (tiles == 1) and steps == 1
        T = _f32(terms, B * stride).reshape(B, stride)[:, :per_step * 128].reshape(B, per_step, 128) if terms else None
        for b, tile in _blocks(B, tiles):
            acc = np.zeros(128, f32)
            for i in range(tile * chunk, min(per_step, (tile + 1) * chunk)):
                count[b, i] += 1
                pk = int(YT[b, i])
                xb = min(max(pk // 65536, 0), nx - 9)
                yb = min(max((pk // 4) % 64 * 8, 0), ny - 32)
                zb = min(max(pk % 4 * 128, 0), nz - 256)
                band = VOL[xb:xb + 9, yb:yb + 32, zb:zb + 256].reshape(288, 256)  # the bulk copies' runs
                yv, zv = Y[b, i & 127], Z[b, i & 127]
                y0, z0 = np.floor(yv).astype(np.int32), np.floor(zv).astype(np.int32)
                ry = np.clip(y0 % 32, 0, 30) + 96
                zi = np.clip(z0 % 128, 0, 253)
                v00, v10 = band[ry, zi], band[ry + 1, zi]
                F = _combine(v00, v00, v10, v10, yv - y0.astype(f32), zv - z0.astype(f32))
                if T is None:
                    acc = acc + F  # one block an instance: each ray chained in registers
                else:
                    T[b, i] = F
            if T is None:
                o[b] = acc
        if T is not None:
            for b in range(B):  # the last block: each ray's chain over the instance's terms
                acc = np.zeros(128, f32)
                for i in range(per_step):
                    acc = acc + T[b, i]
                o[b] = acc
        return
    A = 2 if name == "loadtaa" else 1
    assert stride >= -(-per_step * A // 4) * 4 + 4
    T = _f32(terms, B * stride).reshape(B, stride)
    for b, tile in _blocks(B, tiles):
        for n in range(tile * chunk, min(per_step, (tile + 1) * chunk)):
            count[b, n] += 1
            dy = dz = f32(0)
            if name == "tab_full":
                k, idx = n % K, n // K
                r = idx // G
                yb, zb = int(YT[b, idx]) // 8 * 8, int(ZT[b, idx]) // 128 * 128
                dy, dz = f32(f32(0.01) * f32(k)), f32(f32(0.017) * f32(k))
                H, W, ry_max, zi_max = 24, 256, 22, 254
            elif name == "sample512":
                r = n & 127
                yb, zb = int(YT[b, n]) // 8 * 8, 0
                H, W, ry_max, zi_max = 24, 512, 22, 510
            else:
                r = n
                yb, zb = (0, 0) if name == "static" else _row_bases(Y[b, r], Z[b, r])
                H, W, ry_max, zi_max = 16, 256, 14, 254
            yv, zv = Y[b, r] + dy, Z[b, r] + dz
            y0, z0 = np.floor(yv).astype(np.int32), np.floor(zv).astype(np.int32)
            row0, col0 = min(max(yb, 0), R - H), min(max(zb, 0), C - W)
            zi, ry = np.clip(z0 - zb, 0, zi_max), np.clip(y0 - yb, 0, ry_max)
            if name == "loadtaa":
                s0 = s1 = np.zeros(128, f32)
                for i in range(H):
                    s0 = s0 + D[row0 + i, col0 + zi]
                for i in range(H):
                    s1 = s1 + D[row0 + i, col0 + zi + 1]
                T[b, 2 * n:2 * n + 2] = _tree(s0), _tree(s1)
                continue
            if name == "mxu":  # one-hot products over the band's 256 columns: exactly the selected value
                band = D[row0:row0 + H, col0:col0 + 256]
                onehot = lambda d: band @ (np.arange(256)[:, None] == (zi + d)[None, :]).astype(f32)  # noqa: E731
                g0, g1 = onehot(0), onehot(1)
                lanes = np.arange(128)
                v00, v01, v10, v11 = g0[ry, lanes], g1[ry, lanes], g0[ry + 1, lanes], g1[ry + 1, lanes]
            else:
                v00, v01 = D[row0 + ry, col0 + zi], D[row0 + ry, col0 + zi + 1]
                v10, v11 = D[row0 + ry + 1, col0 + zi], D[row0 + ry + 1, col0 + zi + 1]
            T[b, n] = _tree(f32(0) + _combine(v00, v01, v10, v11, yv - y0.astype(f32), zv - z0.astype(f32)))
    o = _f32(out, B)
    for b in range(B):
        o[b] = _chain(T[b, :per_step * A], A, steps)


def _counter_start(first: int) -> np.ndarray:
    """R6 ``smem_rw``'s 128 counters at the start of a block's run of
    iterations from ``first``, as the kernel sets them."""
    return (first - np.arange(128) + 127) >> 7


def _emu_band_copy(tab, rows, width, vol, es, nx, ny, nz, P, BY, BZ, out, terms, stride, B, iters, variant, tiles,
                   chunk, taken=None):
    """``sdf_micro_band_copy``. S1, S2, D1: a block a table row. R6: blocks
    of ``chunk`` consecutive iterations, in a shuffled order; with one block
    an instance it chains in registers, with several it writes each
    iteration's 128 lanes' terms (``dma``, ``dma_ovl``) or its sum
    (``smem_rw``) and the chain kernel chains them. ``dma_ovl`` streams its
    block's bands through a ring of 4 stages of 3 planes. ``taken`` (a list)
    receives the count of each (instance, iteration) a block took."""
    name = _sampler.COPIES[variant]
    f32 = np.float32
    if name in _sampler.ROW_COPIES:
        assert tiles == 1 and terms is None
        T = _view(tab, B * rows * width).reshape(B * rows, width)
        VOL = _f32(vol, nx * ny * nz).reshape(nx, ny, nz) if vol else None
        for blk in range(B * rows):
            row = T[blk]
            if name == "rowsum":
                acc = f32(0)
                for s in range(width):
                    acc = f32(acc + f32(row[s]))
                _f32(out, B * rows * 128).reshape(-1, 128)[blk] = acc
            elif name == "copyout":
                xb, yb, zb = (min(max(int(v), 0), hi) for v, hi in
                              ((row[0], nx - P), (row[1] * 8, ny - BY), (row[2] * 8, nz - BZ)))
                band = VOL[xb:xb + P, yb:yb + BY, zb:zb + BZ].ravel()
                _f32(out, B * rows * band.size).reshape(B * rows, -1)[blk] = band
            else:
                acc = np.zeros(128, f32)
                for s in range(min(max(int(row[0]), 0), width - 1)):
                    xb = min(max(int(row[1 + s]), 0), nx - P)
                    acc = acc + VOL[xb:xb + P].ravel()[:128]  # one run: the whole slab
                _f32(out, B * rows * 128).reshape(-1, 128)[blk] = acc
        return
    assert 0 < iters and tiles * chunk >= iters > (tiles - 1) * chunk
    lanes = name != "smem_rw"  # a term a lane an iteration, or one an iteration
    split = tiles > 1
    assert (terms is not None) == split
    if split:
        assert stride % 4 == 0 and stride >= (iters * 128 if lanes else -(-tiles // 4) * 4)
        TERMS = _f32(terms, B * stride).reshape(B, stride)
    o = _f32(out, B * 128).reshape(B, 128)
    T = _view(tab, B * width).reshape(B, width)
    count = _taken(taken, B, iters)
    if lanes:
        assert iters <= width
        VOL = _bf16(vol, nx * ny * nz).reshape(nx, ny, nz)

    def band_at(pk):
        xb = min(max(pk // 65536, 0), nx - P)
        yb = min(max((pk // 4) % 64 * 8, 0), ny - BY)
        zb = min(max(pk % 4 * 128, 0), nz - BZ)
        return VOL[xb:xb + P, yb:yb + BY, zb:zb + BZ]

    for b, tile in _blocks(B, tiles):
        first, end = tile * chunk, min(iters, (tile + 1) * chunk)
        if not lanes:  # thread 0 reads and increments the row's counter, and sums its block's values
            cnt, acc = _counter_start(first), f32(0)
            for i in range(first, end):
                count[b, i] += 1
                v = cnt[i & 127]
                cnt[i & 127] = v + 1
                acc = f32(acc + f32(v))
            if split:
                TERMS[b, tile] = acc
            else:
                o[b] = acc
            continue
        terms_of = {}  # iteration -> its band's first row, lane t's term element t
        if name == "dma":
            for i in range(first, end):
                terms_of[i] = band_at(int(T[b, i]))[0, 0, :128]
        else:  # the ring of 4 stages of 3 planes: chunk c is planes 3 (c % 3) ... of band first + c // 3
            stages, planes = 4, 3
            per, ring = P // planes, {}
            chunks = (end - first) * per

            def issue(c):
                j = planes * (c % per)
                ring[c % stages] = band_at(int(T[b, first + c // per]))[j:j + planes].copy()

            for c in range(min(chunks, stages)):
                issue(c)
            for c in range(chunks):
                if c % per == 0:
                    terms_of[first + c // per] = ring[c % stages][0, 0, :128]
                if c + stages < chunks:
                    issue(c + stages)
        acc = np.zeros(128, f32)
        for i in range(first, end):
            count[b, i] += 1
            if split:
                TERMS[b, i * 128:(i + 1) * 128] = terms_of[i]
            else:
                acc = acc + terms_of[i]
        if not split:
            o[b] = acc
    if split:
        for b in range(B):  # the chain kernel: each lane's (micro_ray_chain), or the blocks' sums' (micro_chain)
            if lanes:
                acc = np.zeros(128, f32)
                for i in range(iters):
                    acc = acc + TERMS[b, i * 128:(i + 1) * 128]
                o[b] = acc
            else:
                o[b] = _chain(TERMS[b, :tiles], 1, 1)


EMULATED = {"sdf_micro_band_sum": _emu_band_sum, "sdf_micro_sampler": _emu_sampler,
            "sdf_micro_band_copy": _emu_band_copy}


@pytest.mark.parametrize("key", list(PROBES))
def test_kernel_arguments_emulated(key, monkeypatch):
    """The kernel's launch on CPU tensors, its C entry point emulated: the
    arguments in ``SIGNATURES`` order and the kernel's arithmetic give the
    plain version's result, bit for bit."""
    calls = []

    def emulate(name, device, fn, *args):
        assert len(args) + 1 == len(_build.SIGNATURES[fn])  # + the stream
        calls.append(name)
        EMULATED[fn](*args)

    monkeypatch.setattr(_build, "launch", emulate)
    monkeypatch.setattr(_micro, "sm_count", lambda device: H100_SMS)
    p = cut(key)
    args = p.inputs(2, "cpu")
    got = p.launch(*args)
    assert calls == [f"probe_{key}"]
    want = p.plain(*args)
    assert got.dtype == want.dtype == torch.float32 and got.shape == want.shape == (2, *p.out_shape)
    assert torch.equal(got, want)


REDESIGNED = [k for k, p in PROBES.items() if p.geometry is not None]


def _geometry_cases():
    """(probe, batch, SMs) at the cut sizes: B = 1 on an H100; on one SM
    the batches either side of the geometry's first switch and B_fill (one
    block an instance)."""
    cases = []
    for key in REDESIGNED:
        switch = _micro.switch_batch(cut(key), 1)
        fill = _micro.FILL_BLOCKS_PER_SM
        cases += [(key, 1, H100_SMS), *[(key, b, 1) for b in sorted({max(1, switch - 1), switch, fill})]]
    return cases


@pytest.mark.parametrize("key, batch, sms", _geometry_cases())
def test_geometry_emulated(key, batch, sms, monkeypatch):
    """A redesigned kernel's launch emulated block by block as its geometry
    tiles it, the blocks in a shuffled order: every item's terms are
    computed exactly once, by one block, then the instance's chain runs
    over them; the result is the plain version's, bit for bit."""
    p = cut(key)
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
    (count,) = taken
    g = p.geometry(batch, sms)
    tiles, chunk = g.args
    assert (count == 1).all() and tiles == g.tiles and (tiles - 1) * chunk < count.shape[1] <= tiles * chunk
    assert tiles == (1 if batch >= _micro.FILL_BLOCKS_PER_SM * sms else min(-(-4 * sms // batch), count.shape[1]))


def test_smem_rw_counter_start_is_the_earlier_iterations():
    """A block of R6 ``smem_rw`` whose run starts at iteration ``first``
    starts counter r at (first - r + 127) >> 7: the iterations i < first
    with i & 127 == r, as one thread counting from iteration 0 has them,
    for every ``first`` up to 1,024."""
    count = np.zeros(128, np.int64)
    for first in range(1025):
        np.testing.assert_array_equal(_counter_start(first), count, err_msg=f"first={first}")
        count[first & 127] += 1


def test_smem_rw_partial_sums_stay_exact(monkeypatch):
    """R6 ``smem_rw`` split over blocks adds the blocks' float partial sums,
    which equal the probe's chain only while every sum is an integer below
    2^24: the wrapper raises from the first iteration count whose total
    reaches it, and launches below it (and with one block an instance,
    where the chain is the probe's own)."""
    assert _sampler.smem_rw_total(16384) == 1040384
    assert [_sampler.smem_rw_total(n) for n in range(300)] == [sum(i // 128 for i in range(n)) for n in range(300)]
    first_past = next(n for n in range(65000, 70000) if _sampler.smem_rw_total(n) >= 1 << 24)
    assert first_past == 65600
    calls = []
    monkeypatch.setattr(_build, "launch", lambda name, device, fn, *args: calls.append(args[-3:]))
    monkeypatch.setattr(_micro, "sm_count", lambda device: H100_SMS)
    tab = torch.zeros((1, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="2\\^24"):
        _sampler.band_copy_kernel("T", "smem_rw", tab, None, _sampler.R6_BAND, first_past, (1, 128))
    assert not calls
    _sampler.band_copy_kernel("T", "smem_rw", tab, None, _sampler.R6_BAND, first_past - 1, (1, 128))
    _sampler.band_copy_kernel("T", "smem_rw", tab.expand(528, -1).contiguous(), None, _sampler.R6_BAND, first_past,
                              (1, 128))
    assert [c[1:] for c in calls] == [_sampler.render_geometry(1, first_past - 1, H100_SMS).args, (1, first_past)]


def test_geometry_rule():
    """B = 1 spreads an instance's items over about 4 x SMs blocks (at most
    one an item), none empty; B_fill takes one block an instance. The first
    switch is where fewer blocks than at B = 1 are wanted."""
    fill = _micro.FILL_BLOCKS_PER_SM * H100_SMS
    for key in REDESIGNED:
        p = PROBES[key]
        items = p.steps if key[:2] in ("R4", "R5", "R6") else p.steps // STEPS_OF[key[:2]]
        assert p.geometry(fill, H100_SMS) == (1, 1, (1, items))
        tiles, _, (tiles_, chunk) = p.geometry(1, H100_SMS)
        assert tiles == tiles_ and (tiles - 1) * chunk < items <= tiles * chunk and tiles <= fill
    geometry = {k: tuple(PROBES[k].geometry(1, H100_SMS)) for k in ("R1", "R2-mxu", "R4-tab_load", "R4-tab_full",
                                                                     "R5-load_d0", "R6-sample9")}
    assert geometry["R1"] == geometry["R2-mxu"] == (128, 1, (128, 1))  # a block a ray row
    assert geometry["R4-tab_load"] == (512, 1, (512, 4)) and geometry["R4-tab_full"] == (512, 1, (512, 32))
    assert geometry["R5-load_d0"] == (521, 1, (521, 63))  # 63 iterations a block, none empty
    assert geometry["R6-sample9"] == (512, 1, (512, 32))
    assert _micro.switch_batch(PROBES["R1"], H100_SMS) == 5  # from there fewer than 128 blocks
    assert _micro.switch_batch(PROBES["R5-fori"], H100_SMS) == 2
    # R6's copies as sample9: 512 blocks of 32 iterations; S1, S2 and D1 a block a table row at every batch
    assert all(PROBES[f"R6-{v}"].geometry(1, H100_SMS) == PROBES["R6-sample9"].geometry(1, H100_SMS)
               for v in ("smem_rw", "dma", "dma_ovl"))
    assert not {"S1", "S2", "D1"} & set(REDESIGNED)
    assert {p.kernel for k, p in PROBES.items() if k in REDESIGNED} == set(_sampler.KERNELS)
    assert len(REDESIGNED) == 27


# ---- the wrapper --------------------------------------------------------------------


@pytest.mark.parametrize("key", list(PROBES))
def test_batch_of_three_is_three_calls(key):
    p = cut(key)
    args = p.inputs(3, "cpu")
    for a, b, rule in zip(args, p.build(), p.index):
        assert torch.equal(a[0], torch.as_tensor(b).to(a.dtype))  # instance 0 is the JAX probe's
        assert a.shape[0] == (1 if rule == _micro.SHARED else 3)
    rolled = [a for a, rule in zip(args, p.index) if rule == _micro.ROLL]
    assert rolled and not torch.equal(rolled[0][0], rolled[0][1])
    got = p(*args)
    assert got.shape == (3, *p.out_shape)
    for b in range(3):
        one = [a if rule == _micro.SHARED else a[b:b + 1].contiguous() for a, rule in zip(args, p.index)]
        assert torch.equal(got[b:b + 1], p(*one))


def test_cpu_takes_the_plain_version_and_counts_no_launch(monkeypatch):
    def refuse(*args):
        raise AssertionError("a CPU tensor reached a kernel launch")

    monkeypatch.setattr(_build, "launch", refuse)
    _build.reset_launches()
    for name in _sampler.KERNELS:
        p = cut(next(k for k, p in PROBES.items() if p.kernel == name))
        args = p.inputs(1, "cpu")
        assert torch.equal(p(*args), p.plain(*args))
    assert not any(_build.LAUNCHES.values())


def test_wrapper_rejects_bad_inputs():
    p = cut("R2-full")
    plane, y, z = p.inputs(2, "cpu")
    with pytest.raises(TypeError):
        p(plane.double(), y, z)
    with pytest.raises(ValueError):
        p(plane, y, z[:1])
    with pytest.raises(ValueError):
        p(plane.expand(2, -1, -1), y, z)  # the data is one copy for the batch


def test_library_call_computes_d1():
    """``torch.take`` of the bands' flat indices, D1's library call, equals
    its plain version."""
    p = PROBES["D1"]
    args = p.inputs(2, "cpu")
    assert torch.equal(p.library(*p.library_args(args)), p.plain(*args))


def test_bounds_count_what_the_output_needs():
    r5 = PROBES["R5-fori"]
    assert r5.bytes() == 4 and r5.bound()[1] == "operations"  # reads nothing; writes one float
    s1 = PROBES["S1"]
    assert s1.bytes() == 4 * 64 * 16 + 4 * 64 * 128
    d1 = PROBES["D1"]  # the union of 8 bands of 4 x 16 x 128, 3 table entries a row, the bands written out
    offs, vol = probe_dma_align.inputs()
    hit = np.zeros(vol.shape, bool)
    for x, y, z in zip(offs[:, 0, 0], offs[:, 0, 1] * 8, offs[:, 0, 2] * 8):
        hit[x:x + 4, y:y + 16, z:z + 128] = True
    assert d1.bytes() == 4 * 3 * 8 + 4 * int(hit.sum()) + 4 * 8 * 64 * 128 and d1.bound()[1] == "bytes"
    dma = PROBES["R6-dma"]
    assert dma.copied == 16384 * 9 * 32 * 256 * 2 and dma.lo.steps == 2048
    # the bytes the copy probes' outputs need: one 128-lane row of each band, far fewer than they copy
    dma = cut("R6-dma")
    assert dma.copied == ITERS * 9 * 32 * 256 * 2 and 4 * ITERS < dma.bytes() <= 4 * ITERS + 2 * ITERS * 128 + 4 * 128
    r3 = cut("R3-dyn2d")  # the union of the rows' (16, 256) bands, every ray read, one float written
    plane, y, z = r3.build()
    hit = np.zeros(plane.shape, bool)
    for yr, zr in zip(y, z):
        yb, zb = _row_bases(yr, zr)
        hit[yb:yb + 16, zb:zb + 256] = True
    assert r3.bytes() == 4 * int(hit.sum()) + 2 * 4 * ROWS * 128 + 4
    # the operations the plain versions compute: each distinct band's adds once (static: a band a y base, the y
    # added to each element), a step's rows' bases and chain adds, and an add a step
    bases = {_row_bases(yr, zr) for yr, zr in zip(y, z)}
    assert r3.need[2] == len(bases) * 16 * 256 and r3.ops == ROWS * (4 * 128 + 1) + STEPS
    static = cut("R3-static")
    assert static.need[2] == len({yb for yb, _ in bases}) * 16 * 256 * 2
    # a sampler's rows sampled once, not once a step; R1's bound is its bytes'
    r1 = PROBES["R1"]
    assert r1.need[2] == 128 * (128 * 21 + 4 * 128) and r1.ops == 128 + 256 and r1.bound()[1] == "bytes"


@pytest.mark.parametrize("module", MODULES, ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_main_on_the_cpu(module, capsys, monkeypatch):
    """Each ``main`` on the CPU, the slope programs at cut iteration counts
    (R6 on the cut volume): every line OK (S1, S2, D1: the scripts' checks
    against numpy hold), every time "not measured"."""
    if module is bench_micro_render5:
        monkeypatch.setattr(module, "ITERS_HI", 64)
        monkeypatch.setattr(module, "ITERS_LO", 32)
    if module is bench_micro_render6:
        monkeypatch.setattr(module, "ITERS_HI", 64)
        monkeypatch.setattr(module, "ITERS_LO", 32)
        monkeypatch.setattr(module, "NX", NX)
    result = module.main(["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert result["device"] == "cpu" and result["b_fill"] == _micro.NOT_MEASURED
    assert list(result["probes"]) == [p.key for p in module.PROBES]
    for p, text in zip(module.PROBES, lines[1:]):
        assert text.startswith(f"{p.label}: OK not measured")
        rec = result["probes"][p.key]
        assert rec["ok"] is True
        assert all(rec[k] == _micro.NOT_MEASURED for k in ("ms", "launch_ms", "us_per_step", "fill_ms"))
