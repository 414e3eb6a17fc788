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
from pathlib import Path

import numpy as np
import pytest

import jax
from jax.experimental import pallas as jpl
import torch

from sdf_tools_tpu_torch import _build
from sdf_tools_tpu_torch.scripts import _micro, bench_micro_gather, bench_micro_gather2, bench_micro_gather3

REPO = Path(__file__).resolve().parents[1]
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


def _emu_ops(x, out, B, elems, steps):
    xs = _view(x, B * elems).astype(np.uint32)
    acc = np.zeros_like(xs)
    for i in range(steps):
        acc = np.minimum((acc * 2 + 1).view(np.int32), (xs + np.uint32(i)).view(np.int32)).view(np.uint32)
    _view(out, B * elems)[:] = acc.view(np.int32)


def _emu_gather(x, q, out, B, outer, n, inner, m, steps, mod, shared):
    assert shared == int(4 * outer * n * inner <= _micro.SMEM_MAX)
    xs = _view(x, B * outer * n * inner).reshape(B, outer, n, inner)
    r = _view(q, B * outer * m * inner).reshape(B, outer, m, inner) % mod  # floor modulo, as the kernel's
    acc = np.zeros(r.shape, np.uint32)
    for _ in range(steps):
        acc += np.take_along_axis(xs, r, axis=2).view(np.uint32)
        r = np.where(r + 1 == mod, 0, r + 1)
    _view(out, acc.size)[:] = acc.view(np.int32).ravel()


def _emu_onehot_min(x, q, out, B, D, inner, steps, mod, shared):
    assert shared == int(4 * D * inner <= _micro.SMEM_MAX)
    xs = _view(x, B * D * inner).reshape(B, D, inner)
    r = _view(q, B * inner).reshape(B, 1, inner)
    r = r % mod if mod else r.copy()
    d = np.arange(D).reshape(1, D, 1)
    acc = np.zeros((B, inner), np.uint32)
    for _ in range(steps):
        acc += np.where(d == r, xs, 1 << 30).min(axis=1).astype(np.int32).view(np.uint32)
        if mod:
            r = np.where(r + 1 == mod, 0, r + 1)
    _view(out, B * inner)[:] = acc.view(np.int32).ravel()


def _emu_onehot_write(x, q, v, out, B, D, inner, steps, mod, out_rows, shared):
    assert shared == int(4 * D * inner <= _micro.SMEM_MAX)
    assert shared or out_rows == D
    w = _view(x, B * D * inner).reshape(B, D, inner).copy()
    r = _view(q, B * inner).reshape(B, 1, inner)
    r = r % mod if mod else r.copy()
    d = np.arange(D).reshape(1, D, 1)
    for i in range(steps):
        val = i if v is None else _view(v, B * inner).reshape(B, 1, inner)
        w = np.where(d == r, val, w).astype(np.int32)
        if mod:
            r = np.where(r + 1 == mod, 0, r + 1)
    _view(out, B * out_rows * inner)[:] = w[:, :out_rows].ravel()


def _emu_row_scan(x, out, B, outer, n, inner):
    xs = _view(x, B * outer * n * inner).reshape(B, outer, n, inner)
    os_ = _view(out, xs.size).reshape(xs.shape)
    carry = np.zeros((B, outer, inner), np.int32)
    for i in range(n):
        carry = np.minimum((carry.view(np.uint32) + 1).view(np.int32), xs[:, :, i])
        os_[:, :, i] = carry


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
    p = PROBES[key]
    args = p.inputs(2, "cpu")
    got = p.launch(*args)
    assert calls == [f"probe_{key}"]
    want = p.plain(*args)
    assert got.dtype == want.dtype and got.shape == want.shape == (2, *p.out_shape)
    assert torch.equal(got, want)


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
    """``torch.gather`` (E1-E3) and ``Tensor.scatter`` (E6), the calls
    timed beside the kernels on the card, equal the plain version."""
    p = PROBES[key]
    args = p.inputs(2, "cpu")
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
