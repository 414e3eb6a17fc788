"""The parts the TPU probes' counterparts share: the probe record and its
wrapper, the batch of instances, the measurement (on ``_timing``'s
CUDA-event timing) and the probe line; and the plain versions and kernel
launches of the five kernels of ``csrc/micro_gather.cu``, which the
envelope-design probes (``bench_micro_gather``, ``bench_micro_gather2``,
``bench_micro_gather3``) run. The render-design probes' kernels
(``csrc/micro_render.cu``) are in ``_sampler``.

A probe is one function of the JAX scripts' TPU probes. Every tensor of a
probe carries a leading batch axis of B independent instances; B = 1 is
the JAX probe's call on its own inputs. Instance b of a batch
(``Probe.inputs``) is those inputs with b added to each value input and to
each index input modulo its range, each ROLL input (ray rows, tables)
rolled along its first axis by b times its length over B (at least 1), so
that a batch's instances start spread over it, and each SHARED input (a
plane, a cube, a volume: the data) one copy for the whole batch (leading
axis 1). Instance 0 is the JAX probe's. Instances agree only where B
exceeds the length of every ROLL input: instances b and b + n of a
batch whose ROLL inputs are all n long (R1-R4's 128 rows, S1's and S2's 64
and D1's 8 table rows).

On a CPU tensor a probe runs its plain PyTorch version; on a CUDA tensor
it launches its kernel and counts the launch under
``_build.LAUNCHES["probe_<key>"]``, or raises. The five kernels of
``csrc/micro_gather.cu`` take several blocks an instance where the batch
is small (``gather_geometry``, ``onehot_min_geometry``,
``onehot_write_geometry``, ``row_scan_geometry``, ``lane_geometry``), as
do ``micro_band_sum``, ``micro_sampler`` and R6's copies
(``_sampler.render_geometry``); S1, S2 and D1 take a block a table row.
"""
from __future__ import annotations

import argparse
import math
from dataclasses import dataclass
from functools import cache, cached_property, partial
from typing import Callable, NamedTuple

import numpy as np
import torch

from .. import _build
from ..grid import require_device
from . import _timing

KERNELS = ("micro_ops", "micro_gather", "micro_onehot_min", "micro_onehot_write", "micro_row_scan")
SOURCE = "sdf_tools_tpu_torch/csrc/micro_gather.cu"
SMEM_MAX = 232448  # bytes of shared memory a block can use on an H100 (227 KB)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM peak memory rate (data sheet)
# H100 SXM float32 rate outside the tensor cores (data sheet); its int32
# rate is no higher, so a time from it is a lower bound
OPS_PER_S = 67e12
FILL_BLOCKS_PER_SM = 4  # B_fill puts this many blocks (instances) on every SM
# micro_gather: a block takes at least 8 outputs (8 int32 of a row fill a 32-byte sector) and 256
# output-steps (a one-step probe's block is no smaller than it was when a block had 256 threads)
GATHER_MIN_TILE = 8
GATHER_MIN_WORK = 256
GATHER_MIN_CHUNK = 16  # micro_gather: steps a thread takes at least: two rounds of its 8 loads in flight
GATHER_THREADS_PER_SM = 1024  # micro_gather: threads wanted an SM in all, each with 8 loads in flight
# micro_row_scan: threads wanted an SM in all before a column's rows are split over threads: four blocks of
# 128, so that from B_fill on every probe (G6's 128 columns the narrowest) walks a column a thread, the
# one-block launch, which reaches 66-82% of the bound there
SCAN_THREADS_PER_SM = 512
ROW_SCAN_RUN = 16  # micro_row_scan: rows a thread holds in registers where a column's rows are split (kRun)
WARP = 32
MAX_THREADS = 1024  # a block's
BIG = 1 << 30  # the one-hot min's "no match"
LAUNCH_REPS = 20  # wrapper calls at B = 1 timed back to back for the launch time
NOT_MEASURED = "not measured"
ROLL = "roll"  # an input rolled along its first axis by the instance's index times its length over B
SHARED = "shared"  # an input the batch shares: one copy, leading axis 1


# ---- plain versions (batched: every tensor has a leading instance axis) ----


def _stepped(q: torch.Tensor, i: int, mod: int | None) -> torch.Tensor:
    """The index of step i: ``(q + i) % mod`` as JAX's ``%`` (floor
    modulo), or ``q`` itself without a modulus."""
    return q if mod is None else torch.remainder(q + i, mod)


def take_sum_plain(x, q, axis: int, steps: int, mod: int | None) -> torch.Tensor:
    """Sum over i < steps of ``take_along_axis(x, (q + i) % mod, axis)``
    (``q`` unchanged without ``mod``), in q's shape."""
    acc = torch.zeros_like(q)
    for i in range(steps):
        acc = acc + torch.take_along_dim(x, _stepped(q, i, mod).long(), dim=axis + 1)
    return acc


def onehot_min_plain(x, q, steps: int, mod: int | None) -> torch.Tensor:
    """Sum over i < steps of ``min_d where(d == q_i, x[d], 2^30)``; x is
    [B, D, ...], q [B, 1, ...]; the result drops the D axis."""
    iota = torch.arange(x.shape[1], dtype=torch.int32, device=x.device).view(1, -1, *[1] * (x.ndim - 2))
    acc = torch.zeros_like(q[:, 0])
    for i in range(steps):
        acc = acc + torch.where(iota == _stepped(q, i, mod), x, BIG).amin(dim=1)
    return acc


def onehot_write_plain(x, q, v, steps: int, mod: int | None, out_rows: int) -> torch.Tensor:
    """``w = x``, then each step ``w = where(d == q_i, v, w)`` (v the step i
    where ``v`` is None); the first ``out_rows`` rows of w."""
    iota = torch.arange(x.shape[1], dtype=torch.int32, device=x.device).view(1, -1, *[1] * (x.ndim - 2))
    w = x
    for i in range(steps):
        w = torch.where(iota == _stepped(q, i, mod), i if v is None else v, w)
    return w[:, :out_rows]


def row_scan_plain(x, axis: int) -> torch.Tensor:
    """``o_i = min(o_{i-1} + 1, x_i)`` along ``axis``, ``o_{-1} = 0``, a
    Python loop over the rows."""
    dim = axis + 1
    out = torch.empty_like(x)
    carry = torch.zeros_like(x.select(dim, 0))
    for i in range(x.shape[dim]):
        carry = torch.minimum(carry + 1, x.select(dim, i))
        out.select(dim, i).copy_(carry)
    return out


def ops_plain(x, steps: int) -> torch.Tensor:
    """``acc = min(2 acc + 1, x + i)`` for i < steps from 0."""
    acc = torch.zeros_like(x)
    for i in range(steps):
        acc = torch.minimum(acc * 2 + 1, x + i)
    return acc


# ---- kernel launches (CUDA tensors) ----------------------------------------


def in_shared(x_instance_bytes: int) -> bool:
    """Whether a kernel stages an instance's x in shared memory (it fits a
    block's 227 KB) or reads it from device memory through L1/L2."""
    return x_instance_bytes <= SMEM_MAX


def _around(shape, dim: int):
    """(outer, n, inner) of an instance's shape around ``dim``."""
    return math.prod(shape[1:dim]), shape[dim], math.prod(shape[dim + 1:])


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


class Geometry(NamedTuple):
    """A launch's blocks an instance (``tiles``), the step groups each
    block's threads form (``groups``), and the C entry point's geometry
    arguments ``args``."""

    tiles: int
    groups: int
    args: tuple


def gather_geometry(batch: int, outer: int, inner: int, m: int, steps: int, sms: int) -> Geometry:
    """The blocks of a ``micro_gather`` launch on q [outer, m, inner], args
    (ow, kw, mw, groups, chunk): a tile, one block, is a box of the outputs,
    ``ow`` whole rows o; or ``kw`` columns k of one o with every j (ow ==
    1); or ``mw`` outputs j of one column (ow == kw == 1), so that outputs
    that read the same column of x share a block (its L1, or one staged
    box) as far as the tile count allows; its threads form ``groups``
    groups of ``chunk`` steps each.

    The rule: FILL_BLOCKS_PER_SM blocks on every SM are wanted in all, so an
    instance takes ceil(that / batch) tiles, of GATHER_MIN_TILE outputs and
    GATHER_MIN_WORK output-steps at least. Then the steps are split over
    groups, GATHER_MIN_CHUNK steps each at least, until the card holds
    GATHER_THREADS_PER_SM threads an SM in all or a block holds a thread a
    group for each of its outputs (1024 threads); the groups' partial sums
    meet in shared memory, so no output is split over blocks (no atomics,
    no zeroing pass, which costs a launch of its own). At B = 1 a probe
    spreads over about 4 x SMs blocks; from B_fill = FILL_BLOCKS_PER_SM x
    SMs on, one block an instance, the geometry that already fills the card
    there and stages a shared x once an instance."""
    outputs = outer * m * inner
    min_tile = max(GATHER_MIN_TILE, _ceil(GATHER_MIN_WORK, max(1, steps)))
    tiles = min(_ceil(FILL_BLOCKS_PER_SM * sms, batch), _ceil(outputs, min_tile))
    ow, kw, mw = 1, 1, m
    if tiles <= outer:
        ow, kw = _ceil(outer, tiles), inner
    elif tiles <= outer * inner:
        kw = _ceil(inner, _ceil(tiles, outer))
    else:
        mw = _ceil(m, _ceil(tiles, outer * inner))
    box = min(ow, outer) * min(mw, m) * min(kw, inner)
    groups = max(1, min(MAX_THREADS // box, steps // GATHER_MIN_CHUNK,
                        _ceil(GATHER_THREADS_PER_SM * sms, batch * outputs)))
    chunk = max(1, _ceil(steps, groups))
    groups = max(1, _ceil(steps, chunk))
    tiles = _ceil(outer, ow) * _ceil(inner, kw) * _ceil(m, mw)
    return Geometry(tiles, groups, (ow, kw, mw, groups, chunk))


def onehot_min_geometry(batch: int, inner: int, steps: int, sms: int) -> Geometry:
    """The blocks of a ``micro_onehot_min`` launch on q [1, inner], args
    (kw, groups, chunk): ``gather_geometry``'s rule on a gather of one
    output a column (every output reads its own column of x), so a tile is
    ``kw`` columns, its steps in ``groups`` groups of ``chunk``."""
    g = gather_geometry(batch, 1, inner, 1, steps, sms)
    _, kw, _, groups, chunk = g.args
    return Geometry(g.tiles, g.groups, (kw, groups, chunk))


def onehot_write_geometry(batch: int, rows: int, inner: int, shared: bool, sms: int) -> Geometry:
    """The blocks of a ``micro_onehot_write`` launch on x [rows, inner], args
    (tile,): ``tile`` columns a block (shared: every step of a column is one
    store into its staged column, so a column stays in one block; a warp's
    worth of columns at least) or ``tile`` rows (device memory: the one-step
    write is a streaming pass, cut anywhere). As ``gather_geometry``: an
    instance takes ceil(FILL_BLOCKS_PER_SM x SMs / batch) blocks, one from
    B_fill on; its steps stay in one thread a column, in order."""
    if shared:
        return lane_geometry(batch, inner, sms)
    tile = _ceil(rows, min(_ceil(FILL_BLOCKS_PER_SM * sms, batch), rows))
    return Geometry(_ceil(rows, tile), 1, (tile,))


def lane_geometry(batch: int, lanes: int, sms: int) -> Geometry:
    """The blocks of a launch of one thread a lane, each lane's steps in
    order in its thread (``micro_ops``; ``micro_onehot_write`` in shared
    memory), args (tile,): ceil(FILL_BLOCKS_PER_SM x SMs / batch) blocks an
    instance wanted, each ``tile`` consecutive lanes, a warp's worth at
    least, so one block an instance from B_fill on."""
    blocks = _ceil(FILL_BLOCKS_PER_SM * sms, batch)
    tile = min(lanes, _ceil(_ceil(lanes, min(blocks, _ceil(lanes, WARP))), WARP) * WARP)
    return Geometry(_ceil(lanes, tile), 1, (tile,))


def row_scan_geometry(batch: int, outer: int, n: int, inner: int, sms: int) -> Geometry:
    """The blocks of a ``micro_row_scan`` launch on x [outer, n, inner],
    args (ow, kw, runs, r): a tile, one block, is a box of columns, ``ow``
    whole rows o or ``kw`` columns k of one o (GATHER_MIN_TILE at least, so
    that a row of the box fills 32-byte sectors), with all n rows; its
    threads split a chunk of rows into ``runs`` runs of ``r`` rows, scanned
    in shared memory, and walk the chunks in order.

    The rule, as ``gather_geometry``'s: an instance takes ceil(
    FILL_BLOCKS_PER_SM x SMs / batch) tiles, as far as its columns allow;
    then a column's rows are split over threads, ROW_SCAN_RUN rows a run,
    until the card holds SCAN_THREADS_PER_SM threads an SM in all or a
    block holds 1024. At B = 1 E4, E4b and G7 take 128 boxes of 8 columns
    in 32 runs of 16 rows, G6 16 boxes; from B_fill on, one box an
    instance, a thread a column over all n rows (runs 1, r = n): the
    one-block walk."""
    columns = outer * inner
    tiles = min(_ceil(FILL_BLOCKS_PER_SM * sms, batch), _ceil(columns, GATHER_MIN_TILE))
    ow, kw = 1, inner
    if tiles <= outer and inner <= MAX_THREADS:
        ow = min(_ceil(outer, tiles), MAX_THREADS // inner)
    else:  # a box holds 1024 columns at most, a thread each
        kw = min(MAX_THREADS, max(min(inner, GATHER_MIN_TILE), _ceil(inner, _ceil(tiles, outer))))
    box = min(ow, outer) * min(kw, inner)
    runs = max(1, min(MAX_THREADS // box, _ceil(n, ROW_SCAN_RUN),
                      _ceil(SCAN_THREADS_PER_SM * sms, batch * columns)))
    r = n if runs == 1 else min(ROW_SCAN_RUN, _ceil(n, runs))
    return Geometry(_ceil(outer, ow) * _ceil(inner, kw), runs, (ow, kw, runs, r))


@cache
def sm_count(device) -> int:
    """The card's SM count, which the launch geometries follow."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def switch_batch(p: "Probe", sms: int) -> int | None:
    """The first batch after 1 at which ``p``'s launch takes fewer tiles an
    instance than at B = 1, or stops or starts splitting its steps over
    groups (its geometry's first switch); None for a probe without a
    geometry rule, or one whose launch is the same at every batch."""
    if p.geometry is None:
        return None
    first = p.geometry(1, sms)
    for batch in range(2, FILL_BLOCKS_PER_SM * sms + 1):
        g = p.geometry(batch, sms)
        if g.tiles < first.tiles or (g.groups > 1) != (first.groups > 1):
            return batch
    return None


def _launch(key: str, device, fn: str, *args) -> None:
    _build.launch(f"probe_{key}", device, fn, *args)


def take_sum_kernel(key, x, q, axis: int, steps: int, mod: int | None):
    dim = axis + 1
    outer, n, inner = _around(x.shape, dim)
    shared = in_shared(x[0].numel() * 4)
    g = gather_geometry(x.shape[0], outer, inner, q.shape[dim], steps, sm_count(x.device))
    out = torch.empty_like(q)
    _launch(key, x.device, "sdf_micro_gather", x.data_ptr(), q.data_ptr(), out.data_ptr(), x.shape[0], outer, n,
            inner, q.shape[dim], steps, n if mod is None else mod, int(shared), *g.args)
    return out


def onehot_min_kernel(key, x, q, steps: int, mod: int | None):
    out = torch.empty_like(q[:, 0])
    g = onehot_min_geometry(x.shape[0], q[0].numel(), steps, sm_count(x.device))
    _launch(key, x.device, "sdf_micro_onehot_min", x.data_ptr(), q.data_ptr(), out.data_ptr(), x.shape[0],
            x.shape[1], q[0].numel(), steps, mod or 0, int(in_shared(x[0].numel() * 4)), *g.args)
    return out


def onehot_write_kernel(key, x, q, v, steps: int, mod: int | None, out_rows: int):
    shared = in_shared(x[0].numel() * 4)
    g = onehot_write_geometry(x.shape[0], x.shape[1], q[0].numel(), shared, sm_count(x.device))
    out = torch.empty((x.shape[0], out_rows, *x.shape[2:]), dtype=x.dtype, device=x.device)
    _launch(key, x.device, "sdf_micro_onehot_write", x.data_ptr(), q.data_ptr(), None if v is None else v.data_ptr(),
            out.data_ptr(), x.shape[0], x.shape[1], q[0].numel(), steps, mod or 0, out_rows, int(shared), *g.args)
    return out


def row_scan_kernel(key, x, axis: int):
    outer, n, inner = _around(x.shape, axis + 1)
    g = row_scan_geometry(x.shape[0], outer, n, inner, sm_count(x.device))
    out = torch.empty_like(x)
    _launch(key, x.device, "sdf_micro_row_scan", x.data_ptr(), out.data_ptr(), x.shape[0], outer, n, inner,
            *g.args)
    return out


def ops_kernel(key, x, steps: int):
    g = lane_geometry(x.shape[0], x[0].numel(), sm_count(x.device))
    out = torch.empty_like(x)
    _launch(key, x.device, "sdf_micro_ops", x.data_ptr(), out.data_ptr(), x.shape[0], x[0].numel(), steps,
            *g.args)
    return out


def empty_launch(device) -> None:
    """Launch the empty kernel (the launch floor), counted apart."""
    _build.launch("micro_empty", device, "sdf_micro_empty")


# ---- the probe record --------------------------------------------------------


@dataclass(frozen=True)
class Probe:
    """One probe: ``key`` ("E1"), ``label`` (the JAX script's line name),
    ``replaces`` (its TPU function, file:line of the def and the
    ``pallas_call``), ``kernel`` (one of KERNELS, or of ``_sampler.KERNELS``),
    ``build`` (the JAX probe's inputs as numpy arrays), ``plain`` and
    ``launch`` (batched tensors -> batched output), ``index`` (per input:
    the range an index input stays in, None for a value, ROLL or SHARED),
    ``out_shape`` (an instance's), ``steps``, ``work`` (units of work of an
    instance, each a ``unit``), ``ops`` (the 32-bit operations an instance
    needs of its own), ``memory`` (where the kernel reads its data),
    ``library`` (one PyTorch call of the same function on ``library_args``,
    or None), ``needs`` (instance 0's inputs as CPU tensors with their batch
    axis, not converted to ``dtypes`` -> (bytes of the shared data its
    output depends on, bytes of its own inputs its output depends on,
    operations on the shared data), each element and each distinct piece of
    work once; None: every input read, no shared work), ``in_shapes``
    (their shapes, set from ``build`` unless given), ``dtypes`` (each
    input's torch dtype; none given: int32), ``copied`` (bytes an instance
    copies by bulk copies), ``lo`` (the same probe at the lower of two
    iteration counts, for a probe timed as a slope), ``check`` (the JAX
    script's own check: the numpy inputs and instance 0's output -> bool),
    ``prepare`` (the inputs -> ``library``'s arguments) and ``geometry``
    (the batch and the SM count -> the launch's ``Geometry``, for a kernel
    whose blocks an instance depend on them; None: one block an
    instance).

    A batch counts the shared data and the work on it once, as instance 0
    needs them: the batch's union is at least that, so the bound stays a
    lower bound."""

    key: str
    label: str
    replaces: str
    kernel: str
    build: Callable[[], tuple]
    plain: Callable
    launch: Callable
    index: tuple
    out_shape: tuple
    steps: int
    work: int
    ops: int
    memory: str
    library: Callable | None = None
    needs: Callable | None = None
    in_shapes: tuple = ()
    dtypes: tuple = ()
    unit: str = "element-step"
    copied: int = 0
    lo: "Probe | None" = None
    check: Callable | None = None
    prepare: Callable | None = None
    geometry: Callable | None = None

    def __post_init__(self):
        if not self.in_shapes:
            object.__setattr__(self, "in_shapes", tuple(a.shape for a in self.build()))
        if not self.dtypes:
            object.__setattr__(self, "dtypes", (torch.int32,) * len(self.in_shapes))

    def __call__(self, *args: torch.Tensor) -> torch.Tensor:
        """The wrapper: the plain version on CPU tensors, the kernel on
        CUDA tensors."""
        shapes = self.in_shapes
        if len(args) != len(shapes):
            raise TypeError(f"{self.key}: expected {len(shapes)} tensors, got {len(args)}")
        dev = args[0].device
        batched = [a for a, rng in zip(args, self.index) if rng != SHARED and isinstance(a, torch.Tensor) and a.ndim]
        batch = batched[0].shape[0] if batched else 1
        for a, shape, dtype, rng in zip(args, shapes, self.dtypes, self.index):
            if not isinstance(a, torch.Tensor) or a.dtype != dtype or a.ndim != len(shape) + 1:
                raise TypeError(f"{self.key}: expected {dtype} tensors of shape [B, *{shape}]")
            want = 1 if rng == SHARED else batch
            if tuple(a.shape[1:]) != shape or a.shape[0] != want or batch < 1:
                raise ValueError(f"{self.key}: got {tuple(a.shape)}, expected [{want}, *{shape}] with one B >= 1")
            if a.device != dev or not a.is_contiguous():
                raise ValueError(f"{self.key}: tensors must be contiguous and on one device")
        if dev.type == "cpu":
            return self.plain(*args)
        if dev.type != "cuda":
            raise ValueError(f"{self.key}: unsupported device {dev}")
        return self.launch(*args)

    def inputs(self, batch: int, device) -> list[torch.Tensor]:
        """``batch`` instances of the JAX probe's inputs on ``device``:
        instance b adds b to each value, and to each index modulo its
        range; rolls each ROLL input (n long) by b * max(1, n // batch)
        along its first axis; a SHARED input is one copy (leading axis 1)."""
        b = torch.arange(batch, dtype=torch.int32, device=device)
        out = []
        for a, rng, dtype in zip(self.build(), self.index, self.dtypes):
            t = torch.as_tensor(a, device=device).to(dtype)[None]
            if rng == ROLL:
                stride = max(1, a.shape[0] // batch)
                t = torch.cat([torch.roll(t, i * stride, dims=1) for i in range(batch)])
            elif rng != SHARED:
                t = t + b.view(batch, *[1] * a.ndim)
                t = t if rng is None else torch.remainder(t, rng)
            out.append(t.contiguous())
        return out

    def library_args(self, args) -> list[torch.Tensor]:
        """``args`` with each index input as int64, as ``library`` takes
        them (converted apart, so that its time is one PyTorch call's), or
        ``prepare``'s arguments."""
        if self.prepare is not None:
            return self.prepare(*args)
        return [a if rng is None else a.long() for a, rng in zip(args, self.index)]

    @cached_property
    def need(self) -> tuple:
        """``needs`` of the JAX probe's inputs: (shared bytes, own bytes,
        shared operations)."""
        args = [torch.from_numpy(np.ascontiguousarray(a))[None] for a in self.build()]
        if self.needs is None:
            return 0, sum(a.numel() * dtype.itemsize for a, dtype in zip(args, self.dtypes)), 0
        return self.needs(args)

    def bytes(self, batch: int = 1) -> int:
        """Bytes the batch must move: the input elements each instance's
        output depends on read once (the shared data's once for the batch),
        the output written once (4 bytes an element)."""
        shared, own, _ = self.need
        return shared + batch * own + 4 * batch * math.prod(self.out_shape)

    def bound(self, batch: int = 1):
        """(ms, "bytes" or "operations"): the larger of the batch's bytes at
        the peak memory rate and its operations at OPS_PER_S."""
        t_bytes = self.bytes(batch) / HBM_BYTES_PER_S * 1e3
        t_ops = (self.need[2] + batch * self.ops) / OPS_PER_S * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _shapes(build):
    return [a.shape for a in build()]


def _memory(kernel: str, x_shape) -> str:
    if kernel == "micro_ops":
        return "registers (x read once)"
    if kernel == "micro_row_scan":
        return "device memory, each element read and written once"
    if in_shared(4 * math.prod(x_shape)):
        return "shared memory (staged once)"
    return "device memory through L1/L2"


def _x_needs(count):
    """``needs`` of a probe whose output depends on ``count(arrays)``
    elements of x (the first input) and on every other input (4 bytes an
    element); an instance's shifted copy needs as many (the shift permutes
    the index values)."""

    def needs(args):
        arrays = [a[0].numpy() for a in args]
        return 0, 4 * (count(arrays) + sum(a.size for a in arrays[1:])), 0

    return needs


def _indices(q: np.ndarray, steps: int, mod: int | None):
    """The index arrays of steps 0 .. steps-1: (q + i) % mod, or q."""
    return [q] if mod is None else [(q + i) % mod for i in range(steps)]


def _gathered(axis: int, steps: int, mod: int | None, arrays) -> int:
    """Distinct elements of x a take-along-axis probe reads."""
    x, q = arrays
    hit = np.zeros(x.shape, bool)
    for idx in _indices(q, steps, mod):
        np.put_along_axis(hit, np.broadcast_to(idx, np.broadcast_shapes(idx.shape, x.shape[:axis] + (1,)
                                                                        + x.shape[axis + 1:])), True, axis=axis)
    return int(hit.sum())


def _selected(steps: int, mod: int | None, arrays) -> int:
    """Distinct elements x[q_i, k] a one-hot min's output depends on."""
    x, q = arrays
    hit = np.zeros(x.shape, bool)
    for idx in _indices(q, steps, mod):
        hit |= np.arange(x.shape[0]).reshape(-1, *[1] * (x.ndim - 1)) == idx
    return int(hit.sum())


def _kept(steps: int, mod: int | None, out_rows: int, arrays) -> int:
    """Elements of x's first ``out_rows`` rows that no one-hot write of a
    step overwrites (the output's only dependence on x)."""
    x, q = arrays[:2]
    written = np.zeros(x.shape, bool)
    for idx in _indices(q, steps, mod):
        written |= np.arange(x.shape[0]).reshape(-1, *[1] * (x.ndim - 1)) == idx
    return int((~written[:out_rows]).sum())


def gather(key, label, replaces, build, axis: int, steps: int = 1, mod: int | None = None, out_shape=None,
           library: str | None = None) -> Probe:
    """A take-along-axis probe: ``steps`` gathers at ``(q + i) % mod``
    summed (one gather at q without ``mod``), in q's shape or the JAX
    probe's ``out_shape`` (its ``[0]`` of a unit axis). ``library``: the one
    PyTorch call that computes it, ``"gather"`` (``torch.gather``, E1-E3)
    or ``"sum"`` (where steps == mod, the window visits every index of the
    axis once whatever q is, so the probe is x's int32 sum over the axis,
    expanded to the output's shape: E1b, G1, G2, H5)."""
    x_shape, q_shape = _shapes(build)
    out_shape = tuple(q_shape if out_shape is None else out_shape)
    n_out = math.prod(q_shape)
    if library == "sum" and steps != mod:
        raise ValueError(f"{key}: a sum computes the probe only where steps == mod")

    def shaped(fn):
        return lambda x, q: fn(x, q).reshape(x.shape[0], *out_shape)

    def axis_sum(x):
        total = torch.sum(x, dim=axis + 1, keepdim=True, dtype=torch.int32)
        return total.expand(x.shape[0], *q_shape).reshape(x.shape[0], *out_shape)

    calls = {None: None, "gather": shaped(lambda x, q: torch.gather(x, axis + 1, q)), "sum": axis_sum}
    outer, _, inner = _around((1, *x_shape), axis + 1)
    return Probe(
        key, label, replaces, "micro_gather", build,
        plain=shaped(partial(take_sum_plain, axis=axis, steps=steps, mod=mod)),
        launch=shaped(partial(take_sum_kernel, key, axis=axis, steps=steps, mod=mod)),
        index=(None, mod or x_shape[axis]), out_shape=out_shape, steps=steps, work=n_out * steps,
        # per element-step: q + i, the modulus, the sum (a lone gather: none)
        ops=0 if mod is None else 3 * n_out * steps, memory=_memory("micro_gather", x_shape),
        library=calls[library], needs=_x_needs(partial(_gathered, axis, steps, mod)),
        prepare=(lambda x, q: [x]) if library == "sum" else None,
        geometry=lambda batch, sms: gather_geometry(batch, outer, inner, q_shape[axis], steps, sms),
    )


def onehot_min(key, label, replaces, build, steps: int, mod: int | None = None) -> Probe:
    """A one-hot select: x [D, ...], q [1, ...]; each step the minimum over
    d of ``where(d == q_i, x, 2^30)``, summed; q_i = (q + i) % mod, or q."""
    x_shape, q_shape = _shapes(build)
    n_out, D = math.prod(q_shape), x_shape[0]
    return Probe(
        key, label, replaces, "micro_onehot_min", build,
        plain=partial(onehot_min_plain, steps=steps, mod=mod),
        launch=partial(onehot_min_kernel, key, steps=steps, mod=mod),
        index=(None, mod or D), out_shape=tuple(q_shape[1:]), steps=steps, work=n_out * steps,
        # per element-step, what the function needs (it is x[q_i]): the select, the sum; q + i and the modulus
        ops=n_out * steps * (2 + (2 if mod else 0)), memory=_memory("micro_onehot_min", x_shape),
        needs=_x_needs(partial(_selected, steps, mod)),
        geometry=lambda batch, sms: onehot_min_geometry(batch, n_out, steps, sms),
    )


def onehot_write(key, label, replaces, build, steps: int = 1, mod: int | None = None, first_row: bool = False,
                 library: bool = False) -> Probe:
    """A one-hot write into w = x [D, ...]: each step ``w = where(d == q_i,
    v, w)`` with v the input after q, or the step i where there is none;
    the output is w, or its row 0 (``first_row``). ``library``:
    ``Tensor.scatter`` along axis 0 computes it (E6)."""
    shapes = _shapes(build)
    x_shape, D = shapes[0], shapes[0][0]
    inner = math.prod(x_shape[1:])
    out_rows = 1 if first_row else D
    out_shape = tuple(x_shape[1:]) if first_row else tuple(x_shape)
    shared = in_shared(4 * math.prod(x_shape))
    if not shared and steps > 1:
        raise ValueError(f"{key}: an x beyond shared memory takes one step (one streaming pass)")

    def shaped(fn):
        return lambda x, q, v=None: fn(x, q, v).reshape(x.shape[0], *out_shape)

    return Probe(
        key, label, replaces, "micro_onehot_write", build,
        plain=shaped(partial(onehot_write_plain, steps=steps, mod=mod, out_rows=out_rows)),
        launch=shaped(partial(onehot_write_kernel, key, steps=steps, mod=mod, out_rows=out_rows)),
        index=(None, mod or D, None)[:len(shapes)], out_shape=out_shape, steps=steps, work=D * inner * steps,
        # per column and step, what the function needs (one row changes): the write; q + i, the modulus
        ops=steps * inner * (1 + (2 if mod else 0)), memory=_memory("micro_onehot_write", x_shape),
        library=(lambda x, q, v: x.scatter(1, q, v)) if library else None,
        needs=_x_needs(partial(_kept, steps, mod, out_rows)),
        geometry=lambda batch, sms: onehot_write_geometry(batch, D, inner, shared, sms),
    )


def row_scan(key, label, replaces, build, axis: int) -> Probe:
    """``o_i = min(o_{i-1} + 1, x_i)`` along ``axis``, ``o_{-1} = 0``."""
    (x_shape,) = _shapes(build)
    cells = math.prod(x_shape)
    outer, n, inner = _around((1, *x_shape), axis + 1)
    return Probe(
        key, label, replaces, "micro_row_scan", build,
        plain=partial(row_scan_plain, axis=axis), launch=partial(row_scan_kernel, key, axis=axis),
        index=(None,), out_shape=tuple(x_shape), steps=x_shape[axis], work=cells,
        ops=2 * cells,  # the +1 and the min
        memory=_memory("micro_row_scan", x_shape),
        geometry=lambda batch, sms: row_scan_geometry(batch, outer, n, inner, sms),
    )


def ops(key, label, replaces, build, steps: int) -> Probe:
    """``acc = min(2 acc + 1, x + i)``, ``steps`` times from 0."""
    (x_shape,) = _shapes(build)
    n = math.prod(x_shape)
    return Probe(
        key, label, replaces, "micro_ops", build,
        plain=partial(ops_plain, steps=steps), launch=partial(ops_kernel, key, steps=steps),
        index=(None,), out_shape=tuple(x_shape), steps=steps, work=n * steps,
        ops=4 * n * steps,  # the doubling, the +1, x + i, the min
        memory=_memory("micro_ops", x_shape),
        geometry=lambda batch, sms: lane_geometry(batch, n, sms),
    )


# ---- measurement and the probe line ------------------------------------------


def fill_batch(device) -> int:
    """B_fill: FILL_BLOCKS_PER_SM instances (blocks) on every SM."""
    return FILL_BLOCKS_PER_SM * torch.cuda.get_device_properties(device).multi_processor_count


def measure(p: Probe, device, b_fill: int) -> dict:
    """One probe's record: its kernel's time on the device alone
    (``_timing.device_ms``) at B = 1 (``ms``, and per step) and at
    ``b_fill`` (``fill_ms``, and per instance-unit of work), beside its
    bound; at B = 1 also the wrapper's calls back to back (``launch_ms``,
    the host's launch path for a short kernel). A probe with ``lo`` also
    times it, and gives the slope between the two iteration counts (ns an
    iteration at B = 1, an instance-iteration at ``b_fill``); one that
    copies gives its copy rate (GB/s). ``ok``: the JAX script's own check
    of instance 0's output, where it has one. On the CPU its plain version
    runs at B = 1 and every time is NOT_MEASURED."""
    bound, bound_by = p.bound()
    rec = {"label": p.label, "kernel": p.kernel, "replaces": p.replaces, "memory": p.memory, "steps": p.steps,
           "unit": p.unit, "bytes": p.bytes(), "bound_ms": bound, "bound_by": bound_by}
    args = p.inputs(1, device)
    out = p(*args)
    rec["ok"] = True if p.check is None else bool(p.check(p.build(), out[0].cpu().numpy()))
    del out
    if device.type != "cuda":
        rec.update({k: NOT_MEASURED for k in ("ms", "launch_ms", "us_per_step", "fill_ms", "ns_per_element_step")})
        return rec
    ms = _timing.device_ms(lambda: p(*args), device)
    launch_ms = _timing.cuda_timed(lambda: p(*args), LAUNCH_REPS)[1] if ms < _timing.LONG_CALL_MS else NOT_MEASURED
    del args
    fill_args = p.inputs(b_fill, device)
    fill_ms = _timing.device_ms(lambda: p(*fill_args), device)
    del fill_args
    rec.update({
        "ms": ms, "launch_ms": launch_ms, "us_per_step": ms * 1e3 / p.steps, "fill_ms": fill_ms,
        "ns_per_element_step": fill_ms * 1e6 / (b_fill * p.work), "fill_bound_ms": p.bound(b_fill)[0],
    })
    if p.copied:
        rec["copy_GBps"] = p.copied / (ms * 1e-3) / 1e9
        rec["fill_copy_GBps"] = b_fill * p.copied / (fill_ms * 1e-3) / 1e9
    if p.lo is not None:
        lo = p.lo
        lo_args = lo.inputs(1, device)
        rec["lo_ms"] = _timing.device_ms(lambda: lo(*lo_args), device)
        lo_args = lo.inputs(b_fill, device)
        rec["lo_fill_ms"] = _timing.device_ms(lambda: lo(*lo_args), device)
        del lo_args
        di = p.steps - lo.steps
        rec["slope_ns"] = (ms - rec["lo_ms"]) * 1e6 / di
        rec["fill_slope_ns"] = (fill_ms - rec["lo_fill_ms"]) * 1e6 / (di * b_fill)
    return rec


def us(ms) -> str:
    """A time in ms as µs for a line, or NOT_MEASURED as it is."""
    return ms if ms == NOT_MEASURED else f"{ms * 1e3:.2f} us"


def line(rec: dict, b_fill) -> str:
    """The probe's printed line, the JAX script's name first."""
    ok = "OK" if rec["ok"] else "FAIL"
    if rec["ms"] == NOT_MEASURED:
        return f"{rec['label']}: {ok} {NOT_MEASURED} (the plain version on the CPU; times come from the card)"
    step = f" ({rec['us_per_step']:.4f} us/step)" if rec["steps"] > 1 else ""
    text = (f"{rec['label']}: {ok} {rec['ms'] * 1e3:9.2f} us on the device at B=1{step}, launched back to back"
            f" {us(rec['launch_ms'])}; B={b_fill}: {rec['fill_ms']:.4f} ms,"
            f" {rec['ns_per_element_step']:.5f} ns per instance-{rec['unit']}; bound {rec['bound_ms'] * 1e3:.4f} us"
            f" ({rec['bound_by']}); x in {rec['memory']}")
    if "slope_ns" in rec:
        text += (f"; slope {rec['slope_ns']:.2f} ns/iteration at B=1, {rec['fill_slope_ns']:.4f} ns per"
                 f" instance-iteration at B={b_fill} (lo {rec['lo_ms']:.4f} ms, {rec['lo_fill_ms']:.4f} ms)")
    if "copy_GBps" in rec:
        text += (f"; copies {rec['copy_GBps']:.1f} GB/s at B=1, {rec['fill_copy_GBps']:.1f} GB/s at B={b_fill}"
                 f" (peak memory rate {HBM_BYTES_PER_S / 1e9:.0f} GB/s)")
    return text


def main(probes, description: str, argv=None) -> dict:
    """Run ``probes`` in order on ``--device`` (default cuda), print one
    line each, and return {"device", "b_fill", "empty_ms" and
    "empty_launch_ms" (the empty kernel's, as a probe's ``ms`` and
    ``launch_ms``), "probes": {key: record}}."""
    from .validate_baseline import card_info

    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = require_device(args.device)
    result = {"device": card_info(device), "b_fill": NOT_MEASURED, "empty_ms": NOT_MEASURED,
              "empty_launch_ms": NOT_MEASURED}
    if device.type == "cuda":
        _build.library()
        result["b_fill"] = fill_batch(device)
        result["empty_ms"] = _timing.device_ms(lambda: empty_launch(device), device)
        result["empty_launch_ms"] = _timing.cuda_timed(lambda: empty_launch(device), LAUNCH_REPS)[1]
    print(f"device: {result['device']}; B_fill {result['b_fill']} (instances, one block each at most); empty kernel"
          f" {us(result['empty_ms'])} on the device, {us(result['empty_launch_ms'])} launched back to back",
          flush=True)
    result["probes"] = {}
    for p in probes:
        rec = measure(p, device, result["b_fill"])
        result["probes"][p.key] = rec
        print(line(rec, result["b_fill"]), flush=True)
    return result
