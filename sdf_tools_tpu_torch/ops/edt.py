"""Exact Euclidean distance transform and signed-field extraction.

Counterpart of ``sdf_tools_tpu/ops/edt.py``, same value semantics:

  * Axis 0 (binary seeds): per-line distance to the nearest seed.
  * Axes 1 and 2: the exact parabolic envelope
    ``out[i] = min_j f[j] + (i-j)^2`` over the already squared field.
  * Distances are exact int32 squared cell distances; ``INF_D2`` marks
    "no seed anywhere" and comes out exactly ``INF_D2``.
  * Signed combine: ``sqrt(d2_filled)*res - sqrt(d2_free)*res``, positive in
    free space, at most ``-res`` inside filled space.

Backends (``BACKENDS``):

  * ``"auto"``: the CUDA kernels of ``edt_cuda`` for CUDA tensors (the
    two-field chain K1 -> K2 -> K3, or K4 -> K5 -> K5 for one field), their
    plain PyTorch versions for CPU tensors.
  * ``"plain"``: the plain PyTorch versions on any device.
  * ``"cht"``: the line pass K4 and the convex-hull envelope K9 (their
    plain versions on a CPU tensor), exact for the JAX kernel's inputs.
  * ``"stencil"``, ``"scan"``, ``"brute"``: the line pass K4 and the JAX
    package's XLA-side envelopes as plain torch (no kernel: the JAX
    package has none for them either). ``"scan"`` clamps seedless lines
    to ``INF_D2 + 2n^2``, as the JAX scan does.
  * ``"reference"``: the native bucket-queue propagation of the reference
    on the host (``native.py``), with its rare overestimates.

``"pallas"`` names the JAX package's TPU kernels and raises. Every backend
but ``"auto"`` and ``"plain"`` runs the two-field functions as two
``squared_edt`` calls and the plain combine, as the JAX package does for
every backend but its Pallas one.

For volumes near the device's memory, ``signed_field_lowmem`` runs one
field at a time, and ``squared_edt_slabbed`` / ``signed_field_slabbed``
run slabs along x, streaming the signed field to host memory.
"""
from __future__ import annotations

import math
from typing import Iterator, Tuple

import numpy as np
import torch

from .. import profiling
from ..grid import GridMeta, SdfGrid, require_device

# No seed reachable. INF_D2 + (n-1)^2 < 2^31 for any axis n <= 16384, so the
# envelope's int32 sums never overflow.
INF_D2 = 1 << 29
MAX_ENVELOPE_AXIS = 16384
_LINE_SENTINEL = 1 << 24
BACKENDS = ("auto", "plain", "cht", "stencil", "scan", "brute", "reference")


def _seed_scans(mask: torch.Tensor, axis: int):
    """(iota, last, next): each cell's index along ``axis`` and the index of
    the nearest True at or before it / at or after it (``-2^30`` / ``2^30``
    where there is none). Two cummax scans over seed positions."""
    mask = mask.to(torch.bool)
    n = mask.shape[axis]
    shape = [1] * mask.ndim
    shape[axis] = n
    iota = torch.arange(n, dtype=torch.int32, device=mask.device).reshape(shape)
    neg = -(1 << 30)
    last_seed = torch.cummax(torch.where(mask, iota, neg), dim=axis).values
    rev = torch.where(mask, -iota, neg).flip(axis)
    next_seed = -torch.cummax(rev, dim=axis).values.flip(axis)
    return iota, last_seed, next_seed


def line_seed_d2(mask: torch.Tensor, axis: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(d2, seed): the squared distance (int32) along ``axis`` to the nearest
    True in ``mask``, exactly ``INF_D2`` where a line has no seed, and that
    seed's index along the axis (the earlier seed when two are as near, 0
    in a line without a seed; the JAX package's ``feature._line_seed_x``)."""
    iota, last_seed, next_seed = _seed_scans(mask, axis)
    fwd = iota - last_seed
    bwd = next_seed - iota
    d = torch.minimum(fwd, bwd)
    no_seed = d >= _LINE_SENTINEL
    seed = torch.where(no_seed, 0, torch.where(fwd <= bwd, last_seed, next_seed))
    return torch.where(no_seed, INF_D2, d * d), seed


def line_distance_to_seed(mask: torch.Tensor, axis: int) -> torch.Tensor:
    """Distance (cells, int32) along ``axis`` to the nearest True in
    ``mask``, ``1 << 24`` where a line has no seed (the JAX package's
    ``line_distance_to_seed``)."""
    iota, last_seed, next_seed = _seed_scans(mask, axis)
    return torch.minimum(iota - last_seed, next_seed - iota).clamp_(max=_LINE_SENTINEL)


def line_d2(mask: torch.Tensor, axis: int) -> torch.Tensor:
    """Squared line distance, exactly ``INF_D2`` where a line has no seed."""
    d = line_distance_to_seed(mask, axis)
    no_seed = d >= _LINE_SENTINEL
    d = torch.where(no_seed, 0, d)
    return torch.where(no_seed, INF_D2, d * d)


def envelope_pass_brute(f: torch.Tensor, axis: int, max_temp_elems: int = 1 << 27) -> torch.Tensor:
    """Exact envelope by a broadcast min-plus over whole lines, chunked over
    lines so that the ``[lines, n, n]`` temporary stays under
    ``max_temp_elems`` int32 elements (512 MB by default)."""
    n = f.shape[axis]
    if n == 1:
        return f.clone()
    fm = f.movedim(axis, -1)
    lines = fm.reshape(-1, n)
    i = torch.arange(n, dtype=torch.int32, device=f.device)
    quad = (i[:, None] - i[None, :]) ** 2  # [n_i, n_j]
    out = torch.empty_like(lines)
    step = max(1, max_temp_elems // (n * n))
    for s in range(0, lines.shape[0], step):
        out[s : s + step] = (lines[s : s + step, None, :] + quad).amin(dim=-1)
    return out.reshape(fm.shape).movedim(-1, axis).contiguous()


def _shift_with_inf(f: torch.Tensor, axis: int, shift: int) -> torch.Tensor:
    """``out[i] = f[i - shift]`` along ``axis``, ``INF_D2`` where that
    falls outside the line."""
    n = f.shape[axis]
    out = torch.full_like(f, INF_D2)
    k = abs(shift)
    src, dst = (0, k) if shift > 0 else (k, 0)
    out.narrow(axis, dst, n - k).copy_(f.narrow(axis, src, n - k))
    return out


def envelope_pass_stencil(f: torch.Tensor, axis: int, max_iters: int | None = None) -> torch.Tensor:
    """Exact envelope by iterated odd-weight 3-tap min-plus relaxation
    (weight ``2t - 1`` at step t), stopped after the first step that changes
    nothing: values only fall and the weights only grow, so a quiescent step
    certifies the fixed point. One host sync per step."""
    n = f.shape[axis]
    if n == 1:
        return f.clone()
    if max_iters is None:
        max_iters = n - 1
    d = f.to(torch.int32)
    for t in range(1, max_iters + 1):
        cand = torch.minimum(_shift_with_inf(d, axis, 1), _shift_with_inf(d, axis, -1)) + (2 * t - 1)
        new_d = torch.minimum(d, cand)
        done = torch.equal(new_d, d)
        d = new_d
        if done:
            break
    return d


def envelope_pass_scan(f: torch.Tensor, axis: int) -> torch.Tensor:
    """Exact envelope by the JAX package's lockstep integer Meijster scan:
    a forward scan builds every line's stack of parabolas (apexes ``s``,
    integer take-over points ``t``) with masked pops, a backward scan
    evaluates it; the output is clamped to ``INF_D2 + 2n^2``. A loop of small
    torch ops with a host sync per pop round: a correctness backend."""
    n = f.shape[axis]
    if n == 1:
        return f.clone()
    fm = f.to(torch.int32).movedim(axis, -1)
    batch_shape = fm.shape[:-1]
    fb = fm.reshape(-1, n)
    B = fb.shape[0]
    rows = torch.arange(B, device=f.device)

    def F(x, i, fi):
        d = x - i
        return d * d + fi

    s = torch.zeros((B, n), dtype=torch.int32, device=f.device)
    t = torch.zeros_like(s)
    fs = torch.zeros_like(s)
    fs[:, 0] = fb[:, 0]
    q = torch.zeros(B, dtype=torch.int32, device=f.device)
    for u in range(1, n):
        fu = fb[:, u]
        # pop while the top parabola is above the new one at its take-over point
        while True:
            qc = q.clamp(min=0).long()
            tq = t[rows, qc]
            bad = (q >= 0) & (F(tq, s[rows, qc], fs[rows, qc]) > F(tq, u, fu))
            if not bool(bad.any()):
                break
            q = torch.where(bad, q - 1, q)
        revived = q < 0
        qc = q.clamp(min=0).long()
        sq, fsq = s[rows, qc], fs[rows, qc]
        # integer take-over point (floor division; operands fit int32)
        den = (2 * (u - sq)).clamp(min=1)
        w = 1 + torch.div(u * u - sq * sq + fu - fsq, den, rounding_mode="floor")
        push = ~revived & (w < n)
        new_q = torch.where(revived, 0, torch.where(push, q + 1, q))
        write = revived | push
        wr, wq = rows[write], new_q[write].long()
        s[wr, wq] = u
        fs[wr, wq] = fu[write]
        t[wr, wq] = torch.where(revived, 0, w)[write]
        q = new_q
    out = torch.empty_like(s)
    for u in range(n - 1, -1, -1):
        qc = q.long()
        out[:, u] = F(u, s[rows, qc], fs[rows, qc])
        q = torch.where((t[rows, qc] == u) & (q > 0), q - 1, q)
    out.clamp_(max=INF_D2 + 2 * n * n)
    return out.reshape(fm.shape).movedim(-1, axis).contiguous()


DISTANCE_DTYPES = (torch.float32, torch.float64, torch.bfloat16, torch.float16)


def _check_dtype(dtype) -> None:
    if dtype not in DISTANCE_DTYPES:
        raise TypeError(f"distance dtype {dtype!r}: one of {DISTANCE_DTYPES}")


def d2_to_distance(d2: torch.Tensor, resolution, dtype=torch.float32) -> torch.Tensor:
    """sqrt(d^2) * resolution in ``dtype``, with the INF sentinel mapped to
    +inf: d^2 is cast to ``dtype``, its root taken in ``dtype`` and
    multiplied by the resolution cast to ``dtype``, as in the JAX package.

    Every root is correctly rounded in its dtype, as in XLA and in CUDA.
    PyTorch's vectorised square roots on the CPU are not (torch 2.13 on
    AVX512, counted by ``tools/sqrt_midpoints.py``): 69 of the 12288
    float32 values d^2 < 3*64^2 come out one ulp off, and the float64 root
    is one ulp off for 215 of the integers 0 ... 36864. So:

      * float32: the root is taken in float64 and rounded once to float32.
        That is the correctly rounded float32 root of every integer n below
        2^31 (a float32 cast of an int32 d^2 is one), even where the float64
        root is one ulp off. A float32 rounding midpoint m of a root in
        [2^e, 2^(e+1)) is an odd multiple of 2^(e-24), so m^2 is an odd
        multiple of 2^(2e-48): with e <= 15, not an integer, and
        |n - m^2| >= 2^(2e-48). Then |sqrt(n) - m| = |n - m^2| /
        (sqrt(n) + m) > 2^(2e-48) / 2^(e+2) = 2^(e-50), more than 4 float64
        ulps (2^(e-52)) away from every midpoint (``tools/sqrt_midpoints.py``
        counts the margin); a root that is exact (n a square) is a float32.
        The root and the scaling run in place on the temporaries (a 1024^3
        field is 8.6 GB in float64).
      * float64: ``torch.sqrt`` on the card, ``np.sqrt`` in place on the
        host array on the CPU (numpy's root is the IEEE one, and the one
        XLA's CPU root equals).
      * bfloat16 and float16: d^2 rounded to the dtype (an integer still,
        or inf past float16's range), its float32 root as above, rounded
        to the dtype; the product is taken in the dtype.
    """
    _check_dtype(dtype)
    res = torch.as_tensor(resolution, dtype=dtype, device=d2.device)
    v = torch.where(d2 >= INF_D2, math.inf, d2.to(dtype))
    if dtype == torch.float64:
        if v.device.type == "cpu":
            np.sqrt(v.numpy(), out=v.numpy())
        else:
            v.sqrt_()
        return v.mul_(res)
    return v.to(torch.float64).sqrt_().to(torch.float32).to(dtype).mul_(res)


def resolve_backend(backend: str) -> str:
    """The backend, checked: ``"pallas"`` (the JAX package's TPU kernels)
    raises and points to ``"auto"``, an unknown name raises. ``"auto"``
    stays ``"auto"``: the port decides per tensor (kernel on the card,
    plain version on the CPU)."""
    if backend == "pallas":
        raise NotImplementedError(
            "EDT backend 'pallas' names the JAX package's TPU kernels; use 'auto', which runs"
            " the port's CUDA kernels on the card and their plain versions on the CPU"
        )
    if backend not in BACKENDS:
        raise ValueError(f"unknown EDT backend {backend!r}; one of {BACKENDS}")
    return backend


def _chain(backend: str):
    """(line_pass_dual, envelope_dual, envelope_dual_combine) for a backend."""
    from . import edt_cuda

    return edt_cuda.for_backend(backend, "line_pass_dual", "envelope_dual", "envelope_dual_combine")


def _single_field(backend: str):
    """(line_pass(mask, square), envelope(f, axis)) of one field under a
    backend: every backend but ``"plain"`` runs the line pass K4 (its plain
    version on a CPU tensor; the JAX package's XLA line pass computes the
    same function) before its envelope. ``"reference"`` works on whole
    volumes on the host and has no such pair."""
    from . import edt_cuda

    table = {
        "auto": (edt_cuda.line_pass, edt_cuda.envelope),
        "plain": (edt_cuda.line_pass_plain, edt_cuda.envelope_plain),
        "cht": (edt_cuda.line_pass, edt_cuda.envelope_cht),
        "stencil": (edt_cuda.line_pass, envelope_pass_stencil),
        "scan": (edt_cuda.line_pass, envelope_pass_scan),
        "brute": (edt_cuda.line_pass, envelope_pass_brute),
    }
    if resolve_backend(backend) not in table:
        raise ValueError(f"EDT backend {backend!r} has no line pass and envelope; only squared_edt runs it")
    return table[backend]


def _as_mask3(filled_mask, device=None) -> torch.Tensor:
    """A contiguous bool [X, Y, Z] tensor; a numpy mask goes to ``device``,
    which it must name (a CUDA device without CUDA raises), a tensor stays
    where it is."""
    if isinstance(filled_mask, torch.Tensor):
        mask = filled_mask.to(torch.bool)
    elif device is None:
        raise ValueError("a numpy mask needs an explicit device= (a tensor brings its own)")
    else:
        mask = torch.as_tensor(np.asarray(filled_mask, dtype=bool), device=require_device(device))
    if mask.ndim != 3:
        raise ValueError(f"expected a 3D mask, got shape {tuple(mask.shape)}")
    return mask.contiguous()


def squared_edt(seed_mask, backend: str = "auto", *, device=None) -> torch.Tensor:
    """Exact int32 squared Euclidean cell distances to the True set of
    ``seed_mask``; ``INF_D2`` where there is no seed at all.

    The line pass along x, then the envelope along y and z (``"auto"`` on
    the card: K4, K5, K5). ``backend="reference"`` runs the native
    re-implementation of the reference's bucket-queue propagation on the
    host (``native/sdf_native.cpp``) and reproduces its outputs including
    its rare overestimates; it raises when the native library cannot be
    built."""
    if backend == "reference":
        from .. import native

        mask = _as_mask3(seed_mask, device)
        mask_np = mask.cpu().numpy()
        if not mask_np.any():
            return torch.full(mask.shape, INF_D2, dtype=torch.int32, device=mask.device)
        d2 = native.edt_reference(mask_np)
        return torch.as_tensor(np.minimum(d2, INF_D2).astype(np.int32), device=mask.device)
    line_pass, envelope = _single_field(backend)
    f = line_pass(_as_mask3(seed_mask, device))
    f = envelope(f, 1)
    return envelope(f, 2)


def _fused(backend: str) -> bool:
    return resolve_backend(backend) in ("auto", "plain")


def squared_edt_both(filled_mask, backend: str = "auto", *, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(d2_filled, d2_free): exact squared EDTs to the True set and to the
    False set of ``filled_mask``. ``"auto"`` and ``"plain"`` run both fields
    through one chain of launches (K1 -> K2 -> K2 on the card); the other
    backends run ``squared_edt`` twice. A numpy mask goes to ``device``, as
    in ``squared_edt``."""
    mask = _as_mask3(filled_mask, device)
    if not _fused(backend):
        return squared_edt(mask, backend), squared_edt(~mask, backend)
    line_pass, envelope, _ = _chain(backend)
    fa, fb = line_pass(mask)
    fa, fb = envelope(fa, fb, 1)
    return envelope(fa, fb, 2)


def signed_field_from_masks(
    filled_mask, resolution, backend: str = "auto", dtype=torch.float32, *, device=None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Two-field signed distance values (reference sdf_generation.hpp:242-268).

    Returns (sdf_values in ``dtype``, max_distance, min_distance): positive
    in free space, at most ``-resolution`` inside filled space. A float32
    field at a scalar resolution under ``"auto"`` or ``"plain"`` takes the
    fused chain (K1 -> K2 -> K3 on the card), as the JAX package's Pallas
    route does; any other takes ``squared_edt_both`` and ``d2_to_distance``
    of each field in ``dtype``, subtracted in ``dtype``. A numpy mask goes
    to ``device``, as in ``squared_edt``."""
    _check_dtype(dtype)
    mask = _as_mask3(filled_mask, device)
    if dtype == torch.float32 and np.ndim(resolution) == 0 and _fused(backend):
        line_pass, envelope, combine = _chain(backend)
        fa, fb = line_pass(mask)
        fa, fb = envelope(fa, fb, 1)
        dist = combine(fa, fb, resolution)
    else:
        dist = signed_from_d2(*squared_edt_both(mask, backend), resolution, dtype)
    return dist, dist.max(), dist.min()


def signed_from_d2(d2_filled: torch.Tensor, d2_free: torch.Tensor, resolution, dtype=torch.float32) -> torch.Tensor:
    """The signed field in ``dtype`` from its two d^2 fields: the distances
    to the filled set less those to the free set, on the fields' device."""
    return d2_to_distance(d2_filled, resolution, dtype) - d2_to_distance(d2_free, resolution, dtype)


def signed_field_lowmem(filled_mask, resolution, backend: str = "auto", *, device=None) -> torch.Tensor:
    """The signed field one stage at a time, for volumes near the device's
    memory: the filled field's d^2 and its distances, then the free
    field's, each d^2 freed before the next stage (peak: the mask, one d^2
    field, one distance field and the combine's temporaries)."""
    mask = _as_mask3(filled_mask, device)
    d2 = squared_edt(mask, backend)
    part = d2_to_distance(d2, resolution)
    del d2
    d2 = squared_edt(~mask, backend)
    neg = d2_to_distance(d2, resolution)
    del d2
    return part.sub_(neg)


def _slab_summaries(mask: torch.Tensor, n_slabs: int):
    """Per-slab line summaries along x: for each (y, z) line, the distance
    from each slab's low and high boundary to its nearest in-slab seed
    (``1 << 24`` if the slab holds none). Returns (lows, highs
    [n_slabs, Y, Z] int32, slab length, the sentinel)."""
    sl = mask.shape[0] // n_slabs
    sent = _LINE_SENTINEL
    iota = torch.arange(sl, dtype=torch.int32, device=mask.device)[:, None, None]
    lows, highs = [], []
    for i in range(n_slabs):
        slab = mask[i * sl : (i + 1) * sl]
        first = torch.where(slab, iota, sent).amin(0)
        last = torch.where(slab, iota, -sent).amax(0)
        lows.append(torch.where(first >= sent, sent, first))
        highs.append(torch.where(last <= -sent, sent, sl - 1 - last))
    return torch.stack(lows), torch.stack(highs), sl, sent


def squared_edt_slabbed(seed_mask, n_slabs: int = 2, backend: str = "auto", *, device=None) -> Iterator[torch.Tensor]:
    """Exact squared EDT slab by slab along x, for volumes beyond one shot:
    yields each slab's int32 d^2 ``[X / n_slabs, Y, Z]`` in order.

    The x line pass decomposes across slabs through per-line boundary
    summaries; the y and z envelopes never cross x, so each slab is
    independent given them. Each slab's local line pass is the linear
    distance (K4 with ``square=False`` under ``"auto"`` on the card), so it
    combines with the summaries before squaring; then the backend's
    envelope along y and z (K5 twice under ``"auto"``)."""
    line_pass, envelope = _single_field(backend)
    mask = _as_mask3(seed_mask, device)
    if mask.shape[0] % n_slabs != 0:
        raise ValueError(
            f"shape[0]={mask.shape[0]} must be divisible by n_slabs={n_slabs}"
            " (the cross-slab distance decomposition assumes uniform slabs)"
        )
    lows, highs, sl, sent = _slab_summaries(mask, n_slabs)
    sh = torch.arange(n_slabs, dtype=torch.int32, device=mask.device)[:, None, None]
    iota = torch.arange(sl, dtype=torch.int32, device=mask.device)[:, None, None]
    for i in range(n_slabs):
        d_local = line_pass(mask[i * sl : (i + 1) * sl], square=False)
        best_below = torch.where(sh < i, (i - sh - 1) * sl + highs + 1, sent).amin(0)
        best_above = torch.where(sh > i, (sh - i - 1) * sl + lows + 1, sent).amin(0)
        d = torch.minimum(d_local, torch.minimum(best_below + iota, best_above + (sl - 1 - iota)))
        no_seed = d >= sent
        d = torch.where(no_seed, 0, d)
        f = torch.where(no_seed, INF_D2, d * d)
        del d, d_local, no_seed
        f = envelope(f, 1)
        yield envelope(f, 2)


def signed_field_slabbed(
    filled_mask, resolution, n_slabs: int = 4, backend: str = "auto", prefetch: int = 2, *, device=None
) -> np.ndarray:
    """Exact signed field slab by slab, streamed to host memory; returns a
    numpy float32 ``[X, Y, Z]`` array.

    Each slab's values are copied into a pinned host buffer with
    ``non_blocking=True`` and one CUDA event recorded after the copy; a
    window of ``prefetch`` slabs stays in flight, drained in order (wait
    for the slab's event, then copy it into the result), so slab i+1's
    kernels overlap slab i's transfer. Device peak: the mask, one slab of
    each d^2 field and the slabs in flight."""
    mask = _as_mask3(filled_mask, device)
    if mask.shape[0] % n_slabs != 0:
        raise ValueError(f"shape[0]={mask.shape[0]} must be divisible by n_slabs={n_slabs}")
    out = np.empty(tuple(mask.shape), np.float32)
    sl = mask.shape[0] // n_slabs
    on_card = mask.device.type == "cuda"
    fill_iter = squared_edt_slabbed(mask, n_slabs, backend)
    free_iter = squared_edt_slabbed(~mask, n_slabs, backend)
    in_flight = []

    def drain_one():
        j, host, done = in_flight.pop(0)
        if done is not None:
            done.synchronize()
        out[j * sl : (j + 1) * sl] = host.numpy()

    for i, (d2f, d2e) in enumerate(zip(fill_iter, free_iter)):
        vals = d2_to_distance(d2f, resolution).sub_(d2_to_distance(d2e, resolution))
        del d2f, d2e
        if on_card:
            host = torch.empty(vals.shape, dtype=vals.dtype, pin_memory=True)
            host.copy_(vals, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        else:
            host, done = vals, None
        in_flight.append((i, host, done))
        del vals
        if len(in_flight) > max(prefetch, 1):
            drain_one()
    while in_flight:
        drain_one()
    return out


def _virtual_border_masks(filled_mask: torch.Tensor):
    """Enlarged masks for the virtual-border variant (sdf_generation.hpp:289-379)."""
    shape = filled_mask.shape
    offs = tuple(2 if s > 1 else 0 for s in shape)
    qoffs = tuple(1 if s > 1 else 0 for s in shape)
    big_shape = tuple(s + o for s, o in zip(shape, offs))
    inner = tuple(slice(q, q + s) for q, s in zip(qoffs, shape))
    big = torch.zeros(big_shape, dtype=torch.bool, device=filled_mask.device)
    big[inner] = filled_mask
    border = torch.zeros_like(big)
    for ax, o in enumerate(offs):
        if o > 0:
            border.select(ax, 0).fill_(True)
            border.select(ax, big_shape[ax] - 1).fill_(True)
    return big | border, big & ~border, inner


def signed_field_virtual_border(
    filled_mask, resolution, backend: str = "auto", dtype=torch.float32, *, device=None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Virtual-border signed field (reference sdf_generation.hpp:273-420):
    one cell of border per side (per axis with >1 cells), a "free" field
    with the border pretended filled and a "filled" field with it pretended
    empty; free value if >= 0, else filled value if <= -0, else 0, in
    ``dtype``. Extrema are (free max, filled min) over the enlarged grids.
    A numpy mask goes to ``device``, as in ``squared_edt``."""
    free_variant, filled_variant, inner = _virtual_border_masks(_as_mask3(filled_mask, device))
    free_sdf, free_max, _ = signed_field_from_masks(free_variant, resolution, backend, dtype)
    filled_sdf, _, filled_min = signed_field_from_masks(filled_variant, resolution, backend, dtype)
    return virtual_border_combine(free_sdf, filled_sdf, inner), free_max, filled_min


def virtual_border_combine(free_sdf: torch.Tensor, filled_sdf: torch.Tensor, inner) -> torch.Tensor:
    """The inner cells of the virtual border's two fields: the free field's
    value if >= 0, else the filled field's if <= -0, else a zero of their
    dtype."""
    fs = free_sdf[inner]
    bs = filled_sdf[inner]
    return torch.where(fs >= 0.0, fs, torch.where(bs <= -0.0, bs, torch.zeros_like(fs))).contiguous()


def extract_signed_distance_field(
    filled_mask: torch.Tensor,
    meta: GridMeta,
    oob_value=math.inf,
    add_virtual_border: bool = False,
    backend: str = "auto",
) -> Tuple[SdfGrid, Tuple[torch.Tensor, torch.Tensor]]:
    """Build an SdfGrid from a filled-voxel mask (reference
    ``CollisionMapGrid::ExtractSignedDistanceField``). Returns
    (sdf, (max_distance, min_distance))."""
    with profiling.span("field"):
        field = signed_field_virtual_border if add_virtual_border else signed_field_from_masks
        with profiling.span("field.edt"):
            values, mx, mn = field(filled_mask, meta.resolution_float, backend)
        return SdfGrid.create(values, meta, oob_value), (mx, mn)
