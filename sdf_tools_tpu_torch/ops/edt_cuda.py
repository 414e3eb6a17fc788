"""Wrappers of the hand-written CUDA kernels of the exact EDT, each beside
its plain PyTorch version.

  K1 ``line_pass_dual``        csrc/edt_line_pass.cu  (TPU: edt_pallas._line_pass_dual_kernel)
  K2 ``envelope_dual``         csrc/edt_envelope.cu   (TPU: edt_pallas._envelope_dual_kernel)
  K3 ``envelope_dual_combine`` csrc/edt_envelope.cu   (TPU: edt_pallas._envelope_dual_combine_kernel)
  K4 ``line_pass``             csrc/edt_line_pass.cu  (TPU: edt_pallas._line_pass_kernel)
  K5 ``envelope``              csrc/edt_envelope.cu   (TPU: edt_pallas._envelope_kernel)
  K6 ``envelope_carry``        csrc/edt_carry.cu      (TPU: edt_pallas._envelope_carry_kernel)
     (``envelope_argmin`` is its winner form)
  K7 ``winner_segment_sum``    csrc/edt_segsum.cu     (TPU: edt_pallas._segsum_axis0_kernel,
                                                       _segsum_windowed_kernel)
  K9 ``envelope_cht``          csrc/edt_cht.cu        (TPU: edt_cht._cht_kernel)

A wrapper checks its inputs, then runs the plain version for a CPU tensor
and launches its kernel on the current stream for a CUDA tensor, raising if
the launch fails. ``LAUNCHES[name]`` (``_build.LAUNCHES``, shared with the
plane-sweep kernel K8) counts kernel launches only, so a run can show that
its main path went through the kernels. All arrays are
contiguous ``[X, Y, Z]`` (z fastest); any axis may have length 1.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .._build import LAUNCHES, reset_launches  # noqa: F401  (re-exported)
from .._build import launch as _launch
from .edt import (
    INF_D2, MAX_ENVELOPE_AXIS, envelope_pass_brute, line_d2, line_distance_to_seed, resolve_backend, signed_from_d2,
)

MAX_PAYLOADS = 3
# K9's contract, the JAX kernel's: a scan axis of at most 1024, and outputs
# above 3 * 1024^2 + 1024 (global 1024, not n) come from no source
CHT_MAX_AXIS = 1024
CHT_CLAMP = 3 * 1024 * 1024 + 1024


def _check(t: torch.Tensor, name: str, dtypes) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(t).__name__}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if t.ndim != 3 or t.numel() == 0:
        raise ValueError(f"{name}: expected a non-empty [X, Y, Z] tensor, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")


def _check_pair(fa: torch.Tensor, fb: torch.Tensor, name: str) -> None:
    _check(fa, name, (torch.int32,))
    _check(fb, name, (torch.int32,))
    if fa.shape != fb.shape or fa.device != fb.device:
        raise ValueError(f"{name}: fields differ: {tuple(fa.shape)}@{fa.device} vs {tuple(fb.shape)}@{fb.device}")


def for_backend(backend: str, *names: str):
    """The named kernel functions under an EDT backend: ``"plain"`` gives
    the plain versions on any device, every other backend the wrappers
    (the kernel for a CUDA tensor, the plain version for a CPU tensor).
    These are exact transforms, and every exact backend computes the same
    function, so ``"cht"``, ``"stencil"``, ``"scan"``, ``"brute"`` and
    ``"reference"`` take the ``"auto"`` route here (the JAX package's
    feature transform runs one exact argmin envelope for all of them too);
    their own one-field envelopes are chosen in ``edt._single_field``.
    ``"pallas"`` and unknown names raise (``edt.resolve_backend``)."""
    suffix = "_plain" if resolve_backend(backend) == "plain" else ""
    return tuple(globals()[name + suffix] for name in names)


# ---- K1: dual line pass along axis 0 -------------------------------------


def line_pass_dual_plain(mask: torch.Tensor, square: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """(distance to the True set, distance to the False set) along axis 0:
    squared with ``INF_D2`` where a column has no such seed, or with
    ``square=False`` linear with the ``1 << 24`` sentinel."""
    m = mask.to(torch.bool)
    return line_pass_plain(m, square), line_pass_plain(~m, square)


def line_pass_dual(mask: torch.Tensor, square: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    _check(mask, "line_pass_dual", (torch.bool, torch.uint8))
    if mask.device.type == "cpu":
        return line_pass_dual_plain(mask, square)
    X, Y, Z = mask.shape
    a = torch.empty(mask.shape, dtype=torch.int32, device=mask.device)
    b = torch.empty_like(a)
    _launch(
        "line_pass_dual", mask.device, "sdf_line_pass_dual",
        mask.data_ptr(), a.data_ptr(), b.data_ptr(), X, Y, Z, int(bool(square)),
    )
    return a, b


# ---- K4: line pass along axis 0 ------------------------------------------


def line_pass_plain(mask: torch.Tensor, square: bool = True) -> torch.Tensor:
    """Distance along axis 0 to the nearest True: squared with ``INF_D2``
    where a column has no seed, or with ``square=False`` linear with the
    ``1 << 24`` sentinel."""
    return line_d2(mask, 0) if square else line_distance_to_seed(mask, 0)


def line_pass(mask: torch.Tensor, square: bool = True) -> torch.Tensor:
    _check(mask, "line_pass", (torch.bool, torch.uint8))
    if mask.device.type == "cpu":
        return line_pass_plain(mask, square)
    X, Y, Z = mask.shape
    out = torch.empty(mask.shape, dtype=torch.int32, device=mask.device)
    _launch("line_pass", mask.device, "sdf_line_pass", mask.data_ptr(), out.data_ptr(), X, Y, Z, int(bool(square)))
    return out


# ---- K2: dual envelope along axis 1 or 2 ---------------------------------


def envelope_dual_plain(fa: torch.Tensor, fb: torch.Tensor, axis: int) -> Tuple[torch.Tensor, torch.Tensor]:
    return envelope_pass_brute(fa, axis), envelope_pass_brute(fb, axis)


def envelope_dual(fa: torch.Tensor, fb: torch.Tensor, axis: int) -> Tuple[torch.Tensor, torch.Tensor]:
    _check_pair(fa, fb, "envelope_dual")
    if axis not in (1, 2):
        raise ValueError(f"envelope_dual: axis must be 1 or 2, got {axis}")
    if fa.shape[axis] > MAX_ENVELOPE_AXIS:
        raise ValueError(f"envelope_dual: axis length {fa.shape[axis]} > {MAX_ENVELOPE_AXIS}")
    if fa.device.type == "cpu":
        return envelope_dual_plain(fa, fb, axis)
    X, Y, Z = fa.shape
    oa = torch.empty_like(fa)
    ob = torch.empty_like(fb)
    _launch(
        "envelope_dual", fa.device, "sdf_envelope_dual",
        fa.data_ptr(), fb.data_ptr(), oa.data_ptr(), ob.data_ptr(), X, Y, Z, axis,
    )
    return oa, ob


# ---- K5: envelope of one field along axis 1 or 2 --------------------------


def envelope_plain(f: torch.Tensor, axis: int) -> torch.Tensor:
    return envelope_pass_brute(f, axis)


def envelope(f: torch.Tensor, axis: int) -> torch.Tensor:
    """Exact envelope ``min_j f[j] + (i-j)^2`` along ``axis`` (1 or 2)."""
    _check(f, "envelope", (torch.int32,))
    if axis not in (1, 2):
        raise ValueError(f"envelope: axis must be 1 or 2, got {axis}")
    if f.shape[axis] > MAX_ENVELOPE_AXIS:
        raise ValueError(f"envelope: axis length {f.shape[axis]} > {MAX_ENVELOPE_AXIS}")
    if f.device.type == "cpu":
        return envelope_plain(f, axis)
    X, Y, Z = f.shape
    out = torch.empty_like(f)
    _launch("envelope", f.device, "sdf_envelope", f.data_ptr(), out.data_ptr(), X, Y, Z, axis)
    return out


# ---- K3: axis-2 dual envelope + signed combine ---------------------------


def envelope_dual_combine_plain(fa: torch.Tensor, fb: torch.Tensor, resolution) -> torch.Tensor:
    a = envelope_pass_brute(fa, 2)
    b = envelope_pass_brute(fb, 2)
    return signed_from_d2(a, b, resolution)


def envelope_dual_combine(fa: torch.Tensor, fb: torch.Tensor, resolution) -> torch.Tensor:
    """f32 signed distances from two axis-1-enveloped d^2 fields: the axis-2
    envelope of both, then ``sqrt(a)*res - sqrt(b)*res`` (INF_D2 -> inf)."""
    _check_pair(fa, fb, "envelope_dual_combine")
    if fa.shape[2] > MAX_ENVELOPE_AXIS:
        raise ValueError(f"envelope_dual_combine: axis length {fa.shape[2]} > {MAX_ENVELOPE_AXIS}")
    if fa.device.type == "cpu":
        return envelope_dual_combine_plain(fa, fb, resolution)
    # the exact f32 value; pass a Python float (GridMeta.resolution_float),
    # since reading a CUDA tensor here would sync the device mid-chain
    res = float(torch.as_tensor(resolution, dtype=torch.float32))
    X, Y, Z = fa.shape
    out = torch.empty(fa.shape, dtype=torch.float32, device=fa.device)
    _launch(
        "envelope_dual_combine", fa.device, "sdf_envelope_dual_combine",
        fa.data_ptr(), fb.data_ptr(), out.data_ptr(), res, X, Y, Z,
    )
    return out


# ---- K6: envelope with winner / carried payloads along axis 1 or 2 --------


def envelope_argmin_plain(f: torch.Tensor, axis: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, win): the exact envelope ``min_j f[j] + (i-j)^2`` along ``axis``
    and the first ``j`` that attains it (the kernel's tie rule), by a
    broadcast min-plus over whole lines, chunked like ``envelope_pass_brute``
    (a ``[lines, n, n]`` temporary of at most 2^27 int32)."""
    n = f.shape[axis]
    fm = f.movedim(axis, -1)
    lines = fm.reshape(-1, n)
    i = torch.arange(n, dtype=torch.int32, device=f.device)
    quad = (i[:, None] - i[None, :]) ** 2  # [n_i, n_j]
    out = torch.empty_like(lines)
    win = torch.empty_like(lines)
    step = max(1, (1 << 27) // (n * n))
    for s in range(0, lines.shape[0], step):
        cand = lines[s : s + step, None, :] + quad
        best = cand.amin(dim=-1)
        out[s : s + step] = best
        win[s : s + step] = torch.where(cand == best[..., None], i, n).amin(dim=-1)

    def back(t):
        return t.reshape(fm.shape).movedim(-1, axis).contiguous()

    return back(out), back(win)


def envelope_carry_plain(f: torch.Tensor, payloads, axis: int) -> Tuple[torch.Tensor, ...]:
    """(out, *carried): the envelope and each payload read at the winner."""
    out, win = envelope_argmin_plain(f, axis)
    idx = win.to(torch.int64)
    return (out, *(torch.gather(p, axis, idx) for p in payloads))


def _check_carry(f: torch.Tensor, payloads, axis: int, name: str) -> None:
    _check(f, name, (torch.int32,))
    if len(payloads) > MAX_PAYLOADS:
        raise ValueError(f"{name}: at most {MAX_PAYLOADS} payloads, got {len(payloads)}")
    for p in payloads:
        _check(p, name, (torch.int32,))
        if p.shape != f.shape or p.device != f.device:
            raise ValueError(f"{name}: payload {tuple(p.shape)}@{p.device} differs from field {tuple(f.shape)}@{f.device}")
    if axis not in (1, 2):
        raise ValueError(f"{name}: axis must be 1 or 2, got {axis}")
    if f.shape[axis] > MAX_ENVELOPE_AXIS:
        raise ValueError(f"{name}: axis length {f.shape[axis]} > {MAX_ENVELOPE_AXIS}")


def _carry_kernel(f: torch.Tensor, payloads, axis: int, want_win: bool):
    """Launch K6: (out, win) when ``want_win``, else (out, *carried)."""
    X, Y, Z = f.shape
    out = torch.empty_like(f)
    win = torch.empty_like(f) if want_win else None
    carried = [torch.empty_like(p) for p in payloads]
    pad = [None] * (MAX_PAYLOADS - len(payloads))
    _launch(
        "envelope_carry", f.device, "sdf_envelope_carry",
        f.data_ptr(), out.data_ptr(), win.data_ptr() if want_win else None, len(payloads),
        *[p.data_ptr() for p in payloads], *pad,
        *[c.data_ptr() for c in carried], *pad,
        X, Y, Z, axis,
    )
    return (out, win) if want_win else (out, *carried)


def envelope_argmin(f: torch.Tensor, axis: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, win): exact envelope along ``axis`` (1 or 2) and its winner
    (first minimiser; a seedless line gives INF_D2 with winner i)."""
    _check_carry(f, (), axis, "envelope_argmin")
    if f.device.type == "cpu":
        return envelope_argmin_plain(f, axis)
    return _carry_kernel(f, (), axis, True)


def envelope_carry(f: torch.Tensor, payloads, axis: int) -> Tuple[torch.Tensor, ...]:
    """(out, *carried): exact envelope along ``axis`` (1 or 2) and up to
    three int32 payloads read at each cell's winner."""
    payloads = tuple(payloads)
    _check_carry(f, payloads, axis, "envelope_carry")
    if f.device.type == "cpu":
        return envelope_carry_plain(f, payloads, axis)
    return _carry_kernel(f, payloads, axis, False)


# ---- K7: winner segment sum along any axis --------------------------------


def winner_segment_sum_plain(g: torch.Tensor, win: torch.Tensor, axis: int) -> torch.Tensor:
    """``out[..j..] = sum_i g[..i..] * [win[..i..] == j]`` along ``axis``,
    each output summed in ascending i from 0.0: the TPU kernel's loop
    ``out = where(iota == win[i], out + g[i], out)``, written as one
    scatter-add per i (within one i every line adds to one row, so each
    element gets one addition). A winner outside [0, n) adds nowhere; an
    axis of length 1 returns g, as the TPU wrapper does."""
    n = g.shape[axis]
    if n == 1:
        return g.clone()
    gm = g.movedim(axis, 0)
    moved = gm.shape
    gm = gm.reshape(n, -1)
    wm = win.movedim(axis, 0).reshape(n, -1).to(torch.int64)
    ok = (wm >= 0) & (wm < n)
    # +0.0 into row 0 changes nothing: a sum from +0.0 is never -0.0
    wm = torch.where(ok, wm, 0)
    gm = torch.where(ok, gm, 0.0)
    out = torch.zeros_like(gm)
    for i in range(n):
        out.scatter_add_(0, wm[i : i + 1], gm[i : i + 1])
    return out.reshape(moved).movedim(0, axis).contiguous()


def winner_segment_sum(g: torch.Tensor, win: torch.Tensor, axis: int) -> torch.Tensor:
    _check(g, "winner_segment_sum", (torch.float32,))
    _check(win, "winner_segment_sum", (torch.int16, torch.int32))
    if g.shape != win.shape or g.device != win.device:
        raise ValueError(
            f"winner_segment_sum: g {tuple(g.shape)}@{g.device} vs win {tuple(win.shape)}@{win.device}"
        )
    if axis not in (0, 1, 2):
        raise ValueError(f"winner_segment_sum: axis must be 0, 1 or 2, got {axis}")
    if g.device.type == "cpu":
        return winner_segment_sum_plain(g, win, axis)
    X, Y, Z = g.shape
    out = torch.empty_like(g)
    _launch(
        "winner_segment_sum", g.device, "sdf_winner_segment_sum",
        g.data_ptr(), win.data_ptr(), win.element_size(), out.data_ptr(), X, Y, Z, axis,
    )
    return out


# ---- K9: convex-hull envelope along axis 1 or 2 (n <= 1024) ----------------


def _check_cht(f: torch.Tensor, axis: int, name: str) -> None:
    _check(f, name, (torch.int32,))
    if axis not in (1, 2):
        raise ValueError(f"{name}: axis must be 1 or 2, got {axis}")
    if f.shape[axis] > CHT_MAX_AXIS:
        raise ValueError(f"{name}: the CHT envelope requires a scan axis <= {CHT_MAX_AXIS}, got {f.shape[axis]}")


def envelope_cht_plain(f: torch.Tensor, axis: int) -> torch.Tensor:
    """The exact envelope along ``axis``, values above ``CHT_CLAMP`` set to
    ``INF_D2``: the JAX CHT kernel's function on its inputs (each <= 2 *
    1024^2 or exactly ``INF_D2``)."""
    _check_cht(f, axis, "envelope_cht_plain")
    out = envelope_pass_brute(f, axis)
    return torch.where(out > CHT_CLAMP, INF_D2, out)


def envelope_cht(f: torch.Tensor, axis: int) -> torch.Tensor:
    """K9: ``envelope_cht_plain``'s function by each line's lower envelope
    (a banded convex hull, ``csrc/edt_cht.cu``), along axis 1 or 2 in the
    volume's own layout. The kernel takes d^2 values (>= 0), as the JAX
    kernel does."""
    _check_cht(f, axis, "envelope_cht")
    if f.device.type == "cpu":
        return envelope_cht_plain(f, axis)
    X, Y, Z = f.shape
    out = torch.empty_like(f)
    _launch("envelope_cht", f.device, "sdf_envelope_cht", f.data_ptr(), out.data_ptr(), X, Y, Z, axis)
    return out
