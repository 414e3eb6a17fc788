"""Wrappers of the three hand-written CUDA kernels of the signed field, each
beside its plain PyTorch version.

  K1 ``line_pass_dual``        csrc/edt_line_pass.cu  (TPU: edt_pallas._line_pass_dual_kernel)
  K2 ``envelope_dual``         csrc/edt_envelope.cu   (TPU: edt_pallas._envelope_dual_kernel)
  K3 ``envelope_dual_combine`` csrc/edt_envelope.cu   (TPU: edt_pallas._envelope_dual_combine_kernel)

A wrapper checks its inputs, then runs the plain version for a CPU tensor
and launches its kernel on the current stream for a CUDA tensor, raising if
the launch fails. ``LAUNCHES[name]`` counts kernel launches only, so a run
can show that its main path went through the kernels. All arrays are
contiguous ``[X, Y, Z]`` (z fastest); any axis may have length 1.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .. import _build
from .edt import MAX_ENVELOPE_AXIS, d2_to_distance, envelope_pass_brute, line_d2

LAUNCHES = {"line_pass_dual": 0, "envelope_dual": 0, "envelope_dual_combine": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


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


def _launch(name: str, device: torch.device, fn, *args) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(_build.library(), fn)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed with cudaError_t {rc}")
    LAUNCHES[name] += 1


# ---- K1: dual line pass along axis 0 -------------------------------------


def line_pass_dual_plain(mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(d2 to the True set, d2 to the False set) along axis 0, ``INF_D2``
    where a column has no such seed."""
    m = mask.to(torch.bool)
    return line_d2(m, 0), line_d2(~m, 0)


def line_pass_dual(mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    _check(mask, "line_pass_dual", (torch.bool, torch.uint8))
    if mask.device.type == "cpu":
        return line_pass_dual_plain(mask)
    X, Y, Z = mask.shape
    a = torch.empty(mask.shape, dtype=torch.int32, device=mask.device)
    b = torch.empty_like(a)
    _launch(
        "line_pass_dual", mask.device, "sdf_line_pass_dual",
        mask.data_ptr(), a.data_ptr(), b.data_ptr(), X, Y, Z,
    )
    return a, b


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


# ---- K3: axis-2 dual envelope + signed combine ---------------------------


def envelope_dual_combine_plain(fa: torch.Tensor, fb: torch.Tensor, resolution) -> torch.Tensor:
    a = envelope_pass_brute(fa, 2)
    b = envelope_pass_brute(fb, 2)
    return d2_to_distance(a, resolution) - d2_to_distance(b, resolution)


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
