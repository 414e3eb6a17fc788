"""Exact Euclidean distance transform and signed-field extraction.

Counterpart of ``sdf_tools_tpu/ops/edt.py``, same value semantics:

  * Axis 0 (binary seeds): per-line distance to the nearest seed.
  * Axes 1 and 2: the exact parabolic envelope
    ``out[i] = min_j f[j] + (i-j)^2`` over the already squared field.
  * Distances are exact int32 squared cell distances; ``INF_D2`` marks
    "no seed anywhere" and comes out exactly ``INF_D2``.
  * Signed combine: ``sqrt(d2_filled)*res - sqrt(d2_free)*res``, positive in
    free space, at most ``-res`` inside filled space.

Backends of the two-field chain (line pass -> axis-1 envelope -> axis-2
envelope with the combine as epilogue):

  * ``"auto"``: the CUDA kernels of ``edt_cuda`` for CUDA tensors, their
    plain PyTorch versions for CPU tensors.
  * ``"plain"``: the plain PyTorch versions on any device.

The JAX package's other envelope backends (``stencil``, ``scan``, ``cht``,
``reference``, ...) are not ported yet and raise ``NotImplementedError``.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from ..grid import GridMeta, SdfGrid

# No seed reachable. INF_D2 + (n-1)^2 < 2^31 for any axis n <= 16384, so the
# envelope's int32 sums never overflow.
INF_D2 = 1 << 29
MAX_ENVELOPE_AXIS = 16384
_LINE_SENTINEL = 1 << 24


def line_seed_d2(mask: torch.Tensor, axis: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(d2, seed): the squared distance (int32) along ``axis`` to the nearest
    True in ``mask``, exactly ``INF_D2`` where a line has no seed, and that
    seed's index along the axis (the earlier seed when two are as near, 0
    in a line without a seed; the JAX package's ``feature._line_seed_x``).
    Two cummax scans over seed positions."""
    mask = mask.to(torch.bool)
    n = mask.shape[axis]
    shape = [1] * mask.ndim
    shape[axis] = n
    iota = torch.arange(n, dtype=torch.int32, device=mask.device).reshape(shape)
    neg = -(1 << 30)
    # forward: index of the most recent seed at or before i
    last_seed = torch.cummax(torch.where(mask, iota, neg), dim=axis).values
    fwd = iota - last_seed
    # backward: index of the next seed at or after i
    rev = torch.where(mask, -iota, neg).flip(axis)
    next_seed = -torch.cummax(rev, dim=axis).values.flip(axis)
    bwd = next_seed - iota
    d = torch.minimum(fwd, bwd)
    no_seed = d >= _LINE_SENTINEL
    seed = torch.where(no_seed, 0, torch.where(fwd <= bwd, last_seed, next_seed))
    return torch.where(no_seed, INF_D2, d * d), seed


def line_d2(mask: torch.Tensor, axis: int) -> torch.Tensor:
    """Squared line distance, exactly ``INF_D2`` where a line has no seed."""
    return line_seed_d2(mask, axis)[0]


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


def d2_to_distance(d2: torch.Tensor, resolution) -> torch.Tensor:
    """f32 sqrt(d^2) * resolution with the INF sentinel mapped to +inf.

    The square root must be correctly rounded, as in XLA and in the CUDA
    kernel (``__fsqrt_rn``). PyTorch's vectorised float32 sqrt on the CPU is
    not (69 of the 12288 values d^2 < 3*64^2 come out one ulp off), so it is
    taken in float64 and rounded once to float32: for every float32 input
    that equals the correctly rounded float32 square root."""
    res = torch.as_tensor(resolution, dtype=torch.float32, device=d2.device)
    v = torch.where(d2 >= INF_D2, math.inf, d2.to(torch.float32))
    return torch.sqrt(v.to(torch.float64)).to(torch.float32) * res


def _chain(backend: str):
    """(line_pass_dual, envelope_dual, envelope_dual_combine) for a backend."""
    from . import edt_cuda

    return edt_cuda.for_backend(backend, "line_pass_dual", "envelope_dual", "envelope_dual_combine")


def _as_mask3(filled_mask: torch.Tensor) -> torch.Tensor:
    mask = filled_mask.to(torch.bool)
    if mask.ndim != 3:
        raise ValueError(f"expected a 3D mask, got shape {tuple(mask.shape)}")
    return mask.contiguous()


def squared_edt_both(filled_mask: torch.Tensor, backend: str = "auto") -> Tuple[torch.Tensor, torch.Tensor]:
    """(d2_filled, d2_free): exact squared EDTs to the True set and to the
    False set of ``filled_mask``, both fields through one chain of launches."""
    line_pass, envelope, _ = _chain(backend)
    fa, fb = line_pass(_as_mask3(filled_mask))
    fa, fb = envelope(fa, fb, 1)
    return envelope(fa, fb, 2)


def signed_field_from_masks(
    filled_mask: torch.Tensor, resolution, backend: str = "auto"
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Two-field signed distance values (reference sdf_generation.hpp:242-268).

    Returns (sdf_values f32, max_distance, min_distance): positive in free
    space, at most ``-resolution`` inside filled space."""
    line_pass, envelope, combine = _chain(backend)
    fa, fb = line_pass(_as_mask3(filled_mask))
    fa, fb = envelope(fa, fb, 1)
    dist = combine(fa, fb, resolution)
    return dist, dist.max(), dist.min()


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
    filled_mask: torch.Tensor, resolution, backend: str = "auto"
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Virtual-border signed field (reference sdf_generation.hpp:273-420):
    one cell of border per side (per axis with >1 cells), a "free" field
    with the border pretended filled and a "filled" field with it pretended
    empty; free value if >= 0, else filled value if <= -0, else 0. Extrema
    are (free max, filled min) over the enlarged grids."""
    free_variant, filled_variant, inner = _virtual_border_masks(_as_mask3(filled_mask))
    free_sdf, free_max, _ = signed_field_from_masks(free_variant, resolution, backend)
    filled_sdf, _, filled_min = signed_field_from_masks(filled_variant, resolution, backend)
    fs = free_sdf[inner]
    bs = filled_sdf[inner]
    combined = torch.where(fs >= 0.0, fs, torch.where(bs <= -0.0, bs, torch.zeros_like(fs)))
    return combined.contiguous(), free_max, filled_min


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
    field = signed_field_virtual_border if add_virtual_border else signed_field_from_masks
    values, mx, mn = field(filled_mask, meta.resolution_float, backend)
    return SdfGrid.create(values, meta, oob_value), (mx, mn)
