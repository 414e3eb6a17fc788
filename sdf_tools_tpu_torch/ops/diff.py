"""Gradients of the signed field with respect to occupancy.

Counterpart of ``sdf_tools_tpu/ops/diff.py``. The exact EDT is piecewise
constant in occupancy, so both surrogates keep the exact forward
(``occupancy > 0.5``, the same cells as the serving path) and define the
backward:

  * ``sdf_from_occupancy_st`` (straight-through): d(sdf[i])/d(occ[i]) =
    -2 * resolution on the diagonal.
  * ``sdf_from_occupancy_ft`` (feature transform): each cell's cotangent,
    times -2 * resolution, goes to its nearest opposite-side cell (free
    cells to their nearest filled cell, filled cells to their nearest free
    cell). The forward saves, per field, the winner map of each pass (the
    x-line seed, the y-pass winner, the z-pass winner; int16), and the
    backward routes the cotangent back through z, then y, then the x line
    with three winner segment sums (kernel K7) per field.
  * ``straight_through_sdf`` wraps any occupancy -> sdf forward with the
    straight-through backward.

The FT forward is the JAX package's ``backend="pallas"`` branch: the line
seeds and K6 in its winner form (``edt_cuda.envelope_argmin``) for both
fields, then the signed combine; its values equal the K1-K3 field bit for
bit. Backends: ``"auto"`` runs the kernels for CUDA tensors and their plain
versions for CPU tensors, ``"plain"`` the plain versions anywhere; others
raise ``NotImplementedError``.

Ties: K6 keeps the first minimiser along each line, the TPU kernel another
one, so the routed gradient can differ from the JAX package's where a cell
has several nearest seeds. Its total is the same (every valid cotangent is
routed exactly once), and given the same winner maps the routing is the
same bit for bit (K7 adds in the TPU kernel's order).
"""
from __future__ import annotations

from typing import Callable

import torch

from . import edt, edt_cuda
from .edt import INF_D2, d2_to_distance, line_seed_d2


def _resolution(resolution, device) -> torch.Tensor:
    return torch.as_tensor(resolution, dtype=torch.float32, device=device)


def per_axis_argmin_ft(mask: torch.Tensor, backend: str = "auto"):
    """(d2, x0, jy, kz): exact squared EDT to the True set of ``mask`` and
    the per-pass winner maps (x-line seed, y-pass winner, z-pass winner)."""
    (argmin,) = edt_cuda.for_backend(backend, "envelope_argmin")
    f, x0 = line_seed_d2(mask, 0)
    f, jy = argmin(f, 1)
    f, kz = argmin(f, 2)
    return f, x0, jy, kz


def ft_backward(g, mask, winners, valids, resolution, backend: str = "auto") -> torch.Tensor:
    """d occupancy from the cotangent ``g`` of the FT signed values, given
    the forward's residuals: ``winners`` = ((x0, jy, kz) of the filled
    field, (x0, jy, kz) of the free field), ``valids`` = (d2_filled <
    INF_D2, d2_free < INF_D2)."""
    (segsum,) = edt_cuda.for_backend(backend, "winner_segment_sum")

    def route(contrib, x0, jy, kz):
        # adjoint of the winner composition feat(i) = x0[jy[kz]]: back
        # through z, then y, then the x line
        return segsum(segsum(segsum(contrib, kz, 2), jy, 1), x0, 0)

    valid_f, valid_g = valids
    slope = g * (-2.0 * _resolution(resolution, g.device))
    # free cells' features live in the filled field's transform and vice versa
    c_f = torch.where(~mask & valid_f, slope, 0.0).contiguous()
    c_g = torch.where(mask & valid_g, slope, 0.0).contiguous()
    return route(c_f, *winners[0]) + route(c_g, *winners[1])


class _SdfFromOccupancyFT(torch.autograd.Function):
    @staticmethod
    def forward(ctx, occupancy, resolution, backend):
        mask = (occupancy > 0.5).contiguous()
        res = _resolution(resolution, occupancy.device)
        d2_f, *win_f = per_axis_argmin_ft(mask, backend)
        d2_g, *win_g = per_axis_argmin_ft(~mask, backend)
        values = d2_to_distance(d2_f, res) - d2_to_distance(d2_g, res)
        # winners are axis indices < 2^15: int16 halves the residuals
        win16 = [w.to(torch.int16) for w in (*win_f, *win_g)]
        ctx.save_for_backward(mask, d2_f < INF_D2, d2_g < INF_D2, res, *win16)
        ctx.backend = backend
        return values

    @staticmethod
    def backward(ctx, g):
        mask, valid_f, valid_g, res, *win16 = ctx.saved_tensors
        winners = (tuple(win16[:3]), tuple(win16[3:]))
        d_occ = ft_backward(g.contiguous(), mask, winners, (valid_f, valid_g), res, ctx.backend)
        return d_occ, None, None


class _StraightThrough(torch.autograd.Function):
    @staticmethod
    def forward(ctx, occupancy, forward_fn, resolution):
        ctx.resolution = resolution
        return forward_fn(occupancy)

    @staticmethod
    def backward(ctx, g):
        return g * (-2.0 * _resolution(ctx.resolution, g.device)), None, None


def sdf_from_occupancy_st(occupancy: torch.Tensor, resolution, backend: str = "auto") -> torch.Tensor:
    """Signed distance values of ``occupancy > 0.5`` (the K1-K3 chain);
    straight-through backward, d occ = -2 * resolution * g."""

    def forward_fn(occ):
        values, _, _ = edt.signed_field_from_masks(occ > 0.5, resolution, backend)
        return values

    return _StraightThrough.apply(occupancy, forward_fn, resolution)


def sdf_from_occupancy_ft(occupancy: torch.Tensor, resolution, backend: str = "auto") -> torch.Tensor:
    """Signed distance values of ``occupancy > 0.5``; feature-routed
    backward (module docstring)."""
    return _SdfFromOccupancyFT.apply(occupancy, resolution, backend)


def straight_through_sdf(forward_fn: Callable[[torch.Tensor], torch.Tensor], resolution) -> Callable:
    """Wrap an arbitrary occupancy -> sdf forward with the straight-through
    backward."""

    def f(occupancy: torch.Tensor) -> torch.Tensor:
        return _StraightThrough.apply(occupancy, forward_fn, resolution)

    return f

