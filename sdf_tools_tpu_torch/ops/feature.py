"""Feature transform: the exact squared EDT with a nearest seed per cell.

Counterpart of ``sdf_tools_tpu/ops/feature.py``. The x line pass records
the winning seed x from two prefix scans (``edt.line_seed_d2``); the y and z
envelope passes are kernel K6 (``edt_cuda.envelope_carry``), which carries
the earlier passes' winners from each cell's winner, so the feature triple
arrives with the distance and needs no gathers afterwards (the JAX
package's ``backend="pallas"`` branch, taken here on every device).

Ties: K6 keeps the first minimiser along each line; the TPU kernel keeps
whichever tied source reached the cell first. Any nearest seed is a
correct feature, so features are compared as witnesses
(``|cell - feat|^2 == d2``), never as indices.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import edt_cuda
from .edt import line_seed_d2


def _iota(shape, axis: int, device) -> torch.Tensor:
    view = [1, 1, 1]
    view[axis] = shape[axis]
    i = torch.arange(shape[axis], dtype=torch.int32, device=device).reshape(view)
    return i.expand(shape).contiguous()


def feature_transform(seed_mask: torch.Tensor, backend: str = "auto") -> Tuple[torch.Tensor, torch.Tensor]:
    """(d2, feat): exact squared EDT to the True set of ``seed_mask`` and a
    nearest seed ``feat[x, y, z] = (x*, y*, z*)`` (int32 [..., 3]). Cells of
    a seedless volume get d2 = INF_D2 and feature (0, y, z), as in the JAX
    package's pallas branch (a seedless line's winner is the cell itself).

    ``backend``: ``"auto"`` runs K6 for CUDA tensors and its plain version
    for CPU tensors; ``"plain"`` runs the plain version anywhere."""
    (carry,) = edt_cuda.for_backend(backend, "envelope_carry")
    mask = seed_mask.to(torch.bool)
    if mask.ndim != 3:
        raise ValueError(f"expected a 3D mask, got shape {tuple(mask.shape)}")
    mask = mask.contiguous()
    f, x0 = line_seed_d2(mask, 0)
    f, jy, x = carry(f, (_iota(mask.shape, 1, mask.device), x0), 1)
    f, kz, jy_star, x_star = carry(f, (_iota(mask.shape, 2, mask.device), jy, x), 2)
    return f, torch.stack([x_star, jy_star, kz], dim=-1)
