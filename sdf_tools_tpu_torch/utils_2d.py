"""Counterpart of the JAX package's ``utils_2d`` (the reference's
``sdf_tools.utils_2d``): 2-D worlds as one-cell-deep grids.

Axis convention kept: the world is ``grid_world[y, x]``, the SDF comes back
as ``sdf[y, x]`` and the gradient as ``grad[y, x, 2]`` (z dropped); the
out-of-bounds value is the reference's -10000.
"""
from __future__ import annotations

import numpy as np
import torch

from .grid import CollisionMap, GridMeta, SdfGrid, make_origin_transform, require_device
from .ops import edt, query


def compute_sdf_and_gradient(grid_world, sdf_resolution, sdf_origin, frame="world", *, device="cuda"):
    """(sdf [y, x] float32, gradient [y, x, 2] float32) numpy arrays for a
    binary 2-D world (utils_2d.py:6-58): the grid is x-major (nx = width)
    with one z cell, filled where the world is 1; edge gradients on. Runs on
    ``device``."""
    device = require_device(device)
    grid_world = np.asarray(grid_world)
    y_height, x_width = grid_world.shape
    filled = torch.as_tensor(grid_world.T == 1, device=device)[:, :, None]  # [x, y, 1]
    origin = make_origin_transform([sdf_origin[0], sdf_origin[1], 0.0], device=device)
    meta = GridMeta.create(origin, sdf_resolution, (x_width, y_height, 1), frame, device=device)
    sdf, _ = edt.extract_signed_distance_field(filled, meta, oob_value=-10000.0)
    grad = query.full_gradient(sdf, enable_edge_gradients=True)
    np_sdf = sdf.values[:, :, 0].T.cpu().numpy()
    np_grad = grad[:, :, 0, 0:2].transpose(0, 1).cpu().numpy()
    return np_sdf, np_grad


def compute_gradient(sdf: SdfGrid):
    """Gradient of an existing 2-D SdfGrid: (sdf [x, y], grad [x, y, 2])."""
    return to_np(sdf, query.full_gradient(sdf, enable_edge_gradients=True))


def sdf_to_np(sdf: SdfGrid) -> np.ndarray:
    return sdf.values[:, :, 0].cpu().numpy()


def gradient_to_np(gradient) -> np.ndarray:
    """Dense 2-D gradient -> numpy [x, y, 2] (z dropped; utils_2d.py:83-87);
    takes ``full_gradient``'s [nx, ny, 1, 3] or an [nx, ny, 3] field."""
    g = gradient.detach().cpu().numpy() if isinstance(gradient, torch.Tensor) else np.asarray(gradient)
    if g.ndim == 4:
        g = g[:, :, 0, :]
    return g[:, :, 0:2]


def to_np(sdf: SdfGrid, gradient):
    """(sdf_to_np(sdf), gradient_to_np(gradient)) (utils_2d.py:79-80)."""
    return sdf_to_np(sdf), gradient_to_np(gradient)


def grid_to_np(cmap: CollisionMap) -> np.ndarray:
    return cmap.occupancy[:, :, 0].cpu().numpy()
