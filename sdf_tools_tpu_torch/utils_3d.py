"""Counterpart of the JAX package's ``utils_3d`` (the reference's
``sdf_tools.utils_3d``).

Axis quirk kept: the environment is ``env[y, x, z]`` ("Yes, it goes y,x,z",
utils_3d.py:22) and the outputs transpose back the same way; the
out-of-bounds value is the reference's -10000.
"""
from __future__ import annotations

import numpy as np
import torch

from .grid import GridMeta, SdfGrid, make_origin_transform, require_device
from .ops import edt, query


def _meta_from(env_shape, res, origin_point, device, frame="world") -> GridMeta:
    y_shape, x_shape, z_shape = env_shape
    origin = make_origin_transform([origin_point[0], origin_point[1], origin_point[2]], device=device)
    return GridMeta.create(origin, res, (x_shape, y_shape, z_shape), frame, device=device)


def _filled_xyz(env, device) -> torch.Tensor:
    """env[y, x, z] of 0/1 -> the filled mask [x, y, z] on ``device``."""
    return torch.as_tensor(np.asarray(env).transpose(1, 0, 2) == 1, device=device)


def compute_sdf(env, res, origin_point, *, device="cuda") -> SdfGrid:
    """env[y, x, z] of 0/1 -> SdfGrid on ``device`` (utils_3d.py:5-36)."""
    device = require_device(device)
    meta = _meta_from(np.shape(env), res, origin_point, device)
    sdf, _ = edt.extract_signed_distance_field(_filled_xyz(env, device), meta, oob_value=-10000.0)
    return sdf


def compute_sdf_and_gradient(env, res, origin_point, *, device="cuda"):
    """(sdf [y, x, z] float32, gradient [y, x, z, 3] float32) numpy arrays
    (utils_3d.py:39-97)."""
    sdf = compute_sdf(env, res, origin_point, device=device)
    grad = query.full_gradient(sdf, enable_edge_gradients=True)
    return sdf.values.permute(1, 0, 2).cpu().numpy(), grad.permute(1, 0, 2, 3).cpu().numpy()


def get_gradient(sdf: SdfGrid, dtype=np.float64) -> np.ndarray:
    """Dense gradient [nx, ny, nz, 3] as numpy (utils_3d.py:100-108)."""
    return np.asarray(query.full_gradient(sdf, enable_edge_gradients=True).cpu().numpy(), dtype=dtype)


def compute_sdf_and_gradient_batched(envs, res, origin_point, backend="auto", *, device="cuda"):
    """envs [b, y, x, z] of 0/1 -> (sdf [b, y, x, z], gradient
    [b, y, x, z, 3]) f32 tensors on ``device``: each environment's signed
    field and dense gradient in turn (the kernels run one volume a launch),
    stacked."""
    device = require_device(device)
    envs = np.asarray(envs)
    meta = _meta_from(envs.shape[1:], res, origin_point, device)
    sdfs, grads = [], []
    for env in envs:
        vals, _, _ = edt.signed_field_from_masks(_filled_xyz(env, device), meta.resolution_float, backend)
        grad = query.full_gradient(SdfGrid.create(vals, meta, oob_value=-10000.0), enable_edge_gradients=True)
        sdfs.append(vals.permute(1, 0, 2))
        grads.append(grad.permute(1, 0, 2, 3))
    return torch.stack(sdfs), torch.stack(grads)
