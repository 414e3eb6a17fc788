"""Carry grid state across from the JAX package.

The JAX package's ``GridMeta`` / ``SdfGrid`` fields are taken as numpy
arrays (``np.asarray(meta.origin_transform)`` and so on), so this module
needs no JAX. The inverse transform is carried as it is, not recomputed,
so both packages use identical frame matrices; the resolution stays a 0-d
float32 tensor, because the march does its scalar math in f32 and a Python
double would round differently.
"""
from __future__ import annotations

import numpy as np
import torch

from .grid import GridMeta, SdfGrid


def grid_meta_from_numpy(
    origin_transform, inv_origin_transform, resolution, shape, frame: str = "world", *, device
) -> GridMeta:
    def f32(x):
        return torch.as_tensor(np.array(x, np.float32), device=device)  # own, writable copy

    res = np.float32(np.asarray(resolution).reshape(()))
    return GridMeta(
        origin_transform=f32(origin_transform),
        inv_origin_transform=f32(inv_origin_transform),
        resolution=f32(res).reshape(()),
        resolution_float=float(res),
        shape=tuple(int(s) for s in shape),
        frame=frame,
    )


def sdf_grid_from_numpy(values, meta: GridMeta, oob_value) -> SdfGrid:
    return SdfGrid.create(
        np.array(values, np.float32), meta, np.array(oob_value, np.float32)
    )
