"""Carry grid state across from the JAX package.

The JAX package's ``GridMeta`` / ``SdfGrid`` fields are taken as numpy
arrays (``np.asarray(meta.origin_transform)`` and so on), so this module
needs no JAX. The inverse transform is carried as it is, not recomputed,
so both packages use identical frame matrices; the resolution stays a 0-d
float32 tensor, because the march does its scalar math in f32 and a Python
double would round differently. Collision maps' uint32 label fields become
int64 tensors of the same values (``grid.py``).
"""
from __future__ import annotations

import numpy as np
import torch

from .grid import CollisionMap, GridMeta, SdfGrid, TaggedCollisionMap, label_field


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


def collision_map_from_numpy(
    occupancy, component, meta: GridMeta, oob_occupancy, components_valid: bool = False
) -> CollisionMap:
    """A ``CollisionMap`` from the JAX map's fields as numpy arrays."""
    occ = torch.as_tensor(np.array(occupancy, np.float32), device=meta.device)
    return CollisionMap(
        occupancy=occ,
        component=label_field(component, occ.shape, meta.device),
        meta=meta,
        oob_occupancy=torch.as_tensor(np.array(oob_occupancy, np.float32), device=meta.device),
        components_valid=bool(components_valid),
    )


def tagged_collision_map_from_numpy(
    occupancy, component, object_id, convex_segment, meta: GridMeta, oob_occupancy,
    components_valid: bool = False, convex_segments_valid: bool = False,
) -> TaggedCollisionMap:
    """A ``TaggedCollisionMap`` from the JAX map's fields as numpy arrays."""
    occ = torch.as_tensor(np.array(occupancy, np.float32), device=meta.device)
    return TaggedCollisionMap(
        occupancy=occ,
        component=label_field(component, occ.shape, meta.device),
        object_id=label_field(object_id, occ.shape, meta.device),
        convex_segment=label_field(convex_segment, occ.shape, meta.device),
        meta=meta,
        oob_occupancy=torch.as_tensor(np.array(oob_occupancy, np.float32), device=meta.device),
        components_valid=bool(components_valid),
        convex_segments_valid=bool(convex_segments_valid),
    )
