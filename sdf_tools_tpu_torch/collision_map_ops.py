"""Collision-map operations (counterpart of
``sdf_tools_tpu/collision_map_ops.py``).

The reference's ``CollisionMapGrid`` and ``TaggedObjectCollisionMapGrid``
member functions as functions that return new maps: SDF extraction
(collision_map.hpp:680-712, tagged_object_collision_map.hpp:730-915; a
filled mask from occupancy and object ids, then the two-field signed field
of ``ops/edt.py``, K1 -> K2 -> K3 on the card under ``"auto"``), connected
components, component surfaces, the holes/voids census, the resample and
the convex segments (``ops/topology.py``). Everything runs where the map's
tensors live; the ``*_map`` views and ``extract_connected_components``
are host utilities that return numpy index lists.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .grid import CollisionMap, SdfGrid, TaggedCollisionMap
from .ops import edt, topology


def extract_sdf(
    cmap: CollisionMap,
    oob_value=math.inf,
    unknown_is_filled: bool = False,
    add_virtual_border: bool = False,
    backend: str = "auto",
) -> Tuple[SdfGrid, Tuple[torch.Tensor, torch.Tensor]]:
    """``CollisionMapGrid::ExtractSignedDistanceField``: filled = occupancy
    > 0.5 (>= 0.5 when unknown cells count as filled). Returns (sdf,
    (max_distance, min_distance))."""
    mask = cmap.filled_mask(unknown_is_filled)
    return edt.extract_signed_distance_field(mask, cmap.meta, oob_value, add_virtual_border, backend)


def update_connected_components(cmap: CollisionMap, **kw):
    """Components by 6-connectivity over the same binary occupancy (every
    cell labelled): (map, n_components); keyword arguments as
    ``topology.connected_components_from_adjacency``."""
    return topology.update_connected_components(cmap, **kw)


def _typed_component_surface(occupancy: torch.Tensor, component: torch.Tensor, component_types: str) -> torch.Tensor:
    """Component-surface mask restricted to the requested occupancy type."""
    if component_types == "filled":
        sel = occupancy > 0.5
    elif component_types == "empty":
        sel = occupancy < 0.5
    elif component_types == "unknown":
        sel = occupancy == 0.5
    elif component_types == "all":
        sel = torch.ones_like(occupancy, dtype=torch.bool)
    else:
        raise ValueError(component_types)
    return topology.component_surface_mask(component) & sel


def extract_component_surfaces(cmap: CollisionMap, component_types: str = "filled") -> torch.Tensor:
    """Surface mask of the components of the requested occupancy type
    (``collision_map.cpp:697-754``), component_types in {"filled",
    "empty", "unknown", "all"}; with ``cmap.component`` it gives each
    component's surface."""
    return _typed_component_surface(cmap.occupancy, cmap.component, component_types)


def _index_lists(component: torch.Tensor, mask: Optional[torch.Tensor]) -> Dict[int, np.ndarray]:
    """{label: [k, 3] int64 indices of the cells (within ``mask``) holding
    it, in C order}: what ``np.argwhere(mask & (component == c))`` gives
    for each label, from one stable sort on the host."""
    comp = component.cpu().numpy().reshape(-1)
    cells = np.arange(comp.size) if mask is None else np.flatnonzero(mask.cpu().numpy())
    labels = comp[cells]
    order = np.argsort(labels, kind="stable")
    uniq, starts = np.unique(labels[order], return_index=True)
    groups = np.split(cells[order], starts[1:])
    return {int(c): np.stack(np.unravel_index(g, component.shape), axis=-1) for c, g in zip(uniq, groups)}


def extract_component_surfaces_map(cmap: CollisionMap, component_types: str = "filled") -> Dict[int, np.ndarray]:
    """Host view of ``extract_component_surfaces``: {component id: [k, 3]
    surface voxel indices} (the reference returns map<component, surface
    index map>)."""
    return _index_lists(cmap.component, extract_component_surfaces(cmap, component_types))


def extract_connected_components(cmap: CollisionMap) -> Dict[int, np.ndarray]:
    """Per-component voxel index lists (``collision_map.cpp:756-778``):
    {component id: [k, 3]}; label 0 (unlabelled) is left out unless every
    cell is 0. A host utility: ``cmap.component`` is the dense form."""
    out = _index_lists(cmap.component, None)
    if len(out) > 1:
        out.pop(0, None)
    return out


def compute_component_topology(cmap: CollisionMap, recompute: bool = True) -> np.ndarray:
    """(holes, voids) per component, int32 [n, 2] on the host
    (``collision_map.cpp:620-671``); the components are recomputed unless
    ``recompute`` is False and they are valid."""
    if recompute or not cmap.components_valid:
        cmap, n = topology.update_connected_components(cmap)
    else:
        n = cmap.component.max()
    return topology.compute_component_topology(cmap.component, int(n))


def resample(cmap: CollisionMap, new_resolution) -> CollisionMap:
    """Nearest-location resample (``collision_map.cpp:673-695``)."""
    occ, new_meta = topology.resample_nearest(cmap.occupancy, cmap.meta, new_resolution)
    comp, _ = topology.resample_nearest(cmap.component, cmap.meta, new_resolution)
    return CollisionMap.create(occ, new_meta, oob_occupancy=cmap.oob_occupancy, component=comp)


def tagged_filled_mask(
    tmap: TaggedCollisionMap, objects_to_use: Sequence[int] = (), unknown_is_filled: bool = False
) -> torch.Tensor:
    """Filled cells, restricted to the ids in ``objects_to_use`` when it is
    not empty (tagged_object_collision_map.hpp:813-856)."""
    filled = tmap.filled_mask(unknown_is_filled)
    if len(objects_to_use) == 0:
        return filled
    sel = torch.zeros(tmap.shape, dtype=torch.bool, device=filled.device)
    for oid in objects_to_use:
        sel |= tmap.object_id == int(oid)
    return filled & sel


def extract_tagged_sdf(
    tmap: TaggedCollisionMap,
    oob_value=math.inf,
    objects_to_use: Sequence[int] = (),
    unknown_is_filled: bool = False,
    add_virtual_border: bool = False,
    backend: str = "auto",
) -> Tuple[SdfGrid, Tuple[torch.Tensor, torch.Tensor]]:
    mask = tagged_filled_mask(tmap, objects_to_use, unknown_is_filled)
    return edt.extract_signed_distance_field(mask, tmap.meta, oob_value, add_virtual_border, backend)


def extract_free_and_named_objects_sdf(
    tmap: TaggedCollisionMap, oob_value=math.inf, unknown_is_filled: bool = True, backend: str = "auto"
) -> Tuple[SdfGrid, Tuple[torch.Tensor, torch.Tensor]]:
    """``ExtractFreeAndNamedObjectsSignedDistanceField``
    (tagged_object_collision_map.hpp:730-811): the free-space field over
    every obstacle where it is >= 0, else the field of the named objects
    (id > 0) where that is <= -0, else 0. Extrema: (free max, named min)."""
    free_mask = tmap.filled_mask(unknown_is_filled)
    named_mask = free_mask & (tmap.object_id > 0)
    res = tmap.meta.resolution_float
    free_vals, free_max, _ = edt.signed_field_from_masks(free_mask, res, backend)
    named_vals, _, named_min = edt.signed_field_from_masks(named_mask, res, backend)
    combined = torch.where(
        free_vals >= 0.0, free_vals, torch.where(named_vals <= -0.0, named_vals, torch.zeros_like(free_vals))
    )
    return SdfGrid.create(combined, tmap.meta, oob_value), (free_max, named_min)


def make_object_sdfs(
    tmap: TaggedCollisionMap,
    object_ids: Optional[Sequence[int]] = None,
    unknown_is_filled: bool = False,
    add_virtual_border: bool = False,
    backend: str = "auto",
) -> Dict[int, SdfGrid]:
    """One SDF per object (``MakeObjectSDFs`` / ``MakeAllObjectSDFs``,
    tagged_object_collision_map.hpp:875-915); ``object_ids=None`` takes
    every id present but 0 (one host copy of the distinct ids)."""
    if object_ids is None:
        object_ids = [i for i in torch.unique(tmap.object_id).tolist() if i > 0]
    out = {}
    for oid in object_ids:
        sdf, _ = extract_tagged_sdf(
            tmap, math.inf, objects_to_use=[oid], unknown_is_filled=unknown_is_filled,
            add_virtual_border=add_virtual_border, backend=backend,
        )
        out[int(oid)] = sdf
    return out


def resample_tagged(tmap: TaggedCollisionMap, new_resolution) -> TaggedCollisionMap:
    """Nearest-location resample of all four cell fields (occupancy,
    component, object_id, convex_segment), as
    ``TaggedObjectCollisionMapGrid::Resample``
    (tagged_object_collision_map.hpp:671): the new grid keeps the origin
    transform, and each new cell copies the old cell holding its center."""
    occ, new_meta = topology.resample_nearest(tmap.occupancy, tmap.meta, new_resolution)
    comp, obj, seg = (
        topology.resample_nearest(f, tmap.meta, new_resolution)[0]
        for f in (tmap.component, tmap.object_id, tmap.convex_segment)
    )
    return TaggedCollisionMap(
        occupancy=occ, component=comp, object_id=obj, convex_segment=seg, meta=new_meta,
        oob_occupancy=tmap.oob_occupancy,
    )


def extract_tagged_component_surfaces(tmap: TaggedCollisionMap, component_types: str = "filled") -> torch.Tensor:
    """The tagged grid's ``ExtractComponentSurfaces``
    (tagged_object_collision_map.hpp:704-722): as for the collision map,
    over the tagged grid's occupancy and components."""
    return _typed_component_surface(tmap.occupancy, tmap.component, component_types)


def extract_tagged_component_surfaces_map(
    tmap: TaggedCollisionMap, component_types: str = "filled"
) -> Dict[int, np.ndarray]:
    """Host view {component id: [k, 3] surface voxel indices} of
    ``extract_tagged_component_surfaces``."""
    return _index_lists(tmap.component, extract_tagged_component_surfaces(tmap, component_types))


def update_tagged_connected_components(tmap: TaggedCollisionMap, **kw):
    """6-connectivity over the same binary occupancy, as for the collision
    map: (map, n_components)."""
    return topology.update_connected_components(tmap, **kw)


def update_convex_segments(
    tmap: TaggedCollisionMap, connected_threshold, add_virtual_border: bool = False, backend: str = "auto", **kw
):
    """``UpdateConvexSegments`` (tagged_object_collision_map.cpp:552-654):
    the virtual-border or free+named SDF (K1 -> K2 -> K3 once or twice on
    the card), its local extrema map, then components of same-object cells
    whose extrema lie within ``connected_threshold``: (map, count)."""
    if add_virtual_border:
        sdf, _ = extract_tagged_sdf(
            tmap, math.inf, objects_to_use=(), unknown_is_filled=True, add_virtual_border=True, backend=backend
        )
    else:
        sdf, _ = extract_free_and_named_objects_sdf(tmap, math.inf, unknown_is_filled=True, backend=backend)
    seg, *rest = topology.convex_segments(tmap, sdf, connected_threshold, **kw)
    return (dataclasses.replace(tmap, convex_segment=seg, convex_segments_valid=True), *rest)
