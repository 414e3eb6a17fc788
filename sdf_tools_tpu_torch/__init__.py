"""sdf_tools_tpu_torch: the PyTorch/CUDA port of sdf_tools_tpu for NVIDIA Hopper.

The serving path of the JAX package (``sdf_tools_tpu``, the reference):
occupancy or points -> exact two-field signed distance field (hand-written
CUDA kernels, ``csrc/``) -> trilinear queries -> sphere-traced depth (the
plane-sweep kernel on the card, the exact march elsewhere); and
its training path: the depth's implicit-function backward to the field,
and the straight-through or feature-routed backward from the field to
occupancy (winner envelope and winner segment-sum kernels). Beside them
the single-field EDT (``squared_edt``: line pass and envelope kernels, the
convex-hull envelope for ``backend="cht"``, the JAX package's other
backends in plain torch) and its routes for volumes near or beyond device
memory (``signed_field_lowmem``, ``squared_edt_slabbed``,
``signed_field_slabbed``). The query surface of a planner (grid and
world-frame gradients, the dense gradient field, the smoothed gradient,
the boundary distance, the projections into the volume and out of
collision), the collision-map types and their SDF extraction
(``collision_map_ops``), and the 2-D and 3-D front ends (``utils_2d``,
``utils_3d``, ``image_sdf``, image and mesh voxelization), whose fields
run through the same EDT kernels. The map topology (``ops/topology.py``:
connected components, surface and corner masks, the holes/voids census,
the watershed extrema map, convex segments, the nearest-location resample;
their map-level forms in ``collision_map_ops``) and ``io`` (the
reference's SDFZ/CMGZ/TCMZ files, message blobs and ROS frames, and
``.npz`` checkpoints, byte for byte as the JAX package writes them).
Plain PyTorch elsewhere; imports no JAX.
"""

from .convert import (
    collision_map_from_numpy,
    grid_meta_from_numpy,
    sdf_grid_from_numpy,
    tagged_collision_map_from_numpy,
)
from .ops.diff import sdf_from_occupancy_ft, sdf_from_occupancy_st, straight_through_sdf
from .engine import SdfEngine
from .grid import (
    CollisionMap,
    GridMeta,
    SdfGrid,
    TaggedCollisionMap,
    invert_isometry,
    make_origin_transform,
    rotate_points,
)
from .ops.edt import (
    extract_signed_distance_field,
    signed_field_from_masks,
    signed_field_lowmem,
    signed_field_slabbed,
    signed_field_virtual_border,
    squared_edt,
    squared_edt_both,
    squared_edt_slabbed,
)
from .ops.feature import feature_transform
from .ops.query import (
    autodiff_gradient,
    distance_to_boundary,
    estimate_distance,
    full_gradient,
    gradient,
    grid_aligned_gradient,
    interpolation_stencil,
    project_into_valid_volume,
    project_out_of_collision,
    smooth_gradient,
)
from .ops.render import RenderResult, camera_rays, render_depth
from .ops.voxelize import image_to_occupancy, soft_voxelize_points, voxelize_points
from .ops.image_sdf import false_color_preview, image_sdf
from .ops.topology import (
    candidate_corner_mask,
    component_holes_and_voids,
    component_surface_mask,
    compute_component_topology,
    connected_components_by_key,
    convex_segments,
    local_extrema_map,
    resample_nearest,
    surface_mask_26,
)
from . import collision_map_ops, io

__version__ = "0.1.0"

__all__ = [
    "CollisionMap",
    "GridMeta",
    "SdfGrid",
    "TaggedCollisionMap",
    "SdfEngine",
    "make_origin_transform",
    "rotate_points",
    "invert_isometry",
    "grid_meta_from_numpy",
    "sdf_grid_from_numpy",
    "collision_map_from_numpy",
    "tagged_collision_map_from_numpy",
    "extract_signed_distance_field",
    "signed_field_from_masks",
    "signed_field_virtual_border",
    "squared_edt",
    "squared_edt_both",
    "signed_field_lowmem",
    "squared_edt_slabbed",
    "signed_field_slabbed",
    "estimate_distance",
    "interpolation_stencil",
    "gradient",
    "grid_aligned_gradient",
    "full_gradient",
    "smooth_gradient",
    "autodiff_gradient",
    "distance_to_boundary",
    "project_out_of_collision",
    "project_into_valid_volume",
    "render_depth",
    "camera_rays",
    "RenderResult",
    "voxelize_points",
    "soft_voxelize_points",
    "image_to_occupancy",
    "image_sdf",
    "false_color_preview",
    "candidate_corner_mask",
    "component_holes_and_voids",
    "component_surface_mask",
    "compute_component_topology",
    "connected_components_by_key",
    "convex_segments",
    "local_extrema_map",
    "resample_nearest",
    "surface_mask_26",
    "collision_map_ops",
    "io",
    "sdf_from_occupancy_st",
    "sdf_from_occupancy_ft",
    "straight_through_sdf",
    "feature_transform",
]
