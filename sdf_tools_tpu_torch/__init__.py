"""sdf_tools_tpu_torch: the PyTorch/CUDA port of sdf_tools_tpu for NVIDIA Hopper.

The serving path of the JAX package (``sdf_tools_tpu``, the reference):
occupancy or points -> exact two-field signed distance field (hand-written
CUDA kernels, ``csrc/``) -> trilinear queries -> sphere-traced depth (the
plane-sweep kernel on the card, the exact march elsewhere); and
its training path: the depth's implicit-function backward to the field,
and the straight-through or feature-routed backward from the field to
occupancy (winner envelope and winner segment-sum kernels). Plain PyTorch
elsewhere; imports no JAX.
"""

from .convert import grid_meta_from_numpy, sdf_grid_from_numpy
from .ops.diff import sdf_from_occupancy_ft, sdf_from_occupancy_st, straight_through_sdf
from .engine import SdfEngine
from .grid import GridMeta, SdfGrid, invert_isometry, make_origin_transform, rotate_points
from .ops.edt import (
    extract_signed_distance_field,
    signed_field_from_masks,
    signed_field_virtual_border,
    squared_edt_both,
)
from .ops.feature import feature_transform
from .ops.query import autodiff_gradient, estimate_distance, interpolation_stencil
from .ops.render import RenderResult, camera_rays, render_depth
from .ops.voxelize import soft_voxelize_points, voxelize_points

__version__ = "0.1.0"

__all__ = [
    "GridMeta",
    "SdfGrid",
    "SdfEngine",
    "make_origin_transform",
    "rotate_points",
    "invert_isometry",
    "grid_meta_from_numpy",
    "sdf_grid_from_numpy",
    "extract_signed_distance_field",
    "signed_field_from_masks",
    "signed_field_virtual_border",
    "squared_edt_both",
    "estimate_distance",
    "interpolation_stencil",
    "autodiff_gradient",
    "render_depth",
    "camera_rays",
    "RenderResult",
    "voxelize_points",
    "soft_voxelize_points",
    "sdf_from_occupancy_st",
    "sdf_from_occupancy_ft",
    "straight_through_sdf",
    "feature_transform",
]
