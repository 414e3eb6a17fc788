"""Voxel-grid containers as frozen dataclasses over torch tensors.

Counterpart of ``sdf_tools_tpu/grid.py``. Same conventions:

  * values have shape ``[nx, ny, nz]`` (x-major, z fastest).
  * Cell centers: index ``i`` sits at ``origin_transform @ ((i + 0.5) * res)``
    (grid frame = origin_transform^-1 * world).
  * ``location_to_index`` floors the grid-frame coordinate / resolution.

Every tensor of a grid lives on one device, chosen explicitly by the caller
(``GridMeta.create(..., device=...)``); nothing here picks a device.

Label fields (connected component, object id, convex segment) are uint32 in
the JAX package. Here they are stored as int64 tensors holding the same
values (0 ... 2^32 - 1), since CUDA tensors of ``torch.uint32`` support few
operations; ``convert`` and the ``create`` methods convert at the boundary.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch


def require_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises for a CUDA device when CUDA
    is not available (nothing falls back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r}: CUDA is not available (pass device='cpu' to run on the CPU)")
    return device


def as_tensor_on(x, device) -> torch.Tensor:
    """A tensor stays where it is; array-like input becomes a tensor on
    ``device`` (checked by ``require_device``)."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x), device=require_device(device))


def flat_cell_index(ix: torch.Tensor, iy: torch.Tensor, iz: torch.Tensor, shape) -> torch.Tensor:
    """Flat int64 index of in-range cells (ix, iy, iz) of a grid of
    ``shape``: widened before the products, so grids of 2^31 cells and more
    index right."""
    return (ix.to(torch.int64) * shape[1] + iy) * shape[2] + iz


def float_to_int32(x: torch.Tensor) -> torch.Tensor:
    """Float -> int32 as XLA's ``convert`` gives it on every device:
    truncation toward zero, saturated to [-2^31, 2^31 - 1], NaN -> 0.
    PyTorch leaves the cast of NaN, of +-inf and of values beyond int32
    undefined (the CPU gives -2^31 for each), so every float-to-int cast of
    the port goes through here."""
    hi = 2147483647.0 if x.dtype == torch.float64 else 2147483520.0  # largest below 2^31
    clipped = torch.nan_to_num(x, nan=0.0).clamp(-2147483648.0, hi).to(torch.int32)
    return torch.where(x >= 2147483648.0, 2147483647, clipped)


def floor_to_int32(x: torch.Tensor) -> torch.Tensor:
    """``float_to_int32`` of ``floor(x)``: a coordinate's cell index."""
    return float_to_int32(torch.floor(x))


def make_origin_transform(translation, rotation=None, dtype=torch.float32, *, device) -> torch.Tensor:
    """Build a 4x4 origin transform in ``dtype`` from a translation (and optional 3x3 rotation)."""
    m = torch.eye(4, dtype=dtype, device=device)
    if rotation is not None:
        m[:3, :3] = torch.as_tensor(rotation, dtype=dtype, device=device)
    m[:3, 3] = torch.as_tensor(translation, dtype=dtype, device=device)
    return m


def rotate_points(rot: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """``p @ rot.T`` for [..., 3] points, written elementwise.

    Kept elementwise (no matmul) so that the rounding is the JAX package's
    exactly, and so that no reduced-precision matmul mode (TF32) can touch
    ray origins and directions: a few ulps here move rays by a fraction of a
    cell at long range and flip render hits."""
    rot = rot.to(p.dtype)
    return torch.stack(
        [
            p[..., 0] * rot[0, 0] + p[..., 1] * rot[0, 1] + p[..., 2] * rot[0, 2],
            p[..., 0] * rot[1, 0] + p[..., 1] * rot[1, 1] + p[..., 2] * rot[1, 2],
            p[..., 0] * rot[2, 0] + p[..., 1] * rot[2, 1] + p[..., 2] * rot[2, 2],
        ],
        dim=-1,
    )


def invert_isometry(m: torch.Tensor) -> torch.Tensor:
    """Invert a rigid 4x4 transform: inv([R t]) = [R^T, -R^T t]."""
    r = m[:3, :3]
    inv = torch.eye(4, dtype=m.dtype, device=m.device)
    inv[:3, :3] = r.T
    inv[:3, 3] = -rotate_points(r.T, m[:3, 3])
    return inv


@dataclasses.dataclass(frozen=True)
class GridMeta:
    """Geometry shared by every grid type: origin transform, its inverse,
    uniform resolution (0-d f32 tensor, and the same f32 value as a Python
    float, which the host reads without a device sync), cell counts and
    frame name."""

    origin_transform: torch.Tensor  # [4,4] f32
    inv_origin_transform: torch.Tensor  # [4,4] f32
    resolution: torch.Tensor  # 0-d f32
    resolution_float: float  # float(resolution), held on the host
    shape: Tuple[int, int, int]
    frame: str = "world"

    @staticmethod
    def create(origin_transform, resolution, shape, frame="world", *, device) -> "GridMeta":
        m = torch.as_tensor(origin_transform, dtype=torch.float32, device=device)
        res = torch.as_tensor(resolution, dtype=torch.float32)
        return GridMeta(
            origin_transform=m,
            inv_origin_transform=invert_isometry(m),
            resolution=res.to(device),
            resolution_float=float(res),
            shape=tuple(int(s) for s in shape),
            frame=frame,
        )

    @property
    def device(self) -> torch.device:
        return self.origin_transform.device

    def to(self, device) -> "GridMeta":
        """The same geometry with its tensors on ``device``."""
        return dataclasses.replace(
            self,
            origin_transform=self.origin_transform.to(device),
            inv_origin_transform=self.inv_origin_transform.to(device),
            resolution=self.resolution.to(device),
        )

    def world_to_grid(self, points: torch.Tensor) -> torch.Tensor:
        """World-frame points [..., 3] -> grid-frame coordinates [..., 3]."""
        r = self.inv_origin_transform[:3, :3]
        t = self.inv_origin_transform[:3, 3].to(points.dtype)
        return rotate_points(r, points) + t

    def grid_to_world(self, points: torch.Tensor) -> torch.Tensor:
        """Grid-frame coordinates [..., 3] -> world-frame points [..., 3]."""
        r = self.origin_transform[:3, :3]
        t = self.origin_transform[:3, 3].to(points.dtype)
        return rotate_points(r, points) + t

    def location_to_index(self, points: torch.Tensor) -> torch.Tensor:
        """World points [..., 3] -> int32 grid indices [..., 3] (floor,
        saturated as XLA's cast: NaN -> 0, +-inf and beyond -> the int32
        limits)."""
        g = self.world_to_grid(points)
        return floor_to_int32(g / self.resolution)

    def index_to_location_grid_frame(self, indices: torch.Tensor) -> torch.Tensor:
        """Integer indices [..., 3] -> grid-frame cell-center coordinates."""
        return (indices.to(torch.float32) + 0.5) * self.resolution

    def index_to_location(self, indices: torch.Tensor) -> torch.Tensor:
        """Integer indices [..., 3] -> world-frame cell-center locations."""
        return self.grid_to_world(self.index_to_location_grid_frame(indices))

    def index_in_bounds(self, indices: torch.Tensor) -> torch.Tensor:
        # per axis against Python ints: no shape tensor copied to the device
        ok = (indices[..., 0] >= 0) & (indices[..., 0] < self.shape[0])
        for ax in (1, 2):
            ok = ok & (indices[..., ax] >= 0) & (indices[..., ax] < self.shape[ax])
        return ok

    def location_in_bounds(self, points: torch.Tensor) -> torch.Tensor:
        """In bounds: a finite point whose cell is in the grid (a NaN point
        maps to cell 0, as in the JAX package, but is out of bounds here)."""
        return self.index_in_bounds(self.location_to_index(points)) & torch.isfinite(points).all(dim=-1)

    @property
    def sizes(self) -> torch.Tensor:
        """Grid extents in meters per axis, [3] f32."""
        return torch.tensor(self.shape, dtype=torch.float32, device=self.device) * self.resolution


@dataclasses.dataclass(frozen=True)
class SdfGrid:
    """A signed distance field: f32 values [nx, ny, nz] (meters; positive
    outside obstacles, at most ``-resolution`` inside) plus its geometry and
    the value returned for out-of-bounds queries (0-d f32)."""

    values: torch.Tensor
    meta: GridMeta
    oob_value: torch.Tensor

    @staticmethod
    def create(values, meta: GridMeta, oob_value=float("inf")) -> "SdfGrid":
        return SdfGrid(
            values=torch.as_tensor(values, dtype=torch.float32, device=meta.device),
            meta=meta,
            oob_value=torch.as_tensor(oob_value, dtype=torch.float32, device=meta.device),
        )

    def to(self, device) -> "SdfGrid":
        return SdfGrid(self.values.to(device), self.meta.to(device), self.oob_value.to(device))

    @property
    def resolution(self) -> torch.Tensor:
        return self.meta.resolution

    @property
    def shape(self) -> Tuple[int, int, int]:
        return self.meta.shape

    def get_value_by_index(self, indices: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Values at integer cell ``indices`` [..., 3] -> (value, in_bounds);
        out-of-bounds cells give ``oob_value``. One flat gather with int64
        indices (right past 2^31 cells)."""
        return self._value_at(indices, self.meta.index_in_bounds(indices))

    def get_value_by_location(self, points: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Values at the cells of world ``points``; non-finite points are out
        of bounds."""
        idx = self.meta.location_to_index(points)
        return self._value_at(idx, self.meta.index_in_bounds(idx) & torch.isfinite(points).all(dim=-1))

    def _value_at(self, indices: torch.Tensor, ok: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        ci = [indices[..., ax].clamp(0, n - 1) for ax, n in enumerate(self.shape)]
        v = self.values.reshape(-1)[flat_cell_index(*ci, self.shape)]
        return torch.where(ok, v, self.oob_value), ok


def label_field(x, shape, device) -> torch.Tensor:
    """A uint32 label field as an int64 tensor on ``device`` (zeros if
    ``x`` is None); numpy input is cast to uint32 first, as the JAX
    package's ``jnp.asarray(x, jnp.uint32)`` does."""
    if x is None:
        return torch.zeros(shape, dtype=torch.int64, device=device)
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int64)
    return torch.as_tensor(np.asarray(x, dtype=np.uint32).astype(np.int64), device=device)


def _filled(occupancy: torch.Tensor, unknown_is_filled: bool) -> torch.Tensor:
    """Filled cells by the reference's is_filled rule (collision_map.hpp:
    680-712): occupancy > 0.5, or >= 0.5 when unknown cells (== 0.5) count
    as filled."""
    return occupancy >= 0.5 if unknown_is_filled else occupancy > 0.5


@dataclasses.dataclass(frozen=True)
class CollisionMap:
    """Occupancy grid and connected-component labels (counterpart of the JAX
    package's ``CollisionMap``): occupancy f32 [nx, ny, nz] (> 0.5 filled,
    < 0.5 free, == 0.5 unknown), component labels int64 [nx, ny, nz] holding
    uint32 values, the geometry, the out-of-bounds occupancy (0-d f32) and
    whether the components are up to date."""

    occupancy: torch.Tensor
    component: torch.Tensor
    meta: GridMeta
    oob_occupancy: torch.Tensor
    components_valid: bool = False

    @staticmethod
    def create(occupancy, meta: GridMeta, oob_occupancy=0.0, component=None) -> "CollisionMap":
        occ = torch.as_tensor(occupancy, dtype=torch.float32, device=meta.device)
        return CollisionMap(
            occupancy=occ,
            component=label_field(component, occ.shape, meta.device),
            meta=meta,
            oob_occupancy=torch.as_tensor(oob_occupancy, dtype=torch.float32, device=meta.device),
        )

    @property
    def resolution(self) -> torch.Tensor:
        return self.meta.resolution

    @property
    def shape(self) -> Tuple[int, int, int]:
        return self.meta.shape

    def filled_mask(self, unknown_is_filled: bool = False) -> torch.Tensor:
        return _filled(self.occupancy, unknown_is_filled)


@dataclasses.dataclass(frozen=True)
class TaggedCollisionMap:
    """Tagged-object collision map (counterpart of the JAX package's
    ``TaggedCollisionMap``): occupancy f32 and three int64 label fields
    holding uint32 values (component, object id, convex segment), the
    geometry, the out-of-bounds occupancy and the labels' validity flags."""

    occupancy: torch.Tensor
    component: torch.Tensor
    object_id: torch.Tensor
    convex_segment: torch.Tensor
    meta: GridMeta
    oob_occupancy: torch.Tensor
    components_valid: bool = False
    convex_segments_valid: bool = False

    @staticmethod
    def create(occupancy, object_id, meta: GridMeta, oob_occupancy=0.0) -> "TaggedCollisionMap":
        occ = torch.as_tensor(occupancy, dtype=torch.float32, device=meta.device)
        return TaggedCollisionMap(
            occupancy=occ,
            component=label_field(None, occ.shape, meta.device),
            object_id=label_field(object_id, occ.shape, meta.device),
            convex_segment=label_field(None, occ.shape, meta.device),
            meta=meta,
            oob_occupancy=torch.as_tensor(oob_occupancy, dtype=torch.float32, device=meta.device),
        )

    @property
    def resolution(self) -> torch.Tensor:
        return self.meta.resolution

    @property
    def shape(self) -> Tuple[int, int, int]:
        return self.meta.shape

    def filled_mask(self, unknown_is_filled: bool = False) -> torch.Tensor:
        return _filled(self.occupancy, unknown_is_filled)
