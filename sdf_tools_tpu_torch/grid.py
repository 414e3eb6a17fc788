"""Voxel-grid containers as frozen dataclasses over torch tensors.

Counterpart of ``sdf_tools_tpu/grid.py``. Same conventions:

  * values have shape ``[nx, ny, nz]`` (x-major, z fastest).
  * Cell centers: index ``i`` sits at ``origin_transform @ ((i + 0.5) * res)``
    (grid frame = origin_transform^-1 * world).
  * ``location_to_index`` floors the grid-frame coordinate / resolution.

Every tensor of a grid lives on one device, chosen explicitly by the caller
(``GridMeta.create(..., device=...)``); nothing here picks a device.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


def make_origin_transform(translation, rotation=None, *, device) -> torch.Tensor:
    """Build a 4x4 f32 origin transform from a translation (and optional 3x3 rotation)."""
    m = torch.eye(4, dtype=torch.float32, device=device)
    if rotation is not None:
        m[:3, :3] = torch.as_tensor(rotation, dtype=torch.float32, device=device)
    m[:3, 3] = torch.as_tensor(translation, dtype=torch.float32, device=device)
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

    def location_to_index(self, points: torch.Tensor) -> torch.Tensor:
        """World points [..., 3] -> int32 grid indices [..., 3] (floor)."""
        g = self.world_to_grid(points)
        return torch.floor(g / self.resolution).to(torch.int32)

    def index_in_bounds(self, indices: torch.Tensor) -> torch.Tensor:
        # per axis against Python ints: no shape tensor copied to the device
        ok = (indices[..., 0] >= 0) & (indices[..., 0] < self.shape[0])
        for ax in (1, 2):
            ok = ok & (indices[..., ax] >= 0) & (indices[..., ax] < self.shape[ax])
        return ok

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
