"""SdfEngine: the end-to-end serving API (counterpart of ``sdf_tools_tpu/engine.py``).

Fixes the grid and image shapes up front and serves
occupancy/points -> signed field -> queries / depth renders on one device::

    engine = SdfEngine(shape=(256, 256, 256), resolution=0.05, device="cuda")
    engine.warmup()                       # build the kernels, touch every stage
    sdf = engine.sdf_from_points(points)  # [N,3] -> SdfGrid
    d, ok = engine.query(sdf, query_pts)  # batched trilinear distances
    depth, hit = engine.render(sdf, cam, look_at)

The device is the caller's choice and is never picked implicitly: a CUDA
engine on a machine without CUDA raises instead of running on the CPU.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .grid import GridMeta, SdfGrid, make_origin_transform, require_device
from .ops import edt, query, render, voxelize


class SdfEngine:
    def __init__(
        self,
        shape: Tuple[int, int, int],
        resolution: float,
        device,
        origin=None,
        oob_value: float = 1e3,
        backend: str = "auto",
        image_hw: Tuple[int, int] = (256, 256),
        fov_deg: float = 50.0,
        render_t_max: Optional[float] = None,
        render_max_steps: int = 96,
        render_eps: float = 1e-3,
        render_backend: str = "auto",
        render_up: Tuple[float, float, float] = (0.0, 0.0, 1.0),
    ):
        self.device = require_device(device)
        if origin is None:
            origin = make_origin_transform([0.0, 0.0, 0.0], device=self.device)
        self.meta = GridMeta.create(origin, resolution, shape, device=self.device)
        self.oob_value = float(oob_value)
        self.backend = backend
        self.image_hw = tuple(image_hw)
        self.fov_deg = fov_deg
        extent = max(shape) * resolution
        self.render_t_max = render_t_max if render_t_max is not None else 4.0 * extent
        self.render_max_steps = render_max_steps
        self.render_eps = float(render_eps)
        self.render_backend = render_backend
        self.render_up = tuple(float(u) for u in render_up)

    def _tensor(self, x, dtype=None) -> torch.Tensor:
        return torch.as_tensor(x, dtype=dtype, device=self.device)

    def sdf_from_occupancy(self, occupancy) -> SdfGrid:
        """Occupancy [nx, ny, nz] (> 0.5 is filled) -> signed field."""
        occ = self._tensor(occupancy)
        mask = occ if occ.dtype == torch.bool else occ > 0.5
        vals, _, _ = edt.signed_field_from_masks(mask, self.meta.resolution_float, self.backend)
        return SdfGrid.create(vals, self.meta, self.oob_value)

    def sdf_from_points(self, points) -> SdfGrid:
        occ = voxelize.voxelize_points(self._tensor(points, torch.float32), self.meta)
        return self.sdf_from_occupancy(occ)

    def query(self, sdf: SdfGrid, points) -> Tuple[torch.Tensor, torch.Tensor]:
        return query.estimate_distance(sdf, self._tensor(points, torch.float32))

    def query_with_grad(self, sdf: SdfGrid, points):
        """(distance, d distance / d point, in_bounds)."""
        p = self._tensor(points, torch.float32)
        d, ok = query.estimate_distance(sdf, p)
        return d, query.autodiff_gradient(sdf, p), ok

    def render(
        self,
        sdf: SdfGrid,
        camera_pos,
        look_at,
        up=None,
        eps: Optional[float] = None,
        backend: Optional[str] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Depth image [h, w] and hit mask; ``up``/``eps``/``backend``
        default to the engine's construction-time settings."""
        up = self.render_up if up is None else up
        h, w = self.image_hw
        o, v = render.camera_rays(camera_pos, look_at, up, self.fov_deg, h, w, device=self.device)
        out = render.render_depth(
            sdf, o, v,
            t_max=self.render_t_max,
            eps=self.render_eps if eps is None else float(eps),
            max_steps=self.render_max_steps,
            backend=self.render_backend if backend is None else backend,
        )
        return out.depth, out.hit

    def warmup(self, n_points: int = 1024, n_queries: int = 1024) -> SdfGrid:
        """Run every stage once with representative shapes (on a GPU this
        also builds the kernels)."""
        extent = np.asarray(self.meta.shape, np.float64) * self.meta.resolution_float
        rng = np.random.default_rng(0)
        pts = rng.uniform(0, extent, (n_points, 3)).astype(np.float32)
        sdf = self.sdf_from_points(pts)
        q = rng.uniform(0, extent, (n_queries, 3)).astype(np.float32)
        self.query(sdf, q)
        self.query_with_grad(sdf, q)
        self.render(sdf, (-0.5 * extent).astype(np.float32), (0.5 * extent).astype(np.float32))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return sdf
