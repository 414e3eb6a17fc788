"""The benchmark's input generators, all drawn from the run's seed.

``scene_spheres`` and ``device_scene`` are frozen copies of the port's
``scripts/_scenes.py`` (BASELINE's ``make_scene``: 40 spheres, about 8%
filled, rasterised on the device bitwise), kept here so that the yardstick
does not move with the program. The rest is the benchmark's own: point clouds in config #3's two
boxes, query points and camera views.

Every generator takes an explicit integer seed; ``sub_seed`` derives the
seeds of a run's parts from ``--seed`` (any non-negative integer, also past
2**32), so that the same seed gives the same inputs.
"""
from __future__ import annotations

import math

import numpy as np
import torch

SCENE_CHUNK = 64  # x-planes per rasterisation chunk


def sub_seed(seed: int, *parts: int) -> int:
    """A 63-bit seed for part ``parts`` of the run seeded ``seed``."""
    ss = np.random.SeedSequence([int(seed), *[int(p) for p in parts]])
    return int(ss.generate_state(1, np.uint64)[0]) >> 1


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g


# ---- BASELINE's sphere scene (frozen copy) ----------------------------------


def scene_spheres(n: int, seed: int = 0):
    """``make_scene(n)``'s 40 sphere centers and radii (its rng draws)."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(0, n, (40, 3))
    return c, rng.uniform(n * 0.03, n * 0.12, 40)


def device_scene(n: int, device, seed: int = 0, chunk: int = SCENE_CHUNK) -> torch.Tensor:
    """``make_scene(n, seed)`` rasterised on ``device``: the same rng draws and
    the same float64 arithmetic in the same order, in x-chunks, bitwise."""
    c, r = scene_spheres(n, seed)
    ii = torch.arange(n, dtype=torch.float64, device=device)
    mask = torch.zeros((n, n, n), dtype=torch.bool, device=device)
    for k in range(40):
        dx, dy, dz = (ii - float(c[k, a]) for a in range(3))
        x2, y2, z2 = dx * dx, dy * dy, dz * dz
        r2 = float(r[k] ** 2)
        for x0 in range(0, n, chunk):
            part = mask[x0 : x0 + chunk]
            part |= (x2[x0 : x0 + chunk, None, None] + y2[None, :, None] + z2[None, None, :]) <= r2
    return mask


# ---- point clouds, queries, views ------------------------------------------


def box_cloud(boxes, points_per_box: int, extent_m: float, seed: int, device) -> torch.Tensor:
    """Points [len(boxes) * points_per_box, 3] float32, uniform in each box;
    a box is ``[lo, hi]`` as fractions of the grid's extent on every axis
    (config #3: [0.2, 0.5] and [0.6, 0.9])."""
    g = generator(seed, device)
    parts = []
    for lo, hi in boxes:
        u = torch.rand((points_per_box, 3), generator=g, device=device, dtype=torch.float64)
        parts.append((lo + (hi - lo) * u) * extent_m)
    return torch.cat(parts).to(torch.float32)


def uniform_points(count: int, lo_m: float, hi_m: float, seed: int, device) -> torch.Tensor:
    """Points [count, 3] float32, uniform in the cube [lo_m, hi_m)^3."""
    g = generator(seed, device)
    u = torch.rand((count, 3), generator=g, device=device, dtype=torch.float64)
    return (lo_m + (hi_m - lo_m) * u).to(torch.float32)


def render_kw(cfg: dict) -> dict:
    """A configuration's render settings: ``render_depth``'s keywords."""
    cam = cfg["camera"]
    return dict(t_max=float(cam["t_max_m"]), max_steps=int(cam["max_steps"]), eps=float(cam["eps_m"]))


def view_azimuths(count: int, seed: int) -> np.ndarray:
    """``count`` evenly spaced azimuths (degrees) in an order drawn from the
    seed: every seed renders the same set of views, in its own order."""
    rng = np.random.default_rng(seed)
    return (360.0 / count) * rng.permutation(count)


def orbit_rays(n: int, res: float, hw: int, azimuths_deg, fov_deg: float, device):
    """(origins, directions) [V, hw, hw, 3] float32 of pinhole cameras at
    ``bench.py``'s place (1.2 n res back from the grid's centre, 0.4 n res
    up, looking at the centre, ``fov_deg`` wide) turned by each azimuth about
    the vertical axis (azimuth 0 is bench.py's camera). The pinhole math is
    the port's ``camera_rays``, written out here so that the inputs do not
    come from the program."""
    center = np.full(3, 0.5 * n * res)
    origins, dirs = [], []
    for az in azimuths_deg:
        a = math.radians(float(az))
        back = -1.2 * n * res
        pos = torch.as_tensor(center + np.array([back * math.cos(a), back * math.sin(a), 0.4 * n * res]),
                              dtype=torch.float32, device=device)
        fwd = torch.as_tensor(center, dtype=torch.float32, device=device) - pos
        fwd = fwd / torch.linalg.norm(fwd)
        up = torch.tensor([0.0, 0.0, 1.0], dtype=torch.float32, device=device)
        right = torch.linalg.cross(fwd, up)
        right = right / torch.linalg.norm(right)
        true_up = torch.linalg.cross(right, fwd)
        tan_half = torch.tan(torch.deg2rad(torch.tensor(fov_deg, dtype=torch.float32, device=device)) / 2.0)
        ys = torch.linspace(1.0, -1.0, hw, dtype=torch.float32, device=device)[:, None] * tan_half
        xs = torch.linspace(-1.0, 1.0, hw, dtype=torch.float32, device=device)[None, :] * tan_half
        d = fwd + xs[..., None] * right + ys[..., None] * true_up
        dirs.append(d / torch.linalg.norm(d, dim=-1, keepdim=True))
        origins.append(pos.expand(dirs[-1].shape))
    return torch.stack(origins).contiguous(), torch.stack(dirs).contiguous()
