"""Plain PyTorch exact Euclidean distance transform: the benchmark's
reference for the signed field and its feature transform.

The squared distance to the nearest seed is separable: along each axis in
turn, f'(i) = min_j f(j) + (i - j)^2 (Felzenszwalb and Huttenlocher's
recurrence, here taken by brute force over every j). Each pass runs on
blocks of lines, [lines, n, n] at a time, so that it fits beside the
program's state on the card. Values are whole numbers below 2^24 and exact
in float32. Nothing here comes from the program under test.
"""
from __future__ import annotations

import torch

INF = 1.0e30  # "no seed on this line yet"
BLOCK_ELEMS = 1 << 28  # float32 elements of one block's [lines, n, n] temporary (1 GiB)


def _lines(f: torch.Tensor, axis: int) -> torch.Tensor:
    return f.movedim(axis, -1).reshape(-1, f.shape[axis]).contiguous()


def _unlines(lines: torch.Tensor, shape, axis: int) -> torch.Tensor:
    moved = list(shape)
    moved.append(moved.pop(axis))
    return lines.reshape(moved).movedim(-1, axis).contiguous()


def _pass(f: torch.Tensor, axis: int, with_argmin: bool, block_elems: int):
    """min_j f(j) + (i - j)^2 along ``axis`` (and the first minimising j)."""
    n = f.shape[axis]
    lines = _lines(f, axis)
    j = torch.arange(n, device=f.device, dtype=torch.float32)
    d2 = (j[:, None] - j[None, :]) ** 2  # [i, j]
    out = torch.empty_like(lines)
    arg = torch.empty(lines.shape, dtype=torch.int64, device=f.device) if with_argmin else None
    step = max(1, block_elems // (n * n))
    for a in range(0, lines.shape[0], step):
        cand = lines[a : a + step, None, :] + d2[None]
        if with_argmin:
            out[a : a + step], arg[a : a + step] = cand.min(dim=-1)
        else:
            out[a : a + step] = cand.amin(dim=-1)
        del cand
    out = _unlines(out, f.shape, axis)
    return (out, _unlines(arg, f.shape, axis)) if with_argmin else out


def squared_edt(seeds: torch.Tensor, block_elems: int = BLOCK_ELEMS) -> torch.Tensor:
    """Squared distance (in cells) from every cell to the nearest True cell
    of ``seeds`` [nx, ny, nz], float32; ``inf`` where there is no seed."""
    f = torch.where(seeds, 0.0, INF).to(torch.float32)
    for axis in range(3):
        f = _pass(f, axis, False, block_elems)
    return torch.where(f >= INF, torch.inf, f)


def distance(d2: torch.Tensor, resolution: float, dtype=torch.float32) -> torch.Tensor:
    """sqrt(d2) * resolution in ``dtype``: the root correctly rounded to the
    dtype (taken in float64 and rounded once), times the resolution in the
    dtype, as the configuration's float32 field states."""
    root = d2.to(torch.float64).sqrt().to(dtype)
    return root * torch.tensor(resolution, dtype=torch.float32).to(dtype).to(d2.device)


def signed_field(filled: torch.Tensor, resolution: float, dtype=torch.float32,
                 block_elems: int = BLOCK_ELEMS) -> torch.Tensor:
    """The two-field signed distance (upstream sdf_tools' ``BuildDistanceField``
    of the filled and the free cells): the distance to the nearest filled
    cell less the distance to the nearest free cell, so positive in free
    space and at most ``-resolution`` inside."""
    out = distance(squared_edt(filled, block_elems), resolution, dtype)
    out -= distance(squared_edt(~filled, block_elems), resolution, dtype)
    return out


def feature_transform(seeds: torch.Tensor, block_elems: int = BLOCK_ELEMS):
    """(squared distance [nx, ny, nz] float32, flat index int64 of each
    cell's nearest seed) by the same three passes, each keeping the first
    minimising j of its line: x first, then y, then z. A cell with no seed
    anywhere gets index -1."""
    nx, ny, nz = seeds.shape
    f = torch.where(seeds, 0.0, INF).to(torch.float32)
    f, jx = _pass(f, 0, True, block_elems)  # x-line seed of each cell
    f, jy = _pass(f, 1, True, block_elems)
    f, jz = _pass(f, 2, True, block_elems)
    # compose: the z winner's y winner's x seed
    ix = torch.arange(nx, device=seeds.device)[:, None, None].expand(nx, ny, nz)
    iy = torch.arange(ny, device=seeds.device)[None, :, None].expand(nx, ny, nz)
    wz = jz
    wy = torch.gather(jy, 2, wz)
    wx = jx[ix, wy, wz]
    feat = (wx * ny + wy) * nz + wz
    found = f < INF
    return torch.where(found, f, torch.inf), torch.where(found, feat, -1)
