"""Scenes of K8's edge cases (the plane sweep, ``csrc/render_plane.cu``),
shared by ``tests/test_torch_plane_stage.py`` on the CPU and ``chip_smoke.py``
on the card, which holds the kernel against its plain version on each.

Numpy only (the cameras through the port's ``render.camera_rays``); imports
neither JAX nor ``sdf_tools_tpu``.
"""
import numpy as np

K8_EDGE_CASES = ("forward", "backward", "shifted", "axes12", "inside", "steep")
K8_EDGE_T_MAX = 40.0


def sphere_values(shape=(64, 64, 256), res=0.1):
    """The two-sphere analytic field of tests/test_render_plane.py (radii
    scaled by the shortest edge, which is ny there)."""
    nx, ny, nz = shape
    ii, jj, kk = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij")
    pts = (np.stack([ii, jj, kk], -1) + 0.5) * res
    c1 = np.array([nx * 0.5, ny * 0.5, nz * 0.45]) * res
    c2 = np.array([nx * 0.65, ny * 0.35, nz * 0.55]) * res
    d1 = np.linalg.norm(pts - c1, axis=-1) - 0.2 * min(shape) * res
    d2 = np.linalg.norm(pts - c2, axis=-1) - 0.12 * min(shape) * res
    return np.minimum(d1, d2).astype(np.float32)


def _camera_np(pos, look_at, h, w, fov=40.0, up=(0.0, 0.0, 1.0)):
    from sdf_tools_tpu_torch.ops import render

    o, v = render.camera_rays(np.asarray(pos, np.float32), np.asarray(look_at, np.float32), up, fov, h, w, device="cpu")
    return o.numpy(), v.numpy()


def _steep_row(values, res, sy, sz, spread):
    """128 parallel rays marching +x with slopes (sy, sz) through the big
    sphere's center, spread along z by ``spread`` world units a lane."""
    target = np.array([values.shape[0] * 0.5, values.shape[1] * 0.5, values.shape[2] * 0.45]) * res
    d = np.array([1.0, sy, sz]) / np.linalg.norm([1.0, sy, sz])
    lanes = np.arange(128)
    pts = target + np.stack([0 * lanes, 0 * lanes, (lanes - 64) * spread], 1)
    return (pts - 3.0 * d).astype(np.float32), np.tile(d, (128, 1)).astype(np.float32)


def k8_edge_case(case: str):
    """(values, res, origins, directions), numpy, of one of K8's edge cases
    (K8_EDGE_CASES), each rendered with t_max K8_EDGE_T_MAX: the two-sphere
    field of the plane tests seen as they see it marching +x ("forward",
    32x128) and -x ("backward", 24x128); a 24 x 60 x 258 grid from +x, whose
    first executed slab is the shifted last one (24 % 16 != 0) and whose
    rows are not 16-byte aligned (258 % 4 != 0) ("shifted"); one launch of
    rows marching axes 1 and 2 over a 256 x 256 x 64 grid ("axes12"); two
    rows starting inside the big sphere, marching +x and -x (entry models,
    "inside"); two steep rows near SLOPE_CAP (|dy/dx| 3.3), one spread wide
    along z, so that a slab's lanes read far-apart cells ("steep")."""
    if case == "shifted":
        values = sphere_values((24, 60, 258))
    elif case == "axes12":
        values = sphere_values((256, 256, 64))
    else:
        values = sphere_values()
    res = 0.1
    ext = np.array(values.shape) * res
    center = ext * 0.5
    big = np.array([ext[0] * 0.5, ext[1] * 0.5, ext[2] * 0.45])  # the big sphere's center
    if case == "forward":
        o, v = _camera_np(center + np.array([-ext[0] * 1.5, ext[1] * 0.1, ext[2] * 0.05]), center, 32, 128)
    elif case in ("backward", "shifted"):
        o, v = _camera_np(center + np.array([ext[0] * 1.5, ext[1] * 0.1, 0.0]), center, 24 if case == "backward" else 16,
                          128)
    elif case == "axes12":
        oy, vy = _camera_np(big + np.array([0.3, -ext[1] * 0.7, 0.2]), big, 8, 128, fov=8.0)
        oz, vz = _camera_np(big + np.array([0.2, 0.3, ext[2] * 1.5]), big, 8, 128, fov=8.0, up=(0.0, 1.0, 0.0))
        o, v = np.concatenate([oy, oz]), np.concatenate([vy, vz])
    elif case == "inside":
        lanes = np.arange(256)
        o = big + np.stack([0 * lanes, (lanes % 16 - 8) * 0.02, (lanes // 16 % 8 - 4) * 0.02], 1)
        v = np.tile([1.0, 0.0, 0.0], (256, 1))
        v[128:] = -v[128:]
    else:
        rows = [_steep_row(values, res, 3.3, 0.4, spread) for spread in (0.02, 0.002)]
        o, v = np.concatenate([r[0] for r in rows]), np.concatenate([r[1] for r in rows])
    return values, res, np.asarray(o, np.float32), np.asarray(v, np.float32)
