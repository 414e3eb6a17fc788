"""The port's 2-D and 3-D front ends against the JAX package, on the CPU.

``image_to_occupancy``, ``mesh_to_occupancy`` (a tilted box, a UV sphere
and a torus, whole and in odd batches), ``image_sdf``,
``false_color_preview``, and ``utils_2d`` / ``utils_3d`` including the
batched form. Tolerance: bitwise everywhere (occupancy, the pixel and cell
distances, the gradients and the preview's bytes).

Two findings are pinned, not hidden: on a mesh with cell centers on its
faces the jitted JAX parity batch (FMAs) and the port round the crossings
differently; and the JAX batch scatters every non-crossing
(triangle, column) pair to index -1, which lands in the last column's top
bucket, so that column's parity flips when their count is odd (the port
drops them).
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from sdf_tools_tpu import utils_2d as jutils_2d, utils_3d as jutils_3d
from sdf_tools_tpu.grid import GridMeta as JaxGridMeta, make_origin_transform as jax_origin
from sdf_tools_tpu.ops import image_sdf as jimage_sdf, voxelize as jvoxelize
from sdf_tools_tpu_torch import utils_2d, utils_3d
from sdf_tools_tpu_torch.ops import image_sdf, voxelize
from test_components import _box_mesh
from test_torch_render import _port_meta, _rotation


def _same(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (got.shape, got.dtype, want.shape, want.dtype)
    if want.dtype == np.float32:
        got, want = got.view(np.uint32), want.view(np.uint32)
    np.testing.assert_array_equal(got, want)


def _image(h=40, w=33, seed=0, n_rect=5):
    """config #1's kind of image: a few filled rectangles."""
    rng = np.random.default_rng(seed)
    img = np.zeros((h, w), np.uint8)
    for _ in range(n_rect):
        y, x = rng.integers(2, h - 6), rng.integers(2, w - 6)
        dy, dx = rng.integers(1, 8, 2)
        img[y : y + dy, x : x + dx] = 1
    return img


def _uv_sphere(c, r, nu=24, nv=12):
    verts = [[0.0, 0.0, r]]
    for i in range(1, nv):
        th = np.pi * i / nv
        verts += [[r * np.sin(th) * np.cos(ph), r * np.sin(th) * np.sin(ph), r * np.cos(th)]
                  for ph in 2 * np.pi * np.arange(nu) / nu]
    verts.append([0.0, 0.0, -r])
    ring = lambda i, j: 1 + i * nu + j % nu  # noqa: E731
    faces = [(0, ring(0, j), ring(0, j + 1)) for j in range(nu)]
    for i in range(nv - 2):
        for j in range(nu):
            faces += [(ring(i, j), ring(i + 1, j), ring(i + 1, j + 1)), (ring(i, j), ring(i + 1, j + 1), ring(i, j + 1))]
    last = len(verts) - 1
    faces += [(last, ring(nv - 2, j + 1), ring(nv - 2, j)) for j in range(nu)]
    return (np.array(verts) + c).astype(np.float32), np.array(faces, np.int32)


def _torus(c, big_r, r, nu=32, nv=16):
    u = 2 * np.pi * np.arange(nu)[:, None] / nu
    w = 2 * np.pi * np.arange(nv)[None, :] / nv
    verts = np.stack([(big_r + r * np.cos(w)) * np.cos(u), (big_r + r * np.cos(w)) * np.sin(u),
                      r * np.sin(w) + 0 * u], -1).reshape(-1, 3)
    at = lambda i, j: (i % nu) * nv + j % nv  # noqa: E731
    faces = []
    for i in range(nu):
        for j in range(nv):
            faces += [(at(i, j), at(i + 1, j), at(i + 1, j + 1)), (at(i, j), at(i + 1, j + 1), at(i, j + 1))]
    return (verts + c).astype(np.float32), np.array(faces, np.int32)


def _tilted():
    th = 0.5
    rz = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1]])
    rx = np.array([[1, 0, 0], [0, np.cos(0.3), -np.sin(0.3)], [0, np.sin(0.3), np.cos(0.3)]])
    return rz @ rx


MESHES = {
    "box": (lambda: _box_mesh([1.5, 1.4, 1.2], [1.1, 0.8, 0.9], _tilted()), (32, 28, 24), None),
    "sphere": (lambda: _uv_sphere([1.2, 1.1, 1.0], 0.8), (24, 24, 20), None),
    "torus": (lambda: _torus([1.5, 1.5, 1.0], 0.9, 0.35), (30, 30, 20), _rotation(10.0, 1)),
}


@pytest.mark.parametrize("batch", [256, 7])
@pytest.mark.parametrize("name", list(MESHES))
def test_mesh_to_occupancy_matches_jax(name, batch):
    make, shape, rot = MESHES[name]
    verts, faces = make()
    jmeta = JaxGridMeta.create(jax_origin([0.05, -0.02, 0.0], rot), 0.1, shape)
    got = voxelize.mesh_to_occupancy(verts, faces, _port_meta(jmeta), batch=batch)
    assert got.sum() > 500
    _same(got, jvoxelize.mesh_to_occupancy(verts, faces, jmeta, batch=batch))


def test_mesh_to_occupancy_jax_wraps_dropped_pairs_to_the_last_column():
    """25 x 23 columns (odd) and 12 faces in batches of 5 (15 padded, odd):
    an odd number of non-crossing pairs, which the JAX batch scatters to
    index -1. Its last column comes out filled top to bottom; the port's is
    empty, as the mesh (far from it) says. Every other cell agrees."""
    verts, faces = _box_mesh([1.2, 1.1, 1.0], [0.7, 0.6, 0.5], _tilted())
    jmeta = JaxGridMeta.create(jax_origin([0.0, 0.0, 0.013]), 0.1, (25, 23, 20))
    got = voxelize.mesh_to_occupancy(verts, faces, _port_meta(jmeta), batch=5).numpy()
    want = np.array(jvoxelize.mesh_to_occupancy(verts, faces, jmeta, batch=5))
    assert (want[-1, -1] == 1).all() and (got[-1, -1] == 0).all()
    want[-1, -1] = 0
    np.testing.assert_array_equal(got, want)
    assert got.sum() > 100


def test_mesh_to_occupancy_faces_through_cell_centers_round_apart():
    """A box with horizontal faces at z = 0.75 and 1.25, through cell
    centers, and side faces vertical (rotated about z only: slivers in
    projection). The crossings' buckets and the slivers' edge functions
    sit on rounding boundaries: the jitted JAX batch (XLA contracts FMAs)
    and the port fill 23 cells differently, and both differ from the box's
    analytic containment of the cell centers (JAX on 27 cells, the port on
    36). The mesh tests above keep cell centers off the faces."""
    rot = _rotation(30.0, 2)
    verts, faces = _box_mesh([1.2, 1.1, 1.0], [0.7, 0.6, 0.5], rot)
    shape = (25, 23, 20)
    jmeta = JaxGridMeta.create(jax_origin([0.0, 0.0, 0.0]), 0.1, shape)
    got = voxelize.mesh_to_occupancy(verts, faces, _port_meta(jmeta)).numpy()
    want = np.asarray(jvoxelize.mesh_to_occupancy(verts, faces, jmeta))
    centers = (np.indices(shape).transpose(1, 2, 3, 0) + 0.5) * 0.1 + np.array([1.23456789e-5, 2.34567891e-5, 0])
    exact = (np.abs((centers - [1.2, 1.1, 1.0]) @ rot) < np.array([0.35, 0.3, 0.25])).all(-1)
    assert ((got != 0) != (want != 0)).sum() == 23
    assert ((want != 0) != exact).sum() == 27 and ((got != 0) != exact).sum() == 36


def test_mesh_to_occupancy_rejects_bad_shapes():
    jmeta = JaxGridMeta.create(jax_origin([0.0, 0.0, 0.0]), 0.1, (4, 4, 4))
    with pytest.raises(ValueError):
        voxelize.mesh_to_occupancy(np.zeros((3, 2)), np.zeros((1, 3), np.int32), _port_meta(jmeta))
    with pytest.raises(ValueError):
        voxelize.mesh_to_occupancy(np.zeros((3, 3)), np.zeros((1, 4), np.int32), _port_meta(jmeta))


@pytest.mark.parametrize("threshold", [0.5, 0.0])
def test_image_to_occupancy_matches_jax(threshold):
    img = np.random.default_rng(1).random((17, 11)).astype(np.float32)
    img[img < 0.3] = 0.0
    _same(voxelize.image_to_occupancy(img, threshold, device="cpu"), jvoxelize.image_to_occupancy(img, threshold))
    t = torch.as_tensor(img)
    _same(voxelize.image_to_occupancy(t, threshold), jvoxelize.image_to_occupancy(img, threshold))


@pytest.mark.parametrize("shape", [(40, 33), (16, 16), (1, 9), (7, 1)])
def test_image_sdf_and_preview_match_jax(shape):
    img = _image(*shape) if min(shape) > 8 else (np.arange(np.prod(shape)).reshape(shape) % 3 == 0).astype(np.uint8)
    got = image_sdf.image_sdf(img, device="cpu")
    want = jimage_sdf.image_sdf(jnp.asarray(img))
    for g, w in zip(got, want):
        _same(g, w)
    _same(image_sdf.false_color_preview(got[0]), jimage_sdf.false_color_preview(want[0]))


def test_image_sdf_edge_cases_match_jax():
    """An empty image (no filled pixel: +inf outside), a full one, and a
    float image with a threshold; the preview of each."""
    for img, thr in ((np.zeros((9, 12), np.uint8), 0.5), (np.ones((9, 12), np.uint8), 0.5),
                     (np.random.default_rng(2).random((13, 10)).astype(np.float32), 0.7)):
        got = image_sdf.image_sdf(torch.as_tensor(img), thr)
        want = jimage_sdf.image_sdf(jnp.asarray(img), thr)
        for g, w in zip(got, want):
            _same(g, w)
        _same(image_sdf.false_color_preview(got[0]), jimage_sdf.false_color_preview(want[0]))


def test_utils_2d_matches_jax():
    """The reference's test_bindings scenario (20 x 40, res 0.05, origin at
    minus half the size) and config #1's kind of image."""
    world = np.zeros([40, 20], dtype=np.uint8)
    world[1, 3] = 1
    cases = ((world, 0.05, [-10.0, -20.0]), (_image(48, 37, seed=3), 1.0, [0.0, 0.0]), (_image(9, 30, seed=4), 0.3, [0.5, -1.0]))
    for grid_world, res, origin in cases:
        got = utils_2d.compute_sdf_and_gradient(grid_world, res, origin, device="cpu")
        want = jutils_2d.compute_sdf_and_gradient(grid_world, res, origin)
        for g, w in zip(got, want):
            _same(g, w)


def test_utils_2d_helpers_match_jax():
    from sdf_tools_tpu.grid import CollisionMap as JaxCollisionMap
    from sdf_tools_tpu.ops import edt as jedt, query as jquery
    from sdf_tools_tpu_torch import CollisionMap, convert

    img = _image(21, 18, seed=5)
    occ = (img.T == 1)[:, :, None]
    jmeta = JaxGridMeta.create(jax_origin([0.5, 0.25, 0.0]), 0.2, occ.shape)
    meta = _port_meta(jmeta)
    jsdf, _ = jedt.extract_signed_distance_field(jnp.asarray(occ), jmeta, oob_value=-10000.0)
    sdf = convert.sdf_grid_from_numpy(np.asarray(jsdf.values), meta, -10000.0)
    for g, w in zip(utils_2d.compute_gradient(sdf), jutils_2d.compute_gradient(jsdf)):
        _same(g, w)
    _same(utils_2d.sdf_to_np(sdf), jutils_2d.sdf_to_np(jsdf))
    grad = jquery.full_gradient(jsdf)
    _same(utils_2d.gradient_to_np(torch.as_tensor(np.array(grad))), jutils_2d.gradient_to_np(grad))
    _same(utils_2d.gradient_to_np(np.asarray(grad)[:, :, 0]), jutils_2d.gradient_to_np(np.asarray(grad)[:, :, 0]))
    for g, w in zip(utils_2d.to_np(sdf, np.asarray(grad)), jutils_2d.to_np(jsdf, grad)):
        _same(g, w)
    occ_f = occ.astype(np.float32)
    _same(utils_2d.grid_to_np(CollisionMap.create(occ_f, meta)), jutils_2d.grid_to_np(JaxCollisionMap.create(occ_f, jmeta)))


def test_utils_3d_matches_jax():
    rng = np.random.default_rng(6)
    env = (rng.random((10, 8, 6)) < 0.15).astype(np.uint8)  # [y, x, z]
    for res, origin in ((0.1, [0.0, 0.0, 0.0]), (0.07, [0.3, -0.2, 1.0])):
        got = utils_3d.compute_sdf_and_gradient(env, res, origin, device="cpu")
        want = jutils_3d.compute_sdf_and_gradient(env, res, origin)
        for g, w in zip(got, want):
            _same(g, w)
        sdf = utils_3d.compute_sdf(env, res, origin, device="cpu")
        jsdf = jutils_3d.compute_sdf(env, res, origin)
        _same(sdf.values, jsdf.values)
        _same(sdf.oob_value, jsdf.oob_value)
        _same(utils_3d.get_gradient(sdf), jutils_3d.get_gradient(jsdf))
        _same(utils_3d.get_gradient(sdf, np.float32), jutils_3d.get_gradient(jsdf, np.float32))


def test_utils_3d_batched_matches_jax():
    """The batch as a loop of fields and gradients, stacked. The JAX package
    vmaps one jitted function over it, and its jitted gradient differs from
    its eager one in the last bit here and there (23 of 2304 values here), so
    each element is held bitwise to the JAX package's unbatched
    ``compute_sdf_and_gradient``, and the batch to the JAX batch with the
    tolerance ``tests/test_api.py`` holds that to (fields bitwise, gradients
    rtol 1e-5, atol 1e-6)."""
    rng = np.random.default_rng(0)
    envs = (rng.random((3, 8, 8, 4)) < 0.2).astype(np.uint8)
    envs[:, 0, 0, 0] = 1
    got = utils_3d.compute_sdf_and_gradient_batched(envs, 0.1, [0, 0, 0], device="cpu")
    want = jutils_3d.compute_sdf_and_gradient_batched(envs, 0.1, [0, 0, 0])
    _same(got[0], want[0])
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-5, atol=1e-6)
    for b in range(3):
        single = jutils_3d.compute_sdf_and_gradient(envs[b], 0.1, [0, 0, 0])
        _same(got[0][b], single[0])
        _same(got[1][b], single[1])


def test_numpy_front_ends_default_to_cuda(monkeypatch):
    """Numpy input goes to the card unless the caller names the CPU; without
    CUDA that raises rather than falling back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    img = _image(12, 10)
    env = np.zeros((4, 4, 4), np.uint8)
    calls = (
        lambda: utils_2d.compute_sdf_and_gradient(img, 1.0, [0.0, 0.0]),
        lambda: utils_3d.compute_sdf(env, 0.1, [0, 0, 0]),
        lambda: utils_3d.compute_sdf_and_gradient(env, 0.1, [0, 0, 0]),
        lambda: utils_3d.compute_sdf_and_gradient_batched(env[None], 0.1, [0, 0, 0]),
        lambda: image_sdf.image_sdf(img),
        lambda: voxelize.image_to_occupancy(img),
    )
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
