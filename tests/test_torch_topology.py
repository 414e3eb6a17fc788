"""The port's map topology (``ops/topology.py``) against the JAX package's, on
the CPU.

Tolerance: bitwise everywhere. Component labels (uint32 in JAX, int64 values
in the port) and counts; the census [n, 2] and the per-component (holes,
voids); the surface, corner and exposure masks; the extrema map (float32,
inf where a walk leaves the grid); convex segment labels (on the same
float32 field in both packages); the resample's values and geometry. The
fixed-point loops (hooks and pointer jumps a round) are held bitwise to the
plain loop, one neighbour step a round (the JAX loop's step), both checked
on the host every ``CHECK_EVERY`` rounds. Grids are 16 x 14 x 12 (one
shape, so that JAX compiles each of its loops once).
"""
import math

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from sdf_tools_tpu.grid import (
    CollisionMap as JaxCollisionMap,
    GridMeta as JaxGridMeta,
    SdfGrid as JaxSdfGrid,
    TaggedCollisionMap as JaxTaggedCollisionMap,
    make_origin_transform as jax_origin,
)
from sdf_tools_tpu.ops import topology as jtopo
from sdf_tools_tpu_torch import CollisionMap, TaggedCollisionMap
from sdf_tools_tpu_torch.ops import edt, topology
from test_torch_render import _port_meta, _rotation


S = (16, 14, 12)  # one shape for (nearly) every case: JAX compiles its loops once a shape


def _scene(shape, seed, p):
    """A random mask thickened by one dilation: scipy-like blobs."""
    from scipy import ndimage

    rng = np.random.default_rng(seed)
    return ndimage.binary_dilation(rng.random(shape) < p)


def _placed(**parts):
    """A label grid of shape S with the named shapes at fixed places (1, 2, ...)."""
    lab = np.zeros(S, np.int64)
    for k, name in enumerate(parts.values(), start=1):
        if name == "torus":  # a 6 x 6 x 2 ring around a 2 x 2 hole through z
            lab[1:7, 1:7, 1:3] = k
            lab[3:5, 3:5, 1:3] = 0
        elif name == "hollow_cube":  # a 6^3 cube around a 2^3 cavity
            lab[8:14, 1:7, 2:8] = k
            lab[10:12, 3:5, 4:6] = 0
        elif name == "solid_cube":
            lab[2:6, 8:12, 6:10] = k
    return lab


# (eligible mask, key) cases: random keys, scipy-like scenes, the shapes
def _cc_cases():
    rng = np.random.default_rng(7)
    cases = {}
    for i, p in enumerate((0.3, 0.5)):
        mask = rng.random(S) < p
        cases[f"random{i}"] = (mask, mask.astype(np.int64))
    keys = rng.integers(0, 3, S)
    cases["random_keys"] = (rng.random(S) < 0.9, keys)
    for i, p in enumerate((0.02, 0.1)):
        cases[f"scene{i}"] = (np.ones(S, bool), _scene(S, i, p).astype(np.int64))
    for name in ("solid_cube", "torus", "hollow_cube"):
        cases[name] = (np.ones(S, bool), _placed(a=name))
    cases["shapes"] = (np.ones(S, bool), _placed(a="torus", b="hollow_cube", c="solid_cube"))
    mask = rng.random((1, 13, 7)) < 0.5
    cases["flat"] = (mask, mask.astype(np.int64))
    return cases


CC_CASES = _cc_cases()


@pytest.fixture(scope="module")
def jax_cc():
    """JAX's (labels, n) for every case, computed once."""
    out = {}
    for name, (elig, key) in CC_CASES.items():
        lab, n = jtopo.connected_components_by_key(jnp.asarray(elig), jnp.asarray(key, jnp.int32))
        out[name] = (np.asarray(lab).astype(np.int64), int(n))
    return out


@pytest.mark.parametrize("name", list(CC_CASES))
def test_connected_components_match_jax(name, jax_cc):
    elig, key = CC_CASES[name]
    lab, n = topology.connected_components_by_key(torch.as_tensor(elig), torch.as_tensor(key))
    want, want_n = jax_cc[name]
    assert lab.dtype == torch.int64 and n.dtype == torch.int64
    np.testing.assert_array_equal(lab.numpy(), want)
    assert int(n) == want_n


@pytest.mark.parametrize("name", ["random0", "scene0", "shapes"])
def test_connected_components_loop_equals_plain_loop(name):
    elig, key = (torch.as_tensor(a) for a in CC_CASES[name])
    plain, n0, d0 = topology.connected_components_by_key(elig, key, jump=False, diag=True)
    lab, n, d = topology.connected_components_by_key(elig, key, diag=True)
    assert torch.equal(lab, plain) and int(n) == int(n0)
    for dd in (d0, d):
        assert dd["host_checks"] == dd["rounds"] // topology.CHECK_EVERY and dd["rounds"] % topology.CHECK_EVERY == 0
    # each round's labels are at most the plain loop's: never more rounds
    assert d["rounds"] <= d0["rounds"]


def test_connected_components_from_adjacency_matches_jax():
    """An adjacency that is not a key match: cells connect along x and y
    only, where both are eligible."""
    rng = np.random.default_rng(11)
    elig = rng.random(S) < 0.7
    conn = []
    for axis, sign in topology._DIRS6:
        nb = np.asarray(jtopo._shift(jnp.asarray(elig), axis, sign, False))
        conn.append(elig & nb & (axis != 2))
    jl, jn = jtopo.connected_components_from_adjacency(jnp.asarray(elig), [jnp.asarray(c) for c in conn])
    lab, n = topology.connected_components_from_adjacency(torch.as_tensor(elig), [torch.as_tensor(c) for c in conn])
    np.testing.assert_array_equal(lab.numpy(), np.asarray(jl).astype(np.int64))
    assert int(n) == int(jn)


def test_update_connected_components_matches_jax():
    occ = np.zeros(S, np.float32)
    occ[1:3, 1:3, :] = 1.0
    occ[5:7, 5:7, :] = 1.0
    occ[0, 7, 1] = 0.5
    jmeta = JaxGridMeta.create(jax_origin([0.0, 0.0, 0.0]), 0.1, occ.shape)
    jmap, jn = jtopo.update_connected_components(JaxCollisionMap.create(occ, jmeta))
    cmap, n = topology.update_connected_components(CollisionMap.create(occ, _port_meta(jmeta)))
    assert cmap.components_valid and jmap.components_valid
    np.testing.assert_array_equal(cmap.component.numpy(), np.asarray(jmap.component).astype(np.int64))
    assert int(n) == int(jn) == 3


# ---- surfaces and corners ----------------------------------------------------


def _label_grids():
    rng = np.random.default_rng(5)
    return [rng.integers(0, 3, S), np.ones(S, np.int64), _placed(a="solid_cube"), CC_CASES["scene1"][1]]


@pytest.mark.parametrize("i", range(4))
def test_surface_and_corner_masks_match_jax(i):
    lab = _label_grids()[i]
    got = topology.surface_mask_26(torch.as_tensor(lab > 0))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jtopo.surface_mask_26(jnp.asarray(lab > 0))))
    got = topology.component_surface_mask(torch.as_tensor(lab))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jtopo.component_surface_mask(jnp.asarray(lab, jnp.int32))))
    got = topology.candidate_corner_mask(torch.as_tensor(lab))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jtopo.candidate_corner_mask(jnp.asarray(lab, jnp.int32))))


@pytest.mark.parametrize("shape", ["shapes", "random1"])
def test_vertex_edge_exposure_matches_jax(shape, jax_cc):
    lab = jax_cc[shape][0]
    for c in (1, 2):
        got = topology.vertex_edge_exposure(torch.as_tensor(lab), c)
        want = jtopo.vertex_edge_exposure(jnp.asarray(lab, jnp.uint32), c)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---- holes / voids ------------------------------------------------------------


# a cell of each placed shape
SHAPE_CELLS = {"torus": (1, 1, 1), "hollow_cube": (8, 1, 2), "solid_cube": (2, 8, 6)}


@pytest.mark.parametrize("name,want", [("solid_cube", (0, 0)), ("torus", (1, 0)), ("hollow_cube", (0, 1))])
def test_holes_and_voids_of_the_shapes(name, want, jax_cc):
    """The shapes alone, among the free space's components (the hollow
    cube's cavity is one of its own)."""
    lab, n = jax_cc[name]
    c = int(lab[SHAPE_CELLS[name]])
    t = torch.as_tensor(lab)
    assert tuple(int(v) for v in topology.component_holes_and_voids(t, c)) == want
    assert tuple(topology.component_topology_census(t, n)[c - 1].tolist()) == want


# the census against JAX: the labels of these cases, the first CENSUS_N
# components (n_bound 8 in JAX for all: one compile)
CENSUS_CASES = ("random1", "scene1", "shapes")
CENSUS_N = 8


@pytest.fixture(scope="module")
def jax_census(jax_cc):
    out = {}
    for name in CENSUS_CASES:
        lab, n = jax_cc[name]
        m = min(n, CENSUS_N)
        out[name] = m, np.asarray(jtopo.component_topology_census(jnp.asarray(lab, jnp.uint32), m))
    return out


@pytest.mark.parametrize("name", CENSUS_CASES)
def test_census_matches_jax(name, jax_cc, jax_census):
    lab, n = jax_cc[name]
    m, want = jax_census[name]
    t = torch.as_tensor(lab)
    got = topology.component_topology_census(t, m)
    assert got.dtype == torch.int64 and got.shape == (m, 2)
    np.testing.assert_array_equal(got.numpy(), want)
    host = topology.compute_component_topology(t, m)
    assert host.dtype == np.int32
    np.testing.assert_array_equal(host, want)
    # all n components; the first m of them as above
    full = topology.component_topology_census(t, n)
    assert full.shape == (n, 2) and torch.equal(full[:m], got)
    assert topology.component_topology_census(t, 0).shape == (0, 2)
    if name == "shapes":  # free space, torus, solid cube, hollow cube, its cavity
        assert full.tolist()[1:] == [[1, 0], [0, 0], [0, 1], [0, 0]]


@pytest.mark.parametrize("chunk", [1, 7, 64])
@pytest.mark.parametrize("name", CENSUS_CASES)
def test_census_in_vertex_chunks_matches_jax(name, chunk, jax_census, jax_cc, monkeypatch):
    """The slot-sharing step taken a few vertices at a time (a chunk of 7
    splits the grid's rows unevenly) gives JAX's census."""
    lab, _ = jax_cc[name]
    m, want = jax_census[name]
    monkeypatch.setattr(topology, "_SHARE_CHUNK", chunk)
    np.testing.assert_array_equal(topology.component_topology_census(torch.as_tensor(lab), m).numpy(), want)


@pytest.mark.parametrize("name", CENSUS_CASES)
def test_holes_and_voids_match_jax_per_component(name, jax_cc, jax_census):
    lab, n = jax_cc[name]
    m, census = jax_census[name]
    jl = jnp.asarray(lab, jnp.uint32)
    for c in sorted({1, m, (m + 1) // 2}):
        want = tuple(int(v) for v in jtopo.component_holes_and_voids(jl, jnp.int32(c)))
        got = topology.component_holes_and_voids(torch.as_tensor(lab), c)
        assert tuple(int(v) for v in got) == want == tuple(census[c - 1]), c


@pytest.mark.parametrize("name", ["random0", "scene0", "shapes"])
def test_census_loops_equal_plain_loops(name, jax_cc):
    lab, n = jax_cc[name]
    t = torch.as_tensor(lab)
    plain, d0 = topology.component_topology_census(t, n, jump=False, diag=True)
    got, d = topology.component_topology_census(t, n, diag=True)
    assert torch.equal(got, plain)
    assert d0["host_checks"] == d0["rounds"] // topology.CHECK_EVERY and d["rounds"] <= d0["rounds"]
    for c in (1, n):
        *hv0, e0 = topology.component_holes_and_voids(t, c, jump=False, diag=True)
        *hv, e = topology.component_holes_and_voids(t, c, diag=True)
        assert [int(v) for v in hv] == [int(v) for v in hv0] and e["rounds"] <= e0["rounds"]


# ---- local extrema, convex segments, resample ---------------------------------


def _field_pair(mask, res=0.1, rotated=False, border=False):
    """(JAX SdfGrid, the port's SdfGrid) over the same float32 field of
    ``mask`` (the port's exact field, which equals the JAX package's:
    tests/test_torch_collision_map.py)."""
    origin = jax_origin([0.2, -0.1, 0.05], _rotation(25.0, 2) if rotated else None)
    jmeta = JaxGridMeta.create(origin, res, mask.shape)
    sdf, _ = edt.extract_signed_distance_field(torch.as_tensor(mask), _port_meta(jmeta), math.inf, border, "plain")
    return JaxSdfGrid.create(jnp.asarray(sdf.values.numpy()), jmeta, np.inf), sdf


def _sphere_mask(r=5):
    c = np.array([7.5, 6.5, 5.5])
    return ((np.indices(S).transpose(1, 2, 3, 0) - c) ** 2).sum(-1) <= r * r


@pytest.mark.parametrize("case", ["sphere", "scene", "scene_rotated", "one_cell"])
def test_local_extrema_map_matches_jax(case):
    if case == "sphere":
        mask, rotated = _sphere_mask(), False
    elif case == "one_cell":
        mask, rotated = np.zeros(S, bool), False
        mask[2, 2, 1] = True
    else:
        mask, rotated = _scene(S, 3, 0.02), case == "scene_rotated"
    jsdf, sdf = _field_pair(mask, rotated=rotated)
    got = topology.local_extrema_map(sdf)
    want = np.asarray(jtopo.local_extrema_map(jsdf))
    assert got.shape == want.shape == mask.shape + (3,)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want.view(np.uint32))
    assert np.isinf(want).any() or case == "sphere"


def _tagged_pair(rotated=False):
    occ = np.zeros(S, np.float32)
    obj = np.zeros(occ.shape, np.uint32)
    occ[2:5, 2:5, 1:4] = 1.0
    obj[2:5, 2:5, 1:4] = 1
    occ[10:13, 9:13, 1:3] = 1.0
    obj[10:13, 9:13, 1:3] = 2
    occ[6:8, 11:14, 2:5] = 1.0  # unnamed
    occ[0:3, 11:14, 0] = 0.5
    origin = jax_origin([0.2, -0.1, 0.05], _rotation(25.0, 2) if rotated else None)
    jmeta = JaxGridMeta.create(origin, 0.1, occ.shape)
    return JaxTaggedCollisionMap.create(occ, obj, jmeta), TaggedCollisionMap.create(occ, obj, _port_meta(jmeta))


@pytest.mark.parametrize("threshold", [0.15, 0.3, 1.0])
@pytest.mark.parametrize("rotated", [False, True])
def test_convex_segments_match_jax(threshold, rotated):
    jtmap, tmap = _tagged_pair(rotated=rotated)
    jsdf, sdf = _field_pair(np.asarray(jtmap.occupancy) > 0.5, rotated=rotated, border=True)
    jseg, jn = jtopo.convex_segments(jtmap, jsdf, connected_threshold=threshold)
    seg, n = topology.convex_segments(tmap, sdf, threshold)
    np.testing.assert_array_equal(seg.numpy(), np.asarray(jseg).astype(np.int64))
    assert int(n) == int(jn) >= 2
    plain, n0 = topology.convex_segments(tmap, sdf, threshold, jump=False)
    assert torch.equal(seg, plain) and int(n0) == int(n)


@pytest.mark.parametrize("new_res,rotated", [(0.05, False), (0.07, True), (0.3, True)])
def test_resample_nearest_matches_jax(new_res, rotated):
    vals = np.random.default_rng(2).random((6, 5, 7)).astype(np.float32)
    origin = jax_origin([0.2, -0.1, 0.05], _rotation(25.0, 2) if rotated else None)
    jmeta = JaxGridMeta.create(origin, 0.1, vals.shape)
    jout, jnew = jtopo.resample_nearest(jnp.asarray(vals), jmeta, new_res)
    out, new = topology.resample_nearest(torch.as_tensor(vals), _port_meta(jmeta), new_res)
    assert new.shape == jnew.shape and out.shape == jout.shape
    np.testing.assert_array_equal(out.numpy().view(np.uint32), np.asarray(jout).view(np.uint32))
    np.testing.assert_array_equal(new.origin_transform.numpy(), np.asarray(jnew.origin_transform))
    assert new.resolution_float == float(jnew.resolution)
    labels = torch.as_tensor(np.arange(vals.size, dtype=np.int64).reshape(vals.shape) + 2**32 - vals.size)
    lab, _ = topology.resample_nearest(labels, _port_meta(jmeta), new_res)
    assert lab.dtype == torch.int64 and int(lab.max()) <= 2**32 - 1  # uint32 values, unwrapped
