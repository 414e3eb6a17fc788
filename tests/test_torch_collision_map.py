"""The port's collision-map types and their SDF extraction against the JAX
package, on the CPU.

``CollisionMap`` / ``TaggedCollisionMap`` (built by ``create`` and carried
across by ``convert``), ``filled_mask`` and the five EDT-side functions of
``collision_map_ops`` against the JAX package's with ``backend="stencil"``
(its exact XLA EDT on the CPU; the port's ``"auto"`` runs the kernels'
plain versions here). The topology half (components, component surfaces
and their host maps, the holes/voids census, the resamples, convex
segments) against the JAX package's on the demo maps and random ones.
Tolerance: bitwise everywhere (masks, uint32 labels as int64 values, signed
fields and their extrema, index lists, counts).
"""
import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from sdf_tools_tpu import collision_map_ops as jcmo
from sdf_tools_tpu.grid import (
    CollisionMap as JaxCollisionMap,
    GridMeta as JaxGridMeta,
    TaggedCollisionMap as JaxTaggedCollisionMap,
    make_origin_transform as jax_origin,
)
from sdf_tools_tpu_torch import CollisionMap, TaggedCollisionMap, collision_map_ops as cmo, convert
from test_torch_render import _port_meta, _rotation


def _same(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if want.dtype == np.float32:
        assert got.dtype == np.float32
        got, want = got.view(np.uint32), want.view(np.uint32)
    np.testing.assert_array_equal(got, want)


def _same_sdf(got, want):
    (sdf, ext), (jsdf, jext) = got, want
    _same(sdf.values, jsdf.values)
    _same(sdf.oob_value, jsdf.oob_value)
    for g, w in zip(ext, jext):
        _same(g, w)


def _meta(shape, res=0.1, rotated=False):
    rot = _rotation(25.0, 2) if rotated else None
    jmeta = JaxGridMeta.create(jax_origin([0.2, -0.1, 0.05], rot), res, shape)
    return jmeta, _port_meta(jmeta)


def _demo_maps(rotated=False):
    """``tests/test_api.py``'s demo map: two boxes, plus an unknown (0.5)
    slab and a free border; JAX and port copies."""
    occ = np.zeros((10, 10, 4), np.float32)
    occ[2:5, 2:5, 1:3] = 1.0
    occ[7:9, 7:9, 1:3] = 1.0
    occ[0:2, 5:9, :] = 0.5
    jmeta, meta = _meta(occ.shape, rotated=rotated)
    return JaxCollisionMap.create(occ, jmeta, oob_occupancy=-10000.0), CollisionMap.create(occ, meta, -10000.0)


def _random_occupancy(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.choice(np.array([0.0, 0.5, 1.0, 0.2, 0.9], np.float32), shape, p=[0.6, 0.08, 0.2, 0.06, 0.06])


def _tagged_maps(shape=(12, 12, 4), seed=None):
    """``tests/test_api.py``'s demo tagged map (objects 1 and 2), with an
    unnamed obstacle, a filled cell of an id above 2^31, and unknown cells;
    or a random one with ids 0-5 and a large id."""
    if seed is None:
        occ = np.zeros(shape, np.float32)
        obj = np.zeros(shape, np.uint32)
        occ[2:5, 2:5, 1:3] = 1.0
        obj[2:5, 2:5, 1:3] = 1
        occ[8:11, 8:11, 1:3] = 1.0
        obj[8:11, 8:11, 1:3] = 2
        occ[5:7, 0:2, 1:3] = 1.0  # unnamed
        occ[0, 11, 0] = 1.0
        obj[0, 11, 0] = 4_000_000_000
        occ[6:8, 6:8, 0] = 0.5
        obj[6, 6, 0] = 2
    else:
        rng = np.random.default_rng(seed)
        occ = _random_occupancy(shape, seed)
        obj = rng.choice(np.array([0, 1, 2, 3, 5, 4_000_000_000], np.uint32), shape)
    jmeta, meta = _meta(shape, rotated=seed is not None)
    return JaxTaggedCollisionMap.create(occ, obj, jmeta), TaggedCollisionMap.create(occ, obj, meta)


def test_collision_map_create_and_convert():
    occ = _random_occupancy((6, 5, 4), 0)
    comp = np.random.default_rng(1).integers(0, 2**32, occ.shape, dtype=np.uint64).astype(np.uint32)
    jmeta, meta = _meta(occ.shape, rotated=True)
    jmap = JaxCollisionMap.create(occ, jmeta, 0.5, component=comp)
    cmap = CollisionMap.create(occ, meta, 0.5, component=comp)
    carried = convert.collision_map_from_numpy(np.asarray(jmap.occupancy), np.asarray(jmap.component), meta,
                                              np.asarray(jmap.oob_occupancy), jmap.components_valid)
    for m in (cmap, carried):
        assert m.component.dtype == torch.int64 and m.shape == jmap.shape and m.components_valid is False
        _same(m.occupancy, jmap.occupancy)
        np.testing.assert_array_equal(m.component.numpy(), np.asarray(jmap.component).astype(np.int64))
        _same(m.oob_occupancy, jmap.oob_occupancy)
        _same(m.resolution, jmap.resolution)
    assert (cmap.component.numpy() > 2**31).any()  # uint32 values above int32's range kept
    assert CollisionMap.create(occ, meta).component.eq(0).all()


def test_tagged_map_create_and_convert():
    jtmap, tmap = _tagged_maps(seed=2)
    jtmap = dataclasses.replace(jtmap, convex_segment=jnp.asarray(np.asarray(jtmap.object_id) + np.uint32(7)),
                                convex_segments_valid=True)
    carried = convert.tagged_collision_map_from_numpy(
        np.asarray(jtmap.occupancy), np.asarray(jtmap.component), np.asarray(jtmap.object_id),
        np.asarray(jtmap.convex_segment), tmap.meta, np.asarray(jtmap.oob_occupancy),
        jtmap.components_valid, jtmap.convex_segments_valid,
    )
    for m, jm in ((tmap, dataclasses.replace(jtmap, convex_segment=jnp.zeros(jtmap.shape, jnp.uint32))), (carried, jtmap)):
        assert m.shape == jm.shape
        _same(m.occupancy, jm.occupancy)
        for field in ("component", "object_id", "convex_segment"):
            got = getattr(m, field)
            assert got.dtype == torch.int64
            np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(jm, field)).astype(np.int64))
    assert carried.convex_segments_valid and not tmap.convex_segments_valid
    assert (np.asarray(jtmap.convex_segment) == 4_000_000_007).any()  # a uint32 value past int32 carried


@pytest.mark.parametrize("unknown_is_filled", [False, True])
def test_filled_mask_matches_jax(unknown_is_filled):
    jmap, cmap = _demo_maps()
    _same(cmap.filled_mask(unknown_is_filled), jmap.filled_mask(unknown_is_filled))
    jtmap, tmap = _tagged_maps(seed=3)
    _same(tmap.filled_mask(unknown_is_filled), jtmap.filled_mask(unknown_is_filled))


@pytest.mark.parametrize("border", [False, True], ids=["plain", "virtual_border"])
@pytest.mark.parametrize("unknown_is_filled", [False, True], ids=["unknown_free", "unknown_filled"])
@pytest.mark.parametrize("which", ["demo", "random"])
def test_extract_sdf_matches_jax(which, unknown_is_filled, border):
    if which == "demo":
        jmap, cmap = _demo_maps(rotated=True)
    else:
        occ = _random_occupancy((20, 16, 12), 4)
        jmeta, meta = _meta(occ.shape)
        jmap, cmap = JaxCollisionMap.create(occ, jmeta), CollisionMap.create(occ, meta)
    got = cmo.extract_sdf(cmap, -10000.0, unknown_is_filled, border)
    want = jcmo.extract_sdf(jmap, -10000.0, unknown_is_filled, border, backend="stencil")
    _same_sdf(got, want)


def test_extract_sdf_unknown_only_map():
    """All cells unknown: nothing filled (+inf everywhere) unless unknown
    counts as filled (everything negative); ``tests/test_api.py``'s case."""
    occ = np.full((6, 6, 2), 0.5, np.float32)
    jmeta, meta = _meta(occ.shape)
    jmap, cmap = JaxCollisionMap.create(occ, jmeta), CollisionMap.create(occ, meta)
    for unknown_is_filled in (False, True):
        got = cmo.extract_sdf(cmap, unknown_is_filled=unknown_is_filled)
        _same_sdf(got, jcmo.extract_sdf(jmap, unknown_is_filled=unknown_is_filled, backend="stencil"))
    assert torch.isinf(cmo.extract_sdf(cmap)[0].values).all()
    assert (cmo.extract_sdf(cmap, unknown_is_filled=True)[0].values < 0).all()


@pytest.mark.parametrize("objects", [(), (1,), (2, 5), (7,), (4_000_000_000,)], ids=str)
@pytest.mark.parametrize("seed", [None, 5], ids=["demo", "random"])
def test_tagged_filled_mask_and_sdf_match_jax(seed, objects):
    jtmap, tmap = _tagged_maps((14, 12, 6) if seed else (12, 12, 4), seed=seed)
    for unknown_is_filled in (False, True):
        _same(cmo.tagged_filled_mask(tmap, objects, unknown_is_filled),
              jcmo.tagged_filled_mask(jtmap, objects, unknown_is_filled))
    for unknown_is_filled, border in ((False, False), (True, True)):
        got = cmo.extract_tagged_sdf(tmap, 5.0, objects, unknown_is_filled, border)
        _same_sdf(got, jcmo.extract_tagged_sdf(jtmap, 5.0, objects, unknown_is_filled, border, backend="stencil"))


@pytest.mark.parametrize("unknown_is_filled", [True, False])
@pytest.mark.parametrize("seed", [None, 6], ids=["demo", "random"])
def test_free_and_named_objects_sdf_matches_jax(seed, unknown_is_filled):
    jtmap, tmap = _tagged_maps((14, 12, 6) if seed else (12, 12, 4), seed=seed)
    got = cmo.extract_free_and_named_objects_sdf(tmap, -1.0, unknown_is_filled)
    _same_sdf(got, jcmo.extract_free_and_named_objects_sdf(jtmap, -1.0, unknown_is_filled, backend="stencil"))
    if seed is None:
        v = got[0].values
        assert v[5, 0, 1] == 0.0 and v[3, 3, 1] < 0  # unnamed interior 0, named interior negative


@pytest.mark.parametrize("ids", [None, [2, 1, 9]], ids=["all", "listed"])
def test_make_object_sdfs_matches_jax(ids):
    jtmap, tmap = _tagged_maps(seed=None)
    got = cmo.make_object_sdfs(tmap, ids, unknown_is_filled=True)
    want = jcmo.make_object_sdfs(jtmap, ids, unknown_is_filled=True, backend="stencil")
    assert list(got) == list(want)
    if ids is None:
        assert list(got) == [1, 2, 4_000_000_000]
    for oid in want:
        _same(got[oid].values, want[oid].values)


@pytest.fixture(scope="module")
def tutorial():
    """BASELINE config #2: the 64^3 tutorial map (res 0.25, two boxes); the
    JAX package's field computed once."""
    n, res = 64, 0.25
    occ = np.zeros((n, n, n), np.float32)
    occ[8:24, 8:24, 8:24] = 1.0
    occ[40:56, 32:48, 8:40] = 1.0
    jmeta, meta = _meta(occ.shape, res)
    jmap = JaxCollisionMap.create(occ, jmeta)
    return jcmo.extract_sdf(jmap, backend="stencil"), CollisionMap.create(occ, meta)


def test_tutorial_map_matches_jax(tutorial):
    want, cmap = tutorial
    _same_sdf(cmo.extract_sdf(cmap), want)


# ---- the topology half of collision_map_ops ----------------------------------


def _labelled_maps(which):
    """(JAX map, the port's map) with their components, each package's own."""
    if which == "demo":
        jmap, cmap = _demo_maps(rotated=True)
    else:
        occ = _random_occupancy((12, 12, 4), 8)
        jmeta, meta = _meta(occ.shape)
        jmap, cmap = JaxCollisionMap.create(occ, jmeta), CollisionMap.create(occ, meta)
    (jmap, jn), (cmap, n) = jcmo.update_connected_components(jmap), cmo.update_connected_components(cmap)
    return jmap, jn, cmap, n


def _same_index_lists(got, want):
    assert list(got) == [int(k) for k in want]
    for k, v in want.items():
        np.testing.assert_array_equal(got[int(k)], v)


@pytest.mark.parametrize("which", ["demo", "random"])
def test_update_connected_components_and_views_match_jax(which):
    jmap, jn, cmap, n = _labelled_maps(which)
    assert cmap.components_valid and int(n) == int(jn)
    _same(cmap.component, np.asarray(jmap.component).astype(np.int64))
    _same_index_lists(cmo.extract_connected_components(cmap), jcmo.extract_connected_components(jmap))
    for types in ("filled", "empty", "unknown", "all"):
        _same(cmo.extract_component_surfaces(cmap, types), jcmo.extract_component_surfaces(jmap, types))
        _same_index_lists(cmo.extract_component_surfaces_map(cmap, types),
                          jcmo.extract_component_surfaces_map(jmap, types))
    with pytest.raises(ValueError):
        cmo.extract_component_surfaces(cmap, "solid")
    unlabelled = CollisionMap.create(cmap.occupancy, cmap.meta)
    _same_index_lists(cmo.extract_connected_components(unlabelled),
                      jcmo.extract_connected_components(JaxCollisionMap.create(np.asarray(jmap.occupancy), jmap.meta)))


@pytest.mark.parametrize("recompute", [True, False])
def test_compute_component_topology_matches_jax(recompute):
    jmap, _, cmap, _ = _labelled_maps("demo")
    got = cmo.compute_component_topology(cmap, recompute)
    want = jcmo.compute_component_topology(jmap, recompute)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("new_res", [0.05, 0.23])
def test_resample_matches_jax(new_res):
    jmap, _, cmap, _ = _labelled_maps("demo")
    cmap = dataclasses.replace(cmap, component=cmap.component + (2**32 - 16))  # uint32 values past 2^31
    jmap = dataclasses.replace(jmap, component=jmap.component + np.uint32(2**32 - 16))
    got, want = cmo.resample(cmap, new_res), jcmo.resample(jmap, new_res)
    assert got.shape == want.shape and not got.components_valid
    _same(got.occupancy, want.occupancy)
    _same(got.component, np.asarray(want.component).astype(np.int64))
    _same(got.oob_occupancy, want.oob_occupancy)
    jtmap, tmap = _tagged_maps(seed=None)
    tmap = dataclasses.replace(tmap, convex_segment=tmap.object_id + 3)
    jtmap = dataclasses.replace(jtmap, convex_segment=jtmap.object_id + np.uint32(3))
    got, want = cmo.resample_tagged(tmap, new_res), jcmo.resample_tagged(jtmap, new_res)
    assert got.shape == want.shape
    _same(got.occupancy, want.occupancy)
    for field in ("component", "object_id", "convex_segment"):
        _same(getattr(got, field), np.asarray(getattr(want, field)).astype(np.int64))


@pytest.mark.parametrize("seed", [None, 9], ids=["demo", "random"])
def test_tagged_components_and_surfaces_match_jax(seed):
    jtmap, tmap = _tagged_maps((14, 12, 6) if seed else (12, 12, 4), seed=seed)
    (jtmap, jn), (tmap, n) = jcmo.update_tagged_connected_components(jtmap), cmo.update_tagged_connected_components(tmap)
    assert tmap.components_valid and int(n) == int(jn)
    _same(tmap.component, np.asarray(jtmap.component).astype(np.int64))
    for types in ("filled", "empty", "unknown", "all"):
        _same(cmo.extract_tagged_component_surfaces(tmap, types), jcmo.extract_tagged_component_surfaces(jtmap, types))
        _same_index_lists(cmo.extract_tagged_component_surfaces_map(tmap, types),
                          jcmo.extract_tagged_component_surfaces_map(jtmap, types))


@pytest.mark.parametrize("border", [False, True], ids=["free_and_named", "virtual_border"])
@pytest.mark.parametrize("seed", [None, 10], ids=["demo", "random"])
def test_update_convex_segments_matches_jax(seed, border):
    jtmap, tmap = _tagged_maps((14, 12, 6) if seed else (12, 12, 4), seed=seed)
    got, n = cmo.update_convex_segments(tmap, 0.25, add_virtual_border=border)
    want, jn = jcmo.update_convex_segments(jtmap, 0.25, add_virtual_border=border, backend="stencil")
    assert got.convex_segments_valid and int(n) == int(jn) >= 1
    _same(got.convex_segment, np.asarray(want.convex_segment).astype(np.int64))
