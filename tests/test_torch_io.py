"""The port's ``io`` against the JAX package's, on the CPU.

Bytes: the serializations (SDFR/SDFZ, CMGR/CMGZ, TCMR/TCMZ files, the
message blobs and the ROS-framed messages) equal the JAX package's byte for
byte for the same grid, on an identity and a rotated origin (the port's own
``GridMeta.create`` and one carried across by ``convert``). Loads: a file
written by either package loads in the other bitwise (values, labels,
geometry, flags), checkpoints (``.npz``, whose zip entries carry
timestamps, so only the loads are compared) included. Labels of 2^32 - 1
survive; -1 and 2^32 raise ``ValueError`` on save; a bad magic raises on
load; the loads default to CUDA and raise without it. ``native.compress``
equals the JAX package's where both native libraries load.
"""
import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from sdf_tools_tpu import io as jio, native as jnative
from sdf_tools_tpu.grid import (
    CollisionMap as JaxCollisionMap,
    GridMeta as JaxGridMeta,
    SdfGrid as JaxSdfGrid,
    TaggedCollisionMap as JaxTaggedCollisionMap,
    make_origin_transform as jax_origin,
)
from sdf_tools_tpu_torch import CollisionMap, GridMeta, SdfGrid, TaggedCollisionMap, io, native
from test_torch_render import _port_meta, _rotation

SHAPE = (9, 7, 5)
U32_MAX = 2**32 - 1


def _metas(rotated: bool, own: bool):
    rot = _rotation(25.0, 2) @ _rotation(-10.0, 0) if rotated else None
    origin = jax_origin([0.2, -0.1, 0.05], rot)
    jmeta = JaxGridMeta.create(origin, 0.07, SHAPE, "map_frame")
    meta = GridMeta.create(np.array(origin), 0.07, SHAPE, "map_frame", device="cpu") if own else _port_meta(jmeta)
    if not own:
        meta = dataclasses.replace(meta, frame="map_frame")
    return jmeta, meta


def _fields(seed=0):
    rng = np.random.default_rng(seed)
    values = rng.standard_normal(SHAPE).astype(np.float32)
    occ = rng.choice(np.array([0.0, 0.5, 1.0, 0.25], np.float32), SHAPE)
    labels = [rng.integers(0, 2**32, SHAPE, dtype=np.uint64).astype(np.uint32) for _ in range(3)]
    for lab in labels:
        lab.reshape(-1)[:2] = (0, U32_MAX)
    return values, occ, labels


def _grids(kind: str, rotated: bool = True, own: bool = True):
    """(JAX grid, the port's grid) of one kind over the same numbers."""
    jmeta, meta = _metas(rotated, own)
    values, occ, (comp, obj, seg) = _fields()
    if kind == "sdf":
        return JaxSdfGrid.create(jnp.asarray(values), jmeta, 1e3), SdfGrid.create(values, meta, 1e3)
    if kind == "cmap":
        j = dataclasses.replace(JaxCollisionMap.create(occ, jmeta, -3.5, component=comp), components_valid=True)
        p = dataclasses.replace(CollisionMap.create(occ, meta, -3.5, component=comp), components_valid=True)
        return j, p
    j = JaxTaggedCollisionMap.create(occ, obj, jmeta, 0.75)
    j = dataclasses.replace(j, component=jnp.asarray(comp), convex_segment=jnp.asarray(seg), components_valid=True)
    p = TaggedCollisionMap.create(occ, obj, meta, 0.75)
    p = dataclasses.replace(p, component=torch.as_tensor(comp.astype(np.int64)),
                            convex_segment=torch.as_tensor(seg.astype(np.int64)), components_valid=True,
                            convex_segments_valid=True)
    j = dataclasses.replace(j, convex_segments_valid=True)
    return j, p


KINDS = ("sdf", "cmap", "tmap")
SERIALIZE = {
    "sdf": (io.serialize_sdf, jio.serialize_sdf),
    "cmap": (lambda g: io.serialize_collision_map(g, 17), lambda g: jio.serialize_collision_map(g, 17)),
    "tmap": (io.serialize_tagged_map, jio.serialize_tagged_map),
}
SAVE = {
    "sdf": (io.save_sdf, jio.save_sdf, io.load_sdf, jio.load_sdf),
    "cmap": (io.save_collision_map, jio.save_collision_map, io.load_collision_map, jio.load_collision_map),
    "tmap": (io.save_tagged_map, jio.save_tagged_map, io.load_tagged_map, jio.load_tagged_map),
}
MESSAGE = {
    "sdf": (io.sdf_message_blob, jio.sdf_message_blob, io.sdf_message, jio.sdf_message, io.sdf_from_message),
    "cmap": (io.collision_map_message_blob, jio.collision_map_message_blob, io.collision_map_message,
             jio.collision_map_message, io.collision_map_from_message),
    "tmap": (io.tagged_map_message_blob, jio.tagged_map_message_blob, io.tagged_map_message,
             jio.tagged_map_message, io.tagged_map_from_message),
}
LABELS = {"sdf": (), "cmap": ("component",), "tmap": ("component", "object_id", "convex_segment")}


def _same_grid(port, jax_grid, kind):
    """The port's grid equals the JAX grid bitwise: fields, geometry, flags."""
    def bits(t, j):
        np.testing.assert_array_equal(np.asarray(t.cpu()).view(np.uint32), np.asarray(j, np.float32).view(np.uint32))

    meta, jmeta = port.meta, jax_grid.meta
    assert meta.shape == tuple(jmeta.shape) and meta.frame == jmeta.frame
    bits(meta.origin_transform, jmeta.origin_transform)
    bits(meta.inv_origin_transform, jmeta.inv_origin_transform)
    assert meta.resolution_float == float(jmeta.resolution)
    if kind == "sdf":
        bits(port.values, jax_grid.values)
        bits(port.oob_value, jax_grid.oob_value)
        return
    bits(port.occupancy, jax_grid.occupancy)
    bits(port.oob_occupancy, jax_grid.oob_occupancy)
    for f in LABELS[kind]:
        got = getattr(port, f)
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(jax_grid, f)).astype(np.int64))
    assert port.components_valid == jax_grid.components_valid
    if kind == "tmap":
        assert port.convex_segments_valid == jax_grid.convex_segments_valid


@pytest.mark.parametrize("own", [True, False], ids=["create", "convert"])
@pytest.mark.parametrize("rotated", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_serialized_bytes_match_jax(kind, rotated, own):
    jg, g = _grids(kind, rotated, own)
    ours, theirs = SERIALIZE[kind]
    body = ours(g)
    assert isinstance(body, bytes) and body == theirs(jg)


@pytest.mark.parametrize("compress", [True, False], ids=["Z", "R"])
@pytest.mark.parametrize("kind", KINDS)
def test_files_match_jax_and_load_across(kind, compress, tmp_path):
    jg, g = _grids(kind)
    save, jsave, load, jload = SAVE[kind]
    ours, theirs = tmp_path / "port.bin", tmp_path / "jax.bin"
    save(g, str(ours), compress=compress)
    jsave(jg, str(theirs), compress=compress)
    assert ours.read_bytes() == theirs.read_bytes()
    assert ours.read_bytes()[3:4] == (b"Z" if compress else b"R")
    _same_grid(load(str(theirs), device="cpu"), jg, kind)  # JAX -> port
    _same_grid(g, jload(str(ours)), kind)  # port -> JAX


@pytest.mark.parametrize("kind", KINDS)
def test_messages_match_jax_and_load_across(kind):
    jg, g = _grids(kind)
    blob, jblob, message, jmessage, from_message = MESSAGE[kind]
    assert blob(g) == jblob(jg)
    framed = message(g, stamp=(12, 34), seq=5)
    assert framed == jmessage(jg, stamp=(12, 34), seq=5)
    payload, frame, compressed = io.unframe_ros_message(framed)
    assert (payload, frame, compressed) == jio.unframe_ros_message(framed)
    assert frame == "map_frame" and compressed and payload == blob(g)
    _same_grid(from_message(framed, device="cpu"), jg, kind)
    raw = io.frame_ros_message(SERIALIZE[kind][0](g), frame, is_compressed=False)
    assert raw == jio.frame_ros_message(SERIALIZE[kind][1](jg), frame, is_compressed=False)
    with pytest.raises(ValueError, match="trailing"):
        io.unframe_ros_message(framed + b"\0")


@pytest.mark.parametrize("kind", KINDS)
def test_checkpoints_load_across(kind, tmp_path):
    jg, g = _grids(kind)
    io.save_checkpoint(str(tmp_path / "port.npz"), g)
    jio.save_checkpoint(str(tmp_path / "jax.npz"), jg)
    _same_grid(io.load_checkpoint(str(tmp_path / "jax.npz"), device="cpu"), jg, kind)
    _same_grid(g, jio.load_checkpoint(str(tmp_path / "port.npz")), kind)
    _same_grid(io.load_checkpoint(str(tmp_path / "port.npz"), device="cpu"), jg, kind)


@pytest.mark.parametrize("bad", [-1, 2**32])
@pytest.mark.parametrize("kind,field", [("cmap", "component"), ("tmap", "object_id"), ("tmap", "convex_segment")])
def test_labels_outside_uint32_raise(kind, field, bad, tmp_path):
    _, g = _grids(kind)
    lab = getattr(g, field).clone()
    lab[1, 2, 3] = bad
    g = dataclasses.replace(g, **{field: lab})
    with pytest.raises(ValueError, match="uint32"):
        SERIALIZE[kind][0](g)
    with pytest.raises(ValueError, match="uint32"):
        io.save_checkpoint(str(tmp_path / "x.npz"), g)


@pytest.mark.parametrize("kind", KINDS)
def test_bad_magic_raises(kind, tmp_path):
    _, g = _grids(kind)
    save, _, load, _ = SAVE[kind]
    path = tmp_path / "f.bin"
    save(g, str(path))
    data = path.read_bytes()
    path.write_bytes(b"XXXX" + data[4:])
    with pytest.raises(ValueError, match="header"):
        load(str(path), device="cpu")
    other = {"sdf": b"CMGZ", "cmap": b"TCMZ", "tmap": b"SDFZ"}[kind]
    path.write_bytes(other + data[4:])
    with pytest.raises(ValueError, match="header"):
        load(str(path), device="cpu")


def test_truncated_body_raises():
    _, g = _grids("tmap")
    body = io.serialize_tagged_map(g)
    with pytest.raises(ValueError, match="truncated"):
        io.deserialize_tagged_map(body[:1000], device="cpu")


def test_loads_default_to_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, g = _grids("sdf")
    io.save_sdf(g, str(tmp_path / "f.sdf"))
    for load in (io.load_sdf, io.load_checkpoint):
        with pytest.raises(RuntimeError, match="CUDA"):
            load(str(tmp_path / "f.sdf"))
    with pytest.raises(RuntimeError, match="CUDA"):
        io.sdf_from_message(io.sdf_message(g))


def test_native_compress_matches_jax():
    assert native.available() and jnative.available()
    data = io.serialize_tagged_map(_grids("tmap")[1])
    packed = native.compress(data)
    assert packed == jnative.compress(data)
    assert native.decompress(packed, len(data)) == data == jnative.decompress(packed, len(data))
    import zlib

    assert zlib.decompress(packed) == data and packed != zlib.compress(data)  # Z_BEST_SPEED, not level 6
