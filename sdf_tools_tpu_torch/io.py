"""Binary serialization in the reference's on-disk and message formats
(counterpart of ``sdf_tools_tpu/io.py``; the same bytes for the same grid).

The reference's field-by-field layouts:
  * SignedDistanceField (sdf.cpp:213-258), file magic ``SDFZ`` (zlib body)
    or ``SDFR`` (raw) (sdf.cpp:392-470).
  * CollisionMapGrid (collision_map.cpp:21-120), magic ``CMGZ`` / ``CMGR``.
  * TaggedObjectCollisionMapGrid (tagged_object_collision_map.cpp:23-130),
    magic ``TCMZ`` / ``TCMR``.
  * Message blobs: the zlib-compressed serialization (sdf.cpp:472-502);
    ``*_message`` / ``*_from_message`` add the ROS wire envelope (header,
    uint8[], is_compressed; msg/*.msg).

Primitives (little-endian; arc_utilities): a fixed-size POD is its raw
bytes; a vector is a uint64 count then its elements; a string a uint64
length then its bytes; an Isometry3d its 4x4 matrix as 16 float64 in
column-major order. COLLISION_CELL is (float occupancy, uint32 component);
TAGGED_OBJECT_COLLISION_CELL is (float occupancy, uint32 component, uint32
object_id, uint32 convex_segment) (tagged_object_collision_map.hpp:22-43).
Cells are in C order of [nx, ny, nz] (x-major, z fastest).

The cells are packed where the grid lives: the occupancy's float bits and
the labels' uint32 values as int32 words, stacked [N, 2] or [N, 4], then
one copy to the host. The labels are int64 tensors holding uint32 values;
one reduction checks their range, and a value outside [0, 2^32) raises
``ValueError`` instead of wrapping. A load reads the cells in place from
the body, makes one copy to ``device`` and unpacks them there. Loads take
``device=`` (default ``"cuda"``, which raises without CUDA) and never fall
back to the CPU. The compressed bodies are Python's ``zlib.compress`` at its
default level, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
import json
import struct
import warnings
import zlib
from typing import Sequence, Tuple

import numpy as np
import torch

from .grid import CollisionMap, GridMeta, SdfGrid, TaggedCollisionMap, label_field, require_device

_U32_MAX = 0xFFFFFFFF


class _Writer:
    def __init__(self):
        self.parts = []

    def pod(self, fmt: str, *vals):
        self.parts.append(struct.pack("<" + fmt, *vals))

    def raw(self, b):
        self.parts.append(b)

    def eigen_isometry(self, m: np.ndarray):
        self.raw(np.asarray(m, "<f8").T.tobytes())  # column-major

    def string(self, s: str):
        b = s.encode()
        self.pod("Q", len(b))
        self.raw(b)

    def bytes(self) -> bytes:
        return b"".join(self.parts)


class _Reader:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def pod(self, fmt: str):
        sz = struct.calcsize("<" + fmt)
        out = struct.unpack_from("<" + fmt, self.buf, self.pos)
        self.pos += sz
        return out if len(out) > 1 else out[0]

    def raw(self, n: int) -> bytes:
        b = self.buf[self.pos : self.pos + n]
        self.pos += n
        return b

    def skip(self, n: int) -> int:
        """Step over ``n`` bytes; returns where they start."""
        start = self.pos
        if start + n > len(self.buf):
            raise ValueError(f"truncated body: {n} bytes at {start} of {len(self.buf)}")
        self.pos += n
        return start

    def eigen_isometry(self) -> np.ndarray:
        return np.frombuffer(self.raw(128), "<f8").reshape(4, 4).T.copy()

    def string(self) -> str:
        n = self.pod("Q")
        return self.raw(n).decode()


def _write_common_header(w: _Writer, meta: GridMeta):
    w.pod("B", 1)  # initialized_
    w.eigen_isometry(meta.origin_transform.cpu().numpy().astype(np.float64))
    w.eigen_isometry(meta.inv_origin_transform.cpu().numpy().astype(np.float64))


def _write_common_footer(w: _Writer, meta: GridMeta):
    res = meta.resolution_float
    nx, ny, nz = meta.shape
    w.pod("ddd", res, res, res)  # cell sizes
    w.pod("ddd", 1.0 / res, 1.0 / res, 1.0 / res)  # inverse cell sizes
    w.pod("ddd", nx * res, ny * res, nz * res)  # grid sizes (meters)
    w.pod("qq", ny * nz, nz)  # stride1, stride2
    w.pod("qqq", nx, ny, nz)


def _read_common_footer(r: _Reader):
    cell_sizes = r.pod("ddd")
    r.pod("ddd")  # inverse cell sizes
    r.pod("ddd")  # grid sizes
    r.pod("qq")  # strides
    nx, ny, nz = r.pod("qqq")
    return cell_sizes[0], (int(nx), int(ny), int(nz))


def _check_labels(fields: Sequence[torch.Tensor]) -> None:
    """Raise ``ValueError`` unless every label lies in [0, 2^32): the
    minimum and maximum of each field in one reduction and one host copy."""
    ext = torch.stack([torch.stack(torch.aminmax(f.reshape(-1))) for f in fields]).tolist()
    for lo, hi in ext:
        if lo < 0 or hi > _U32_MAX:
            raise ValueError(f"label outside uint32 [0, 2^32): range [{lo}, {hi}]")


def _u32_bits(labels: torch.Tensor) -> torch.Tensor:
    """int32 words with the bits of uint32 values held in int64."""
    return torch.where(labels > 0x7FFFFFFF, labels - (1 << 32), labels).to(torch.int32)


def _pack_cells(occupancy: torch.Tensor, labels: Sequence[torch.Tensor]) -> memoryview:
    """The cells as little-endian bytes: [N, 1 + len(labels)] int32 words
    (occupancy's float bits, then each label), packed on their device and
    copied to the host once."""
    _check_labels(labels)
    words = [occupancy.to(torch.float32).contiguous().view(torch.int32).reshape(-1)]
    words += [_u32_bits(f).reshape(-1) for f in labels]
    return memoryview(torch.stack(words, dim=1).cpu().numpy())


def _read_words(r: _Reader, count: int, width: int, device) -> torch.Tensor:
    """[count, width] int32 words of the body at the reader, read in place
    and copied to ``device`` once."""
    start = r.skip(count * width * 4)
    with warnings.catch_warnings():  # read-only bytes: the copy below owns its memory
        warnings.simplefilter("ignore", UserWarning)
        words = torch.frombuffer(r.buf, dtype=torch.int32, count=count * width, offset=start) if count else (
            torch.zeros(0, dtype=torch.int32))
    return words.to(device, copy=True).view(count, width)


def _unpack_labels(words: torch.Tensor, col: int, shape) -> torch.Tensor:
    return (words[:, col].to(torch.int64) & _U32_MAX).view(shape)


def _unpack_occupancy(words: torch.Tensor, shape) -> torch.Tensor:
    return words[:, 0].contiguous().view(torch.float32).view(shape)


def _oob_cell(oob_occupancy, width: int) -> bytes:
    return struct.pack("<f", float(oob_occupancy)) + bytes(4 * (width - 1))


# ---------------------------------------------------------------------------
# SignedDistanceField
# ---------------------------------------------------------------------------


def serialize_sdf(sdf: SdfGrid, locked: bool = False) -> bytes:
    w = _Writer()
    _write_common_header(w, sdf.meta)
    data = sdf.values.to(torch.float32).contiguous().reshape(-1)
    w.pod("Q", data.numel())
    w.raw(memoryview(data.cpu().numpy()))
    _write_common_footer(w, sdf.meta)
    # the reference's SDF constructors set default_value_ = oob_value_
    oob = float(sdf.oob_value)
    w.pod("f", oob)  # default_value
    w.pod("f", oob)
    w.string(sdf.meta.frame)
    w.pod("B", int(locked))
    return w.bytes()


def deserialize_sdf(buf: bytes, *, device="cuda") -> Tuple[SdfGrid, bool]:
    dev = require_device(device)
    r = _Reader(buf)
    r.pod("B")  # initialized_
    origin = r.eigen_isometry()
    r.eigen_isometry()  # its inverse
    count = r.pod("Q")
    words = _read_words(r, count, 1, dev)
    res, shape = _read_common_footer(r)
    r.pod("f")  # default_value
    oob = r.pod("f")
    frame = r.string()
    locked = bool(r.pod("B"))
    meta = GridMeta.create(origin, res, shape, frame, device=dev)
    return SdfGrid.create(words.view(torch.float32).view(shape), meta, oob), locked


def _save(body: bytes, filepath: str, magic: bytes, compress: bool) -> None:
    with open(filepath, "wb") as f:
        f.write(magic + (b"Z" if compress else b"R"))
        f.write(zlib.compress(body) if compress else body)


def _load_body(filepath: str, magic: bytes, what: str) -> bytes:
    with open(filepath, "rb") as f:
        head = f.read(4)
        body = f.read()
    if head == magic + b"Z":
        return zlib.decompress(body)
    if head != magic + b"R":
        raise ValueError(f"invalid {what} file header {head!r}")
    return body


def save_sdf(sdf: SdfGrid, filepath: str, compress: bool = True):
    _save(serialize_sdf(sdf), filepath, b"SDF", compress)


def load_sdf(filepath: str, *, device="cuda") -> SdfGrid:
    return deserialize_sdf(_load_body(filepath, b"SDF", "SDF"), device=device)[0]


def sdf_message_blob(sdf: SdfGrid) -> bytes:
    """Always-compressed message payload (sdf.cpp:472-483)."""
    return zlib.compress(serialize_sdf(sdf))


def sdf_from_message_blob(blob: bytes, is_compressed: bool = True, *, device="cuda") -> SdfGrid:
    return deserialize_sdf(zlib.decompress(blob) if is_compressed else blob, device=device)[0]


# ---------------------------------------------------------------------------
# CollisionMapGrid
# ---------------------------------------------------------------------------


def serialize_collision_map(cmap: CollisionMap, n_components: int = 0) -> bytes:
    w = _Writer()
    _write_common_header(w, cmap.meta)
    cells = _pack_cells(cmap.occupancy, [cmap.component])
    w.pod("Q", len(cells))
    w.raw(cells)
    _write_common_footer(w, cmap.meta)
    oob = _oob_cell(cmap.oob_occupancy, 2)
    w.raw(oob)  # default_value
    w.raw(oob)  # oob_value
    w.pod("I", int(n_components))
    w.string(cmap.meta.frame)
    w.pod("B", int(cmap.components_valid))
    return w.bytes()


def deserialize_collision_map(buf: bytes, *, device="cuda") -> CollisionMap:
    dev = require_device(device)
    r = _Reader(buf)
    r.pod("B")
    origin = r.eigen_isometry()
    r.eigen_isometry()
    count = r.pod("Q")
    words = _read_words(r, count, 2, dev)
    res, shape = _read_common_footer(r)
    r.raw(8)  # default_value
    oob = struct.unpack("<f", r.raw(8)[:4])[0]
    r.pod("I")  # n_components
    frame = r.string()
    components_valid = bool(r.pod("B"))
    meta = GridMeta.create(origin, res, shape, frame, device=dev)
    cm = CollisionMap.create(
        _unpack_occupancy(words, shape), meta, oob_occupancy=oob, component=_unpack_labels(words, 1, shape)
    )
    return dataclasses.replace(cm, components_valid=components_valid)


def save_collision_map(cmap: CollisionMap, filepath: str, compress: bool = True, n_components: int = 0):
    _save(serialize_collision_map(cmap, n_components), filepath, b"CMG", compress)


def load_collision_map(filepath: str, *, device="cuda") -> CollisionMap:
    return deserialize_collision_map(_load_body(filepath, b"CMG", "CollisionMap"), device=device)


def collision_map_message_blob(cmap: CollisionMap, n_components: int = 0) -> bytes:
    """Always-compressed CollisionMap message payload (collision_map.cpp:285-299)."""
    return zlib.compress(serialize_collision_map(cmap, n_components))


def collision_map_from_message_blob(blob: bytes, is_compressed: bool = True, *, device="cuda") -> CollisionMap:
    return deserialize_collision_map(zlib.decompress(blob) if is_compressed else blob, device=device)


# ---------------------------------------------------------------------------
# TaggedObjectCollisionMapGrid
# ---------------------------------------------------------------------------


def serialize_tagged_map(tmap: TaggedCollisionMap, n_components: int = 0, n_convex_segments: int = 0) -> bytes:
    w = _Writer()
    _write_common_header(w, tmap.meta)
    cells = _pack_cells(tmap.occupancy, [tmap.component, tmap.object_id, tmap.convex_segment])
    w.pod("Q", len(cells))
    w.raw(cells)
    _write_common_footer(w, tmap.meta)
    oob = _oob_cell(tmap.oob_occupancy, 4)
    w.raw(oob)
    w.raw(oob)
    w.pod("I", int(n_components))
    w.pod("I", int(n_convex_segments))
    w.string(tmap.meta.frame)
    w.pod("B", int(tmap.components_valid))
    w.pod("B", int(tmap.convex_segments_valid))
    return w.bytes()


def deserialize_tagged_map(buf: bytes, *, device="cuda") -> TaggedCollisionMap:
    dev = require_device(device)
    r = _Reader(buf)
    r.pod("B")
    origin = r.eigen_isometry()
    r.eigen_isometry()
    count = r.pod("Q")
    words = _read_words(r, count, 4, dev)
    res, shape = _read_common_footer(r)
    r.raw(16)  # default_value
    oob = struct.unpack("<f", r.raw(16)[:4])[0]
    r.pod("I")  # n_components
    r.pod("I")  # n_convex_segments
    frame = r.string()
    comps_valid = bool(r.pod("B"))
    segs_valid = bool(r.pod("B"))
    meta = GridMeta.create(origin, res, shape, frame, device=dev)
    tm = TaggedCollisionMap.create(
        _unpack_occupancy(words, shape), _unpack_labels(words, 2, shape), meta, oob_occupancy=oob
    )
    return dataclasses.replace(
        tm,
        component=_unpack_labels(words, 1, shape),
        convex_segment=_unpack_labels(words, 3, shape),
        components_valid=comps_valid,
        convex_segments_valid=segs_valid,
    )


def save_tagged_map(tmap: TaggedCollisionMap, filepath: str, compress: bool = True):
    _save(serialize_tagged_map(tmap), filepath, b"TCM", compress)


def load_tagged_map(filepath: str, *, device="cuda") -> TaggedCollisionMap:
    return deserialize_tagged_map(_load_body(filepath, b"TCM", "TaggedCollisionMap"), device=device)


def tagged_map_message_blob(tmap: TaggedCollisionMap) -> bytes:
    """Always-compressed TaggedObjectCollisionMap message payload
    (tagged_object_collision_map.cpp:306-320)."""
    return zlib.compress(serialize_tagged_map(tmap))


def tagged_map_from_message_blob(blob: bytes, is_compressed: bool = True, *, device="cuda") -> TaggedCollisionMap:
    return deserialize_tagged_map(zlib.decompress(blob) if is_compressed else blob, device=device)


# ---------------------------------------------------------------------------
# Checkpoints (.npz and a JSON header): the same keys as the JAX package's,
# so each package loads the other's files. The SDFZ/CMGZ/TCMZ formats above
# are the reference-interop path.
# ---------------------------------------------------------------------------


def _labels_u32(labels: torch.Tensor) -> np.ndarray:
    _check_labels([labels])
    return labels.cpu().numpy().astype(np.uint32)


def save_checkpoint(path: str, grid) -> None:
    """Save an SdfGrid, CollisionMap or TaggedCollisionMap as ``.npz``."""
    meta = grid.meta
    header = {"kind": type(grid).__name__, "shape": list(meta.shape), "frame": meta.frame}
    arrays = {
        "origin_transform": meta.origin_transform.cpu().numpy().astype(np.float32),
        "resolution": np.asarray(meta.resolution_float, np.float32),
    }
    if isinstance(grid, SdfGrid):
        arrays["values"] = grid.values.cpu().numpy().astype(np.float32)
        arrays["oob_value"] = np.asarray(float(grid.oob_value), np.float32)
    elif isinstance(grid, CollisionMap):
        arrays["occupancy"] = grid.occupancy.cpu().numpy().astype(np.float32)
        arrays["component"] = _labels_u32(grid.component)
        arrays["oob_occupancy"] = np.asarray(float(grid.oob_occupancy), np.float32)
        header["components_valid"] = bool(grid.components_valid)
    elif isinstance(grid, TaggedCollisionMap):
        arrays["occupancy"] = grid.occupancy.cpu().numpy().astype(np.float32)
        arrays["component"] = _labels_u32(grid.component)
        arrays["object_id"] = _labels_u32(grid.object_id)
        arrays["convex_segment"] = _labels_u32(grid.convex_segment)
        arrays["oob_occupancy"] = np.asarray(float(grid.oob_occupancy), np.float32)
        header["components_valid"] = bool(grid.components_valid)
        header["convex_segments_valid"] = bool(grid.convex_segments_valid)
    else:
        raise TypeError(type(grid))
    arrays["__header__"] = np.frombuffer(json.dumps(header).encode(), np.uint8)
    np.savez_compressed(path, **arrays)


def load_checkpoint(path: str, *, device="cuda"):
    dev = require_device(device)
    with np.load(path) as z:
        header = json.loads(bytes(z["__header__"].tobytes()).decode())
        meta = GridMeta.create(
            z["origin_transform"], float(z["resolution"]), tuple(header["shape"]), header["frame"], device=dev
        )
        kind = header["kind"]
        if kind == "SdfGrid":
            return SdfGrid.create(z["values"], meta, float(z["oob_value"]))
        if kind == "CollisionMap":
            cm = CollisionMap.create(z["occupancy"], meta, float(z["oob_occupancy"]), z["component"])
            return dataclasses.replace(cm, components_valid=header["components_valid"])
        if kind == "TaggedCollisionMap":
            tm = TaggedCollisionMap.create(z["occupancy"], z["object_id"], meta, float(z["oob_occupancy"]))
            return dataclasses.replace(
                tm,
                component=label_field(z["component"], tm.shape, dev),
                convex_segment=label_field(z["convex_segment"], tm.shape, dev),
                components_valid=header["components_valid"],
                convex_segments_valid=header["convex_segments_valid"],
            )
        raise ValueError(kind)


# ---------------------------------------------------------------------------
# ROS message envelope framing
#
# The reference ships its grids over ROS as `header + uint8[] + bool`
# messages (msg/SDF.msg, msg/CollisionMap.msg,
# msg/TaggedObjectCollisionMap.msg; filled by GetMessageRepresentation,
# sdf.cpp:472-483). These produce and read that message in the ROS wire
# serialization (fields in declaration order; std_msgs/Header = uint32 seq +
# uint32 secs + uint32 nsecs + length-prefixed frame_id; arrays and strings
# uint32-length-prefixed; bool one byte), envelope included, without ROS.
# ---------------------------------------------------------------------------


def frame_ros_message(
    payload: bytes, frame_id: str, is_compressed: bool = True, stamp: Tuple[int, int] = (0, 0), seq: int = 0
) -> bytes:
    """Wrap a serialized-grid payload in the ROS wire envelope."""
    fid = frame_id.encode()
    return b"".join(
        [
            struct.pack("<III", seq, stamp[0], stamp[1]),
            struct.pack("<I", len(fid)),
            fid,
            struct.pack("<I", len(payload)),
            payload,
            struct.pack("<B", int(is_compressed)),
        ]
    )


def unframe_ros_message(buf: bytes) -> Tuple[bytes, str, bool]:
    """(payload, frame_id, is_compressed) from a ROS-wire envelope."""
    r = _Reader(buf)
    r.pod("III")  # seq, secs, nsecs
    fid = r.raw(r.pod("I")).decode()
    payload = r.raw(r.pod("I"))
    is_compressed = bool(r.pod("B"))
    if r.pos != len(buf):
        raise ValueError(f"trailing bytes in message ({len(buf) - r.pos})")
    return payload, fid, is_compressed


def sdf_message(sdf: SdfGrid, stamp: Tuple[int, int] = (0, 0), seq: int = 0) -> bytes:
    """Full sdf_tools/SDF message bytes (GetMessageRepresentation: an
    always-compressed payload, a header carrying the grid's frame)."""
    return frame_ros_message(sdf_message_blob(sdf), sdf.meta.frame, True, stamp, seq)


def sdf_from_message(buf: bytes, *, device="cuda") -> SdfGrid:
    payload, _, is_compressed = unframe_ros_message(buf)
    return sdf_from_message_blob(payload, is_compressed, device=device)


def collision_map_message(
    cmap: CollisionMap, n_components: int = 0, stamp: Tuple[int, int] = (0, 0), seq: int = 0
) -> bytes:
    """Full sdf_tools/CollisionMap message bytes (collision_map.cpp:285-299)."""
    return frame_ros_message(collision_map_message_blob(cmap, n_components), cmap.meta.frame, True, stamp, seq)


def collision_map_from_message(buf: bytes, *, device="cuda") -> CollisionMap:
    payload, _, is_compressed = unframe_ros_message(buf)
    return collision_map_from_message_blob(payload, is_compressed, device=device)


def tagged_map_message(tmap: TaggedCollisionMap, stamp: Tuple[int, int] = (0, 0), seq: int = 0) -> bytes:
    """Full sdf_tools/TaggedObjectCollisionMap message bytes
    (tagged_object_collision_map.cpp:306-320)."""
    return frame_ros_message(tagged_map_message_blob(tmap), tmap.meta.frame, True, stamp, seq)


def tagged_map_from_message(buf: bytes, *, device="cuda") -> TaggedCollisionMap:
    payload, _, is_compressed = unframe_ros_message(buf)
    return tagged_map_from_message_blob(payload, is_compressed, device=device)
