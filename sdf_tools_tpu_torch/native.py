"""ctypes bindings of the repository's native support library
(``native/sdf_native.cpp``): the EDTs of ``squared_edt(backend="reference")``
and its zlib codec (``compress`` / ``decompress``).

The source is compiled on first use with the host C++ compiler (``$CXX``,
else ``g++``) into ``_build/`` next to this file, which git ignores; the
library is named by a hash of the source and the flags, so an edited source
rebuilds. ``available()`` says whether it could be built and loaded; the
EDT functions raise when it cannot, and the codec falls back to Python's
``zlib``, as the JAX package's does.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import zlib
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "native" / "sdf_native.cpp"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-shared"]
LIBS = ["-lz"]


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS + LIBS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libsdf_native_{h.hexdigest()[:16]}.so"


def _build() -> Path:
    out = library_path()
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("no C++ compiler ($CXX or g++) for the native library")
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE), *LIBS], capture_output=True, text=True, timeout=300
    )
    if proc.returncode != 0:
        raise RuntimeError(f"building the native library failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    return out


@functools.cache
def _load():
    """(library or None, the reason it is missing)."""
    try:
        lib = ctypes.CDLL(str(_build()))
    except (OSError, RuntimeError, subprocess.SubprocessError) as err:
        return None, str(err)
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    for name in ("edt_exact_i64", "edt_reference_i64"):
        fn = getattr(lib, name)
        fn.argtypes = [u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, i64p]
        fn.restype = ctypes.c_int
    lib.zlib_compress_bound.argtypes = [ctypes.c_int64]
    lib.zlib_compress_bound.restype = ctypes.c_int64
    for name in ("zlib_compress", "zlib_decompress"):
        fn = getattr(lib, name)
        fn.argtypes = [u8p, ctypes.c_int64, u8p, ctypes.c_int64]
        fn.restype = ctypes.c_int64
    return lib, ""


def available() -> bool:
    return _load()[0] is not None


def _edt(name: str, mask: np.ndarray) -> np.ndarray:
    lib, why = _load()
    if lib is None:
        raise RuntimeError(f"native library unavailable: {why}")
    m = np.ascontiguousarray(mask, np.uint8)
    if m.ndim != 3:
        raise ValueError(f"expected a 3D mask, got shape {m.shape}")
    out = np.empty(m.shape, np.int64)
    if getattr(lib, name)(m, *m.shape, out) != 0:
        raise RuntimeError(f"{name} failed")
    return out


def edt_exact(mask: np.ndarray) -> np.ndarray:
    """Exact squared EDT (int64) of a 3D bool/uint8 mask (C++ Felzenszwalb)."""
    return _edt("edt_exact_i64", mask)


def edt_reference(mask: np.ndarray) -> np.ndarray:
    """The reference's bucket-queue EDT (int64 d^2; may overestimate)."""
    return _edt("edt_reference_i64", mask)


def compress(data: bytes) -> bytes:
    """A zlib stream of ``data``: the library's (``Z_BEST_SPEED``), or where
    it cannot be built or loaded Python's ``zlib.compress`` at its default
    level, as in the JAX package. The two give different bytes (both are
    valid streams of the same data)."""
    lib, _ = _load()
    if lib is None:
        return zlib.compress(data)
    src = np.frombuffer(data, np.uint8)
    cap = int(lib.zlib_compress_bound(len(data)))
    dst = np.empty(cap, np.uint8)
    n = int(lib.zlib_compress(src, len(data), dst, cap))
    if n < 0:
        raise RuntimeError("zlib_compress failed")
    return dst[:n].tobytes()


def decompress(data: bytes, expected_size: int) -> bytes:
    """The bytes of a zlib stream, at most ``expected_size`` of them with
    the library (Python's ``zlib`` where it cannot be loaded)."""
    lib, _ = _load()
    if lib is None:
        return zlib.decompress(data)
    src = np.frombuffer(data, np.uint8)
    dst = np.empty(expected_size, np.uint8)
    n = int(lib.zlib_decompress(src, len(data), dst, expected_size))
    if n < 0:
        raise RuntimeError("zlib_decompress failed")
    return dst[:n].tobytes()
