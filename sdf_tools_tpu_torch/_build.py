"""Build, load and launch the port's CUDA kernels (``csrc/*.cu``).

The sources have a plain C interface, so they are compiled by ``nvcc`` (one
process per source, all started together) and linked into one shared
library loaded with ``ctypes`` (no PyTorch headers: the build takes
seconds). The library is named by a hash of the sources, their headers
(``csrc/*.cuh``) and the flags, so an edited source or header rebuilds; it
lands in ``_build/`` next to this file, which git ignores. A missing
``nvcc`` or a failed build raises.

Flags: ``sm_90a`` (Hopper); ``-fmad=false`` and no fast math, because the
signed-combine epilogue and the plane sweep must round exactly like their
plain PyTorch versions.

``LAUNCHES[name]`` counts each kernel's launches (``launch`` adds one per
launch, nowhere else; a name it does not list yet starts at 0), so a run
can show that its main path went through the kernels.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-Xcompiler", "-fPIC",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
# name -> argtypes of the C entry points in csrc/*.cu (all return cudaError_t)
SIGNATURES = {
    # mask, out a, out b, X, Y, Z, square, stream
    "sdf_line_pass_dual": [_P, _P, _P, _I, _I, _I, _I, _P],
    # mask, out, X, Y, Z, square, stream
    "sdf_line_pass": [_P, _P, _I, _I, _I, _I, _P],
    "sdf_envelope_dual": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "sdf_envelope_dual_combine": [_P, _P, _P, ctypes.c_float, _I, _I, _I, _P],
    # f, out, X, Y, Z, axis, stream
    "sdf_envelope": [_P, _P, _I, _I, _I, _I, _P],
    # f, out, X, Y, Z, axis, stream
    "sdf_envelope_cht": [_P, _P, _I, _I, _I, _I, _P],
    # f, out, win, n_payload, 3 payloads in, 3 payloads out, X, Y, Z, axis, stream
    "sdf_envelope_carry": [_P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # g, win, win_bytes, out, X, Y, Z, axis, stream
    "sdf_winner_segment_sum": [_P, _P, _I, _P, _I, _I, _I, _I, _P],
    # tab, tab width, ch, 3 volumes, eps, t_max, rows, row-order scratch, depth, hit, steps, model, tnear, exec,
    # stream
    "sdf_plane_sweep": [_P, _I, _P, _P, _P, _P, ctypes.c_float, ctypes.c_float, _I, _P, _P, _P, _P, _P, _P, _P, _P],
    # table width, int[6] out
    "sdf_plane_sweep_attrs": [_I, _P],
    # values, pooled (or NULL), inverse transform, oob, min step (or NULL), origins, directions, rays, nx, ny, nz,
    # cx, cy, cz, res, t_min, t_max, eps, max_steps, depth, hit, steps, stream
    "sdf_march": [*[_P] * 7, *[_I] * 7, *[ctypes.c_float] * 4, _I, _P, _P, _P, _P],
    # the envelope-design probes (csrc/micro_gather.cu); B is the batch of instances
    # x, out, B, elements, steps, tile, stream
    "sdf_micro_ops": [_P, _P, _I, _I, _I, _I, _P],
    # x, q, out, B, outer, n, inner, m, steps, mod, shared, ow, kw, mw, groups, chunk, stream
    "sdf_micro_gather": [_P, _P, _P, *[_I] * 13, _P],
    # x, q, out, B, D, inner, steps, mod, shared, kw, groups, chunk, stream
    "sdf_micro_onehot_min": [_P, _P, _P, *[_I] * 9, _P],
    # x, q, v (or NULL), out, B, D, inner, steps, mod, out_rows, shared, tile, stream
    "sdf_micro_onehot_write": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # x, out, B, outer, n, inner, ow, kw, runs, r, stream
    "sdf_micro_row_scan": [_P, _P, *[_I] * 8, _P],
    "sdf_micro_empty": [_P],
    # the render-design probes (csrc/micro_render.cu); B is the batch of instances
    # data, R, C, y, z, ytab, ztab, out, terms, stride, B, steps, per_step, rows, tab_len, base, H, W, row_base,
    # col_mode, add_y, extra, tiles, chunk, stream
    "sdf_micro_band_sum": [_P, _I, _I, _P, _P, _P, _P, _P, _P, *[_I] * 15, _P],
    # data, R, C, vol, nx, ny, nz, y, z, rows, ytab, ztab, tab_len, out, terms, stride, B, steps, per_step, G, K,
    # variant, tiles, chunk, stream
    "sdf_micro_sampler": [_P, _I, _I, _P, _I, _I, _I, _P, _P, _I, _P, _P, _I, _P, _P, *[_I] * 9, _P],
    # tab, rows, width, vol, element size, nx, ny, nz, P, BY, BZ, out, terms, stride, B, iters, variant, tiles,
    # chunk, stream
    "sdf_micro_band_copy": [_P, _I, _I, _P, *[_I] * 7, _P, _P, *[_I] * 6, _P],
}
LAUNCHES = {
    "line_pass_dual": 0,
    "envelope_dual": 0,
    "envelope_dual_combine": 0,
    "line_pass": 0,
    "envelope": 0,
    "envelope_cht": 0,
    "envelope_carry": 0,
    "winner_segment_sum": 0,
    "plane_sweep": 0,
    "march": 0,
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found (looked on PATH and in $CUDA_HOME/bin)")


def library_path() -> Path:
    """The library's path, named by a hash of the flags and of every source
    and header (``csrc/*.cu``, ``csrc/*.cuh``)."""
    sources = sorted([*CSRC.glob("*.cu"), *CSRC.glob("*.cuh")])
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libsdf_edt_{h.hexdigest()[:16]}.so"


def _run_all(cmds) -> None:
    """Run the commands concurrently; raise with the output of the first failure."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)) for cmd in cmds]
    failed = []
    for cmd, proc in procs:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{stdout}\n{stderr}")
    if failed:
        raise RuntimeError("\n".join(failed))


def build() -> Path:
    """Compile csrc/*.cu (which include csrc/*.cuh) into the hashed library
    unless it already exists."""
    out = library_path()
    if out.exists():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    sources = sorted(CSRC.glob("*.cu"))
    objects = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources]
    _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)] for src, o in zip(sources, objects)])
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objects)]])
    for o in objects:
        o.unlink()
    os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    return out


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def launch(name: str, device, fn: str, *args) -> None:
    """Launch C entry point ``fn`` on ``device``'s current stream, raise if
    it returns a CUDA error, and count the launch under ``name``."""
    import torch

    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(library(), fn)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed with cudaError_t {rc}")
    LAUNCHES[name] = LAUNCHES.get(name, 0) + 1
