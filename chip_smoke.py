"""Smoke run of the PyTorch/CUDA port (``sdf_tools_tpu_torch``) on one GPU.

Run from the repository root on a machine with an NVIDIA Hopper card:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing falls back to the CPU):

1. Device: the card's name and power limit, library versions; TF32 off.
2. Build the CUDA kernels from ``sdf_tools_tpu_torch/csrc`` (one nvcc per
   source, all started together) and time it.
3. Each kernel against its plain PyTorch version on the card, bitwise, at
   small and degenerate shapes, an all-empty and an all-full mask, and at
   ``bench.make_scene(256)``: K1 and K4 in both modes (squared, linear), K2,
   K3,
   K5 and K9 along axes 1 and 2, K6 in both forms (winner and carried
   payloads) along axes 1 and 2, K7 along axes 0, 1 and 2 (the FT's
   winner maps, and random non-monotone int16 and int32 winners in
   [-1, n], and on lines of 60000, longer than shared memory holds); K2,
   K3, K5, K6 (both forms) and K9 on tie-heavy, all-INF_D2 and single-seed
   lines of lengths 1, 2, 3, 31, 32, 33, 1023, 1024 and 1025 (K9 up to its
   1024; also sources at CHT_CLAMP +- 4 and the convex profile) along axes
   1 and 2, and K6 on lines of 16384 along axis 2; K1 and K4 in both modes
   on uint8 masks (seed values 1..255) with x lengths 1, 2, 31, 32, 33, 63,
   64, 65, 1023, 1024, 1025, 2049 and 4097 (around the kernel's 32-row
   chunks, and several chunks a thread beyond 1024) and 3 x 11 and 5 x 67
   columns (not a multiple of 32 or 4): seedless, full, seeds only on chunk
   edges, one in the last chunk, far apart, random; K8 (the plane
   sweep, all six outputs) on ``make_scene(256)`` seen from ``bench.py``'s
   camera, on a two-sphere scene seen from +x (negative marching
   direction) and on its edge cases (``tests/plane_scenes.py``: the plane
   tests' two views, the shifted last slab with unaligned rows, rows
   marching axes 1 and 2 in one launch, rays starting inside an obstacle,
   steep rows); K8's registers, local bytes and blocks per SM.
4. The serving path at BASELINE config #4 size through ``SdfEngine``:
   512^3 signed field of ``bench.make_scene(512)``, 1M trilinear queries,
   one 1024^2 depth render from ``bench.py``'s camera, which on the card is
   the plane sweep (K8). Kernel launch counts are reset just before and
   read just after this run; K1-K3 and K8 must have run. Then each kernel
   against its plain version at 512^3 (K1 in both modes; K8 on the
   render's own tables), and
   the whole field against the plain chain, all bitwise; the plane render
   resolves every ray (no march fallback) and agrees with the card's march
   on all 1M rays with the JAX plane test's bars. The card's queries and
   march are held against the port's CPU path on a subset.
5. The training path of config #4 at the same size (the counterpart of
   ``bench.py``'s ``bench_edt_bwd`` and ``bench_render_bwd`` and of
   ``examples/carve_occupancy.py``): (a) the gradient of sum(sdf_ft(occ)^2)
   w.r.t. a soft occupancy, (b) the value and gradient of sum(depth^2)
   w.r.t. the field values, (c) three SGD steps of logits -> sigmoid ->
   FT signed field -> render -> mean (depth - target)^2; the render forward
   is the plane sweep. Launch counts are reset just before and read just
   after; K6 and K7 must have run. Checks: the FT field equals the K1-K3
   field bitwise; its occupancy gradient equals the ``"plain"`` backend's
   on the card bitwise; the routed mass is -2 res times the cotangent's
   sum; the render gradient on a ray subset matches the port's CPU
   backward fed the card's depth and hit; losses and gradients are finite
   and the gradients non-zero. K6 and K7 against their plain versions at
   the main path's 512^3 inputs (K7 also with random winners), bitwise.
6. CUDA-event timings (median; plain and kernel in turns plain, kernel,
   kernel, plain) of every kernel at 512^3 and 1024^2 (K1 in both modes,
   each against its bound), of the field, the
   plane render and its split (precompute, K8, tail, march fallback), the
   tail's resume march alone, the march render, the FT forward and
   backward, the render value-and-grad and one training step; K8's bound
   from the run's tables (``k8_bound``); one profiled
   plane render and march render (kernels, device busy time, idle share);
   peak device memory.
7. BASELINE config #5's one-card leg at 1024^3, at the settings of
   ``scripts/bench_render_1024.py``: ``make_scene(1024)`` rasterised on the
   card in x-chunks (held against the numpy formula on a few x-slices), the
   fused K1-K3 field as the card's reference, then five routes that must
   each equal it bitwise, with launch counts reset before and read after
   each: (a) ``squared_edt`` of the mask and of its complement against
   ``squared_edt_both`` (K4 2, K5 4), (b) ``signed_field_lowmem`` (K4 2,
   K5 4), (c) the device-resident slab build (``squared_edt_slabbed`` x2,
   8 slabs, into one buffer; K4 16, K5 32), (d) ``signed_field_slabbed``
   (8 slabs, prefetch 2, compared on the host; K4 16, K5 32), (e)
   ``backend="cht"`` (K4 2, K9 4). K4, K5, K9 against their plain versions on
   one slab's inputs (128x1024x1024). A 1024^2 render over the 1024^3
   field through ``render_depth(backend="auto")`` (K8 must launch; K8
   equal to plain on its tables; unresolved rays counted; plane vs the
   card's march with phase 4's bars; K8 against plain and its bound on
   those tables). Timings: K4 (both modes), K5 and K9
   at the slab and the full volume against their plain versions and their
   bounds, K9 against K5 on the
   same 1024^3 inputs (axes 1 and 2, in turns; the scene's, and
   ``make_scene(256)`` tiled 4x4x4), each route, the render
   and its split, the march; peak device memory after each route.
8. BASELINE configs #1-#3 and the planner's query surface, at the users'
   sizes, with launch counts reset before and read after each checked
   run: (1) ``validate_baseline.py``'s 256^2 image (seed 3, 12
   rectangles) through ``utils_2d.compute_sdf_and_gradient`` (K1, K2, K3
   once each) and ``image_sdf`` (K1 once, K2 twice), held against
   scipy's exact EDT (integer d^2 from its nearest-feature indices), with
   signs, the two fields against each other and the gradient against the
   port's CPU path; (2) the 64^3 tutorial ``CollisionMap`` (res 0.25, two
   boxes) through ``collision_map_ops.extract_sdf``: d^2 equal to scipy's,
   the combine within 4 ulp of the float64 math, unknown cells (0.5) and
   the virtual border bitwise against the ``"plain"`` chain; (3) 12000
   points -> ``voxelize_points`` -> ``extract_sdf`` at 256^3 (res 0.02),
   distances and edge gradients at the validator's 200 points and at 1M
   uniform ones, held against the port's CPU path with the validator's
   bars; (4) on phase 4's 512^3 field: ``get_value_by_location``,
   ``smooth_gradient`` and ``distance_to_boundary`` on 1M points (against
   the CPU on a subset), ``full_gradient`` of the whole field (against the
   CPU on x-slices), ``project_out_of_collision`` of 64K points inside
   obstacles (success >= 99%, every success clear of the minimum distance,
   a subset against the CPU); (5) ``make_scene(256)``'s 40 spheres as a
   ``TaggedCollisionMap`` (each cell the first sphere's id), through
   ``extract_tagged_sdf``, ``extract_free_and_named_objects_sdf`` and
   ``make_object_sdfs``: K1, K2 and K3 once per field, each field bitwise
   equal to the ``"plain"`` chain. CUDA-event medians of every stage and
   the phase's peak memory.
9. The planner's map topology and io: (1) ``update_connected_components``
   of the 512^3 map (its rounds and host checks) against scipy's
   6-connected labels of the filled and the free cells, ranked by first
   flat index; (2) ``component_surface_mask``, ``surface_mask_26`` and
   ``candidate_corner_mask`` at 512^3 against numpy's neighbour rules on
   x-slabs, and ``component_topology_census`` of the 512^3 map's
   components against scipy's enclosures (below); (3) the tagged
   ``make_scene(256)`` map with a torus and a hollow cube planted in free
   space: components against scipy and against the plain loop (one
   neighbour step a round) on the card, the census against scipy's
   enclosures (the free space's voids are the 26-connected obstacle
   clusters it alone surrounds, an obstacle's voids the free pockets it
   alone surrounds; where a component's 26-cluster holds several of its
   kind, the count by the other kind's 6-connected components is admitted
   too) and the planted rows ((1, 0) and (0, 1)), card against CPU on a
   64^3 crop, rounds and ms a round; (4) ``update_convex_segments`` at
   256^3 (K1-K3 twice), then at 128^3 its field, extrema map and segments
   card against CPU, bitwise; (5) io round trips,
   bitwise on the card: SDFR and SDFZ of phase 4's 512^3 field, CMGZ of
   the 512^3 map with its components, TCMZ and a ROS
   message of the tagged map with its segments, ``.npz`` checkpoints of
   the three, the card's bytes against the CPU's, headers and leading
   cells read back with ``struct``; (6) NaN, +-inf, +-1e30 and 3e9 points
   through the queries, ``voxelize_points`` and a short march, card
   against CPU bitwise. Launches reset and read around each checked run;
   the K1-K3 launches of (4)'s 256^3 run and of (5)'s 512^3 field are
   the phase's main-path launches (the 128^3 comparison's are not counted).
10. One JSON line with the kernels, then the last line
   ``{"ok": true, "device": {...}}``.

Imports neither JAX nor ``sdf_tools_tpu``.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

N = 512
RES = 0.05
IMAGE_HW = (1024, 1024)
MAX_STEPS = 64
N_QUERIES = 1 << 20
SMALL_SHAPES = [(16, 24, 32), (8, 40, 1), (1, 16, 128), (5, 7, 9), (33, 64, 129), (128, 128, 128),
                (256, 256, 1), (257, 255, 1)]  # the last two: 2-D images, as utils_2d and image_sdf build them
# adversarial envelope inputs: scanned-axis lengths (both axes; one field
# and two; K9 takes those up to its 1024), K6's longest line (axis 2), and
# the width of the other axes
ENVELOPE_LINES = (1, 2, 3, 31, 32, 33, 1023, 1024, 1025)
CARRY_LONG_LINE = 16384  # MAX_ENVELOPE_AXIS, the search's int16 J
ENVELOPE_WIDTH = 37
# K1 and K4 on their own edges: x lengths around the 32-row chunks, up to
# and past one chunk a thread (1024), and columns Y x Z that are not a
# multiple of 32 or 4
LINE_PASS_X = (1, 2, 31, 32, 33, 63, 64, 65, 1023, 1024, 1025, 2049, 4097)
LINE_PASS_COLUMNS = ((3, 11), (5, 67))
# K7 on lines longer than a block's shared memory holds (its in-place walk)
SEGSUM_LONG_SHAPES = ((2, 2, 60000), (60000, 2, 2))
TIMING_ROUNDS = 3  # ABBA rounds: 6 timed runs of each side
# the tolerance the JAX package's own tests hold two march runs to
# (tests/test_render.py, jit vs eager): hits agree on >= 99.5% of rays,
# common-hit depths within 2e-3
HIT_AGREE_MIN = 0.995
DEPTH_ATOL = 2e-3
QUERY_ATOL = 1e-6
# the plane sweep against the march on the same rays: the JAX plane test's
# bars (tests/test_render_plane.py:76-88); the JAX package's plane sweep
# disagrees with its march on 0.463% of the bench rays (docs/NOTES.md §13),
# a property of the algorithm
PLANE_HIT_AGREE_MIN = 0.98
PLANE_P95_MAX = 0.5  # times res
PLANE_MEDIAN_MAX = 0.1  # times res
RENDER_EPS = 1e-3  # SdfEngine's default
# render gradient, card vs the port's CPU backward fed the card's depth and
# hit: the float ops are the same, only the order of the index_add_ sums
# into a cell differs (atomics on the card)
RENDER_GRAD_RTOL = 1e-5
RENDER_GRAD_ATOL_REL = 1e-5  # times max |grad|
MASS_RTOL = 1e-3
TRAIN_STEPS = 3
TRAIN_SHIFT = 4  # cells along x: the initial logits' mask is the scene shifted
TRAIN_LR = 1e6  # chosen from CPU runs of the same step at 64^3 and 128^3
# BASELINE config #5's one-card leg (scripts/bench_render_1024.py)
N5 = 1024
N5_SLABS = 8
N5_PREFETCH = 2
N5_MAX_STEPS = 96
N5_SCENE_CHUNK = 64  # x-planes per rasterisation chunk (a 64x1024x1024 float64 temporary, 0.5 GB)
N5_CHECK_SLICES = (0, 333, 511, 777, 1023)  # x-slices held against make_scene's formula on the host
ROUTE_RUNS = 3  # timed runs of each 1024^3 route after its checked run
FULL_ROUNDS = 1  # ABBA rounds at the full 1024^3 volume (a plain envelope there takes seconds)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM peak memory rate (data sheet)
FP32_OPS_PER_S = 67e12  # H100 SXM float32 peak outside the tensor cores (data sheet)
# float32 arithmetic of K8 (compares, selects, conversions and the
# integer work left out; a division counts one): every lane-plane of an
# executed slab, its crossing (ux, ty, uy, uz: 7) and the corner cell's
# offsets and weights (4); every valid sample, its four center corrections
# (4) and the bilinear (2 complements, 8 products, 3 sums); every valid
# pair, the three probe times (8) and three frozen-corner model probes of
# 46 each (t to ux: 2, uy and uz: 4, wx: 2, two bilinears of 17 with their
# offsets, the blend: 4). Left out, so that the bound stays a lower one:
# the candidate's secant (7, at most once a lane and slab) and the entry
# and exit models (at most once or twice a ray)
K8_OPS_PER_PLANE = 11
K8_OPS_PER_SAMPLE = 17
K8_OPS_PER_PAIR = 8 + 3 * 46
# bytes per ray K8 must move besides the field and the table: 9 used f32
# channels in, depth, hit, steps, model, tnear and exec out
K8_BYTES_PER_RAY = 9 * 4 + 6 * 4

# BASELINE configs #1-#3 and the query surface (phase 8), at the settings
# of scripts/validate_baseline.py
CONFIG1_N = 256
CONFIG1_ERR_MAX = 1e-4  # against the exact EDT, in pixels
CONFIG2_N, CONFIG2_RES = 64, 0.25
CONFIG2_ULP_MAX = 4.0  # the combine against the float64 math
CONFIG3_N, CONFIG3_RES = 256, 0.02
CONFIG3_DIST_TOL = dict(rtol=2e-4, atol=2e-5)
CONFIG3_GRAD_TOL = dict(rtol=2e-3, atol=2e-4)
CPU_SUBSET = 4096  # queries held against the port's CPU path
# card against CPU: the same float operations one at a time, so equal
# up to a stated few ulps (the run prints the largest found)
CPU_MAX_ULPS = 2
SMOOTH_WINDOW = RES
# smooth_gradient divides differences of two distances, each within
# QUERY_ATOL of the CPU's, by the window (one-sided) or twice it
SMOOTH_ATOL = 4 * QUERY_ATOL / SMOOTH_WINDOW
PROJECT_POINTS = 1 << 16
PROJECT_CPU_POINTS = 256
PROJECT_MIN_DIST = RES
PROJECT_MAX_STEPS = 1000
PROJECT_SUCCESS_MIN = 0.99
PROJECT_ATOL = 1e-5  # card against CPU: points and final distances
TAGGED_N = 256
STAGE_RUNS = 3  # timed runs of each phase-8 stage after its checked run
FULL_GRADIENT_SLICES = (0, 1, 255, 510, 511)

# the planner's map topology and io (phase 9): config #4's 512^3 map and
# phase 8's make_scene(256) tagged map
TOPO_RUNS = 2  # timed runs of each phase-9 stage after its checked run
SURFACE_SLAB_X0 = (0, 248, 496)  # 16-plane x-slabs of the 512^3 masks held against numpy
SURFACE_SLAB = 16
PLANT_BLOCK = 16  # each planted shape sits 5 cells inside a free block this wide
CENSUS_CROP = 64  # the census card against CPU on a crop around the planted shapes
CONVEX_CPU_N = 128  # convex segments and their extrema map card against CPU
CONVEX_THRESHOLD = 2 * RES  # extrema within two cells join a segment
IO_RECORDS = 64  # leading cells read back with struct.unpack_from

# name -> (source, TPU kernel it replaces, bytes per cell of one launch:
# each input read once and each output written once, at the shapes the
# main path gives it, and the edge of that cubic shape)
KERNELS = {
    # 1 B of mask in, two int32 fields out
    "line_pass_dual": ("sdf_tools_tpu_torch/csrc/edt_line_pass.cu", "sdf_tools_tpu/ops/edt_pallas.py:504", 9, N),
    # two int32 fields in, two out
    "envelope_dual": ("sdf_tools_tpu_torch/csrc/edt_envelope.cu", "sdf_tools_tpu/ops/edt_pallas.py:331", 16, N),
    # two int32 fields in, one f32 out
    "envelope_dual_combine": ("sdf_tools_tpu_torch/csrc/edt_envelope.cu", "sdf_tools_tpu/ops/edt_pallas.py:426", 12, N),
    # argmin form: one int32 field in, the envelope and the winner out
    "envelope_carry": ("sdf_tools_tpu_torch/csrc/edt_carry.cu", "sdf_tools_tpu/ops/edt_pallas.py:581", 12, N),
    # f32 g and int16 winners in, f32 out
    "winner_segment_sum": (
        "sdf_tools_tpu_torch/csrc/edt_segsum.cu", "sdf_tools_tpu/ops/edt_pallas.py:736 and :764 (call :857)", 10, N
    ),
    # bound from the run's own tables (k8_bound)
    "plane_sweep": ("sdf_tools_tpu_torch/csrc/render_plane.cu", "sdf_tools_tpu/ops/render_plane.py:143 (call :1227)", None, N),
    # config #5's routes at 1024^3: 1 B of mask in, one int32 field out
    "line_pass": ("sdf_tools_tpu_torch/csrc/edt_line_pass.cu", "sdf_tools_tpu/ops/edt_pallas.py:226 (call :286)", 5, N5),
    # one int32 field in, one out
    "envelope": ("sdf_tools_tpu_torch/csrc/edt_envelope.cu", "sdf_tools_tpu/ops/edt_pallas.py:115 (call :976)", 8, N5),
    "envelope_cht": ("sdf_tools_tpu_torch/csrc/edt_cht.cu", "sdf_tools_tpu/ops/edt_cht.py:176 (call :240)", 8, N5),
}
SERVING_KERNELS = ("line_pass_dual", "envelope_dual", "envelope_dual_combine", "plane_sweep")
TRAINING_KERNELS = ("envelope_carry", "winner_segment_sum")
CONFIG5_KERNELS = ("line_pass", "envelope", "envelope_cht")


def bytes_bound_ms(name: str, n: int) -> float:
    """ms to move ``name``'s bytes per cell (KERNELS) over n^3 cells at the
    peak memory rate."""
    return KERNELS[name][2] * n**3 / HBM_BYTES_PER_S * 1e3


def log(msg: str) -> None:
    print(msg, flush=True)


class Failure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise Failure(what)


def timed(fn, host_clock: bool = False):
    """(result, ms) of one call of ``fn``: CUDA events around it, or with
    ``host_clock`` the host's clock around the call and a synchronize (for
    calls that wait on the host themselves)."""
    import torch

    if host_clock:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    stop.synchronize()
    return out, start.elapsed_time(stop)


def cuda_ms(fn) -> float:
    """CUDA-event ms of one call of ``fn``."""
    return timed(fn)[1]


def abba(plain_fn, kernel_fn, rounds=TIMING_ROUNDS, on_warm=None):
    """(kernel ms, plain ms): medians of ``2 * rounds`` runs each, in turns
    plain, kernel, kernel, plain, after one untimed run of each; ``on_warm``
    gets the untimed runs' outputs (kernel, plain)."""
    want = plain_fn()
    got = kernel_fn()
    if on_warm is not None:
        on_warm(got, want)
    del want, got
    tp, tk = [], []
    for _ in range(rounds):
        tp.append(cuda_ms(plain_fn))
        tk.append(cuda_ms(kernel_fn))
        tk.append(cuda_ms(kernel_fn))
        tp.append(cuda_ms(plain_fn))
    return float(np.median(tk)), float(np.median(tp))


def spread(ts):
    return f"{np.median(ts):.3f} ms (median of {len(ts)}; min {min(ts):.3f}, max {max(ts):.3f})"


def device_scene(n: int, device, seed: int = 0):
    """``bench.make_scene(n)`` rasterised on the card: the same rng draws and
    the same float64 arithmetic in the same order, in x-chunks of
    ``N5_SCENE_CHUNK`` planes. Returns (mask, centers, radii)."""
    import torch

    c, r = scene_spheres(n, seed)
    ii = torch.arange(n, dtype=torch.float64, device=device)
    mask = torch.zeros((n, n, n), dtype=torch.bool, device=device)
    for k in range(40):
        dx, dy, dz = (ii - float(c[k, a]) for a in range(3))
        x2, y2, z2 = dx * dx, dy * dy, dz * dz
        r2 = float(r[k] ** 2)
        for x0 in range(0, n, N5_SCENE_CHUNK):
            part = mask[x0 : x0 + N5_SCENE_CHUNK]
            part |= (x2[x0 : x0 + N5_SCENE_CHUNK, None, None] + y2[None, :, None] + z2[None, None, :]) <= r2
    return mask, c, r


def scene_spheres(n: int, seed: int = 0):
    """``bench.make_scene(n)``'s 40 sphere centers and radii (its rng draws)."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(0, n, (40, 3))
    return c, rng.uniform(n * 0.03, n * 0.12, 40)


def device_tags(n: int, device, seed: int = 0):
    """Object ids of ``bench.make_scene(n)`` on the card: each cell the
    1-based index of the first sphere that holds it (make_scene's float64
    test), 0 where none does; int64 [n, n, n]."""
    import torch

    c, r = scene_spheres(n, seed)
    ii = torch.arange(n, dtype=torch.float64, device=device)
    tags = torch.zeros((n, n, n), dtype=torch.int64, device=device)
    for k in range(40):
        x2, y2, z2 = ((ii - float(c[k, a])) ** 2 for a in range(3))
        inside = (x2[:, None, None] + y2[None, :, None] + z2[None, None, :]) <= float(r[k] ** 2)
        tags = torch.where(inside & (tags == 0), k + 1, tags)
    return tags


def baseline_image(n: int = CONFIG1_N, seed: int = 3, rects: int = 12) -> np.ndarray:
    """``scripts/validate_baseline.py``'s config #1 image: uint8 [n, n]."""
    rng = np.random.default_rng(seed)
    img = np.zeros((n, n), np.uint8)
    for _ in range(rects):
        y, x = rng.integers(16, n - 16, 2)
        h, w = rng.integers(4, 24, 2)
        img[y : y + h, x : x + w] = 1
    return img


def exact_d2(mask: np.ndarray) -> np.ndarray:
    """Exact int64 squared cell distances to the True cells of ``mask`` (at
    least one), from scipy's nearest-feature indices."""
    from scipy import ndimage

    _, idx = ndimage.distance_transform_edt(~mask, return_indices=True)
    return ((idx - np.indices(mask.shape)).astype(np.int64) ** 2).sum(0)


def max_ulps(a, b) -> int:
    """The largest distance in float32 units in the last place between two
    float32 tensors of one shape (+0 and -0 equal, NaN equal to NaN)."""
    import torch

    def ordered(x):
        i = x.detach().cpu().contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)

    a, b = a.detach().cpu(), b.detach().cpu()
    d = (ordered(a) - ordered(b)).abs()
    d = torch.where(torch.isnan(a) & torch.isnan(b), 0, d)
    return int(d.max()) if d.numel() else 0


def scene_slice(n: int, c, r, x: int) -> np.ndarray:
    """x-slice ``x`` of ``bench.make_scene(n)`` by its own numpy formula."""
    ii = np.arange(n)
    out = np.zeros((n, n), bool)
    for k in range(40):
        x2 = (ii - c[k, 0]) ** 2
        y2 = (ii - c[k, 1]) ** 2
        z2 = (ii - c[k, 2]) ** 2
        out |= (x2[x] + y2[:, None] + z2[None, :]) <= r[k] ** 2
    return out


def random_winners(shape, axis: int, dtype, device, seed: int):
    """Winners along ``axis`` drawn uniformly from [-1, n]: not monotone, so
    K7 revisits rows, and -1 and n (outside the line) add nowhere."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(-1, shape[axis] + 1, shape, generator=gen, device=device, dtype=torch.int32).to(dtype)


def envelope_cases(n: int, axis: int, device, seed: int, width: int = ENVELOPE_WIDTH):
    """(label, int32 field) with a scanned ``axis`` of length n and the other
    axes ``width`` wide: values drawn from four with INF_D2 among them and
    from four finite ones (heavy ties), all INF_D2 (seedless lines), and one
    seed of value < 3n per line, INF_D2 elsewhere. The finite one comes last:
    K3 takes it as its second field, so that no cell is INF_D2 in both
    (inf - inf)."""
    import torch
    from sdf_tools_tpu_torch.ops.edt import INF_D2

    shape = [3, width, width]
    shape[axis] = n
    rng = np.random.default_rng(seed)
    ties = rng.choice(np.array([0, 1, 4, INF_D2], np.int32), shape)
    single = np.full(shape, INF_D2, np.int32)
    moved = np.moveaxis(single, axis, -1)  # a view: lines along the last axis
    lines = moved.reshape(-1, n)
    lines[np.arange(len(lines)), rng.integers(0, n, len(lines))] = rng.integers(0, 3 * n, len(lines))
    moved[...] = lines.reshape(moved.shape)
    finite = rng.choice(np.array([0, 1, 4, 9], np.int32), shape)
    cases = (("ties", ties), ("all-INF", np.full(shape, INF_D2, np.int32)), ("single-seed", single),
             ("ties-finite", finite))
    return [(label, torch.as_tensor(f, device=device)) for label, f in cases]


def line_pass_case(X: int, Y: int, Z: int, seed: int) -> np.ndarray:
    """uint8 [X, Y, Z] mask with seed values 1..255, one kind of column
    after another: seedless, full, seeds only on a chunk's row 0 or row 31
    and their complements, only on row 32, one seed in the last chunk, two
    far apart, and random densities."""
    rng = np.random.default_rng(seed)
    x = np.arange(X)[:, None]
    kind = np.arange(Y * Z)[None, :] % 12
    last = rng.integers(((X - 1) // 32) * 32, X, Y * Z)[None, :]
    cols = rng.random((X, Y * Z)) < rng.random(Y * Z)[None, :] ** 3
    for k, col in enumerate((x < 0, x >= 0, x % 32 == 0, x % 32 == 31, x % 32 != 0, x % 32 != 31,
                             x == min(32, X - 1), x == last, (x == 3) | (x == X - 4))):
        cols = np.where(kind == k, col, cols)
    values = rng.integers(1, 256, cols.shape)
    return np.where(cols, values, 0).astype(np.uint8).reshape(X, Y, Z)


def cht_cases(n: int, axis: int, device, seed: int):
    """K9's own edges with a scanned ``axis`` of length n: values drawn from
    CHT_CLAMP - 4, - 1, +0, + 1, + 4 and INF_D2 (a source at the clamp stays
    on the hull, one above it is left out), and the convex profile
    3 (j - n/2)^2, on which every source stays on the hull."""
    import torch
    from sdf_tools_tpu_torch.ops.edt import INF_D2
    from sdf_tools_tpu_torch.ops.edt_cuda import CHT_CLAMP

    shape = [3, ENVELOPE_WIDTH, ENVELOPE_WIDTH]
    shape[axis] = n
    rng = np.random.default_rng(seed)
    near = rng.choice(np.array([CHT_CLAMP + d for d in (-4, -1, 0, 1, 4)] + [INF_D2], np.int32), shape)
    profile = (3 * (np.arange(n) - n // 2) ** 2).astype(np.int32)
    convex = np.broadcast_to(np.moveaxis(profile[:, None, None], 0, axis), shape).copy()
    return [(label, torch.as_tensor(f, device=device)) for label, f in (("near-clamp", near), ("convex", convex))]


# ---- the training path (phase 5), on any device -------------------------


def ft_field_grad(occ_base, resolution, backend="auto"):
    """(FT signed values, d sum(values^2) / d occupancy)."""
    from sdf_tools_tpu_torch import sdf_from_occupancy_ft

    occ = occ_base.clone().requires_grad_(True)
    values = sdf_from_occupancy_ft(occ, resolution, backend)
    (values**2).sum().backward()
    return values.detach(), occ.grad


def render_value_and_grad(values, meta, oob_value, o, v, kw):
    """(sum(depth^2), its gradient w.r.t. the field values, the render)."""
    from sdf_tools_tpu_torch import SdfGrid, render_depth

    vals = values.detach().requires_grad_(True)
    r = render_depth(SdfGrid.create(vals, meta, oob_value), o, v, **kw)
    loss = (r.depth**2).sum()
    loss.backward()
    return loss.detach(), vals.grad, r


def train_step(logits, target, meta, oob_value, o, v, kw):
    """(loss, d loss / d logits) of logits -> sigmoid -> FT signed field ->
    render -> mean (depth - target)^2."""
    import torch
    from sdf_tools_tpu_torch import SdfGrid, render_depth, sdf_from_occupancy_ft

    lg = logits.detach().requires_grad_(True)
    values = sdf_from_occupancy_ft(torch.sigmoid(lg), meta.resolution_float)
    r = render_depth(SdfGrid.create(values, meta, oob_value), o, v, **kw)
    loss = ((r.depth - target) ** 2).mean()
    loss.backward()
    return loss.detach(), lg.grad


def plane_tables(sdf, o, v, t_max):
    """The plane render's precompute for camera rays (o, v) [h, w, 3]."""
    from sdf_tools_tpu_torch.ops import render_plane

    rays = render_plane.prepare_rays(o, v)
    return rays, render_plane.plane_sweep_tables(sdf.values, sdf.meta, rays.origins, rays.directions, 0.0, t_max)


def plane_split(sdf, o, v, kw):
    """CUDA-event ms of the plane render's stages, as ``plane_sweep_depth``
    runs them: precompute, K8, the verification tail, the march fallback."""
    import torch
    from sdf_tools_tpu_torch.ops import render, render_plane

    t_max, eps, max_steps = kw["t_max"], kw["eps"], kw["max_steps"]
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    ev[0].record()
    rays, tables = plane_tables(sdf, o, v, t_max)
    ev[1].record()
    kout = render_plane.plane_sweep_rows(tables.tab, tables.ch, tables.vols, eps, t_max)
    ev[2].record()
    unresolved = tables.unresolved_row[:, None].expand(-1, render_plane.LANES).reshape(-1)
    tail = render_plane.verify_tail(
        sdf.values, sdf.meta, rays.origins, rays.directions, tables.info["tc1"], unresolved, kout,
        0.0, t_max, eps, max_steps, None,
    )
    ev[3].record()
    if bool(tail.unresolved.any()):
        w = tail.unresolved.nonzero()[:, 0]
        render._trace_depth(sdf, rays.origins[w], rays.directions[w], 0.0, t_max, eps, max_steps, None)
    ev[4].record()
    ev[4].synchronize()
    return [ev[i].elapsed_time(ev[i + 1]) for i in range(4)]


def k8_bound(tables, exec_rows):
    """(bound ms, "bytes" or "operations", detail) of one K8 launch on these
    tables. Bytes: the used channels and outputs of every ray, the table,
    and each distinct field cell inside the boxes of the slabs the rows
    executed (``render_plane.slab_footprints``: every corner cell the
    slab reads), at the peak memory rate. Operations: for each slab a row
    executed, K8_OPS_PER_PLANE for each of its lanes' 17 planes,
    K8_OPS_PER_SAMPLE for each valid sample and K8_OPS_PER_PAIR for each
    valid pair (the counts of this run's tables), at the float32 peak."""
    import torch
    from sdf_tools_tpu_torch.ops import render_plane as rp

    tab = tables.tab
    R = tab.shape[0]
    fp = rp.slab_footprints(tab, tables.ch, tables.vols, exec_rows)
    cells = 0
    axis = tab[fp["row"], 1]
    for a, vol in enumerate(tables.vols):
        on = (axis == a) & (fp["p1"] >= fp["p0"])
        if vol is None or not bool(on.any()):
            continue
        mark = torch.zeros(vol.shape, dtype=torch.bool, device=tab.device)
        x0 = (fp["xb"] + fp["p0"])[on].tolist()
        x1 = (fp["xb"] + fp["p1"])[on].tolist()
        y0, y1, z0, z1 = (fp[k][on].tolist() for k in ("y0", "y1", "z0", "z1"))
        for box in zip(x0, x1, y0, y1, z0, z1):
            mark[box[0] : box[1] + 1, box[2] : box[3] + 1, box[4] : box[5] + 1] = True
        cells += int(mark.sum())
        del mark
    planes = int(exec_rows.sum()) * rp.LANES * rp.PB
    samples, pairs = int(fp["samples"].sum()), int(fp["pairs"].sum())
    n_bytes = R * rp.LANES * K8_BYTES_PER_RAY + tab.numel() * 4 + cells * 4
    n_ops = K8_OPS_PER_PLANE * planes + K8_OPS_PER_SAMPLE * samples + K8_OPS_PER_PAIR * pairs
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / FP32_OPS_PER_S * 1e3
    detail = dict(bytes=n_bytes, field_cells=cells, lane_planes=planes, samples=samples, pairs=pairs, ops=n_ops,
                  bytes_ms=bytes_ms, ops_ms=ops_ms)
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations"), detail


def device_profile(fn):
    """(kernels launched, device busy ms, wall ms) of one call of ``fn``
    under ``torch.profiler``: busy is the sum of the CUDA kernel intervals
    (one stream), wall the host clock around the call and a synchronize."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return len(kernels), sum(e.time_range.elapsed_us() for e in kernels) / 1e3, wall


def initial_logits(mask, shift):
    """+3 on the mask shifted ``shift`` cells along x, -3 elsewhere."""
    import torch

    shifted = torch.zeros_like(mask)
    shifted[shift:] = mask[:-shift]
    return torch.where(shifted, 3.0, -3.0)


def query_surface_phase(dev, engine, mask_np: np.ndarray, q_np: np.ndarray, smi: str) -> dict:
    """Phase 8: BASELINE configs #1-#3 and the query surface on the card
    (module docstring). Returns the launches of its checked runs."""
    import math

    import torch
    from sdf_tools_tpu_torch import CollisionMap, GridMeta, TaggedCollisionMap, collision_map_ops as cmo, utils_2d
    from sdf_tools_tpu_torch.ops import edt, edt_cuda, image_sdf, query, voxelize

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    eye = torch.eye(4, device=dev)
    stage_ms, stage_peak, total = {}, {}, {}

    def run(name: str, fn, want: dict, host_clock: bool = False, verify=None):
        """One checked run of a stage with the launch counts and the peak
        memory reset before and read after (the launches must equal
        ``want``), then STAGE_RUNS timed ones.
        Returns the checked run's output, or with ``verify`` passes it there
        and drops it before the timed runs."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        edt_cuda.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        stage_peak[name] = torch.cuda.max_memory_allocated()
        got = {k: c for k, c in edt_cuda.LAUNCHES.items() if c}
        log(f"[phase8] {name}: LAUNCHES {json.dumps(got)}")
        check(got == want, f"{name}: launches {got}, want exactly {want}")
        for k, c in got.items():
            total[k] = total.get(k, 0) + c
        if verify is not None:
            verify(out)
            out = None
        stage_ms[name] = [timed(fn, host_clock)[1] for _ in range(STAGE_RUNS)]
        return out

    def same_bits(x, y) -> bool:
        return torch.equal(x.contiguous().view(torch.int32), y.contiguous().view(torch.int32))

    k123 = {"line_pass_dual": 1, "envelope_dual": 1, "envelope_dual_combine": 1}

    # ---- (1) config #1: the 256^2 image ---------------------------------
    img = baseline_image()
    sdf1, grad1 = run(f"config1 utils_2d.compute_sdf_and_gradient {CONFIG1_N}^2",
                      lambda: utils_2d.compute_sdf_and_gradient(img, 1.0, [0.0, 0.0], device=dev), k123, host_clock=True)
    signed, _, _ = run(f"config1 image_sdf {CONFIG1_N}^2", lambda: image_sdf.image_sdf(img, device=dev),
                       {"line_pass_dual": 1, "envelope_dual": 2})
    occ1 = (img.T == 1)[:, :, None]
    want1 = (np.sqrt(exact_d2(occ1)) - np.sqrt(exact_d2(~occ1)))[:, :, 0].T
    err1 = float(np.abs(sdf1 - want1).max())
    inside_neg, outside_pos = bool((sdf1[img == 1] < 0).all()), bool((sdf1[img == 0] > 0).all())
    ulps_img = max_ulps(signed, torch.as_tensor(sdf1))
    cpu1 = utils_2d.compute_sdf_and_gradient(img, 1.0, [0.0, 0.0], device="cpu")
    ulps_sdf1, ulps_grad1 = max_ulps(torch.as_tensor(sdf1), torch.as_tensor(cpu1[0])), max_ulps(
        torch.as_tensor(grad1), torch.as_tensor(cpu1[1]))
    gnorm = float(np.linalg.norm(grad1, axis=-1)[8:-8, 8:-8].mean())
    log(f"[phase8] config #1 {CONFIG1_N}^2: max |err| vs scipy's exact EDT {err1:.3e}, inside negative {inside_neg}, outside"
        f" positive {outside_pos}; image_sdf vs utils_2d {ulps_img} ulp; card vs CPU: field {ulps_sdf1} ulp,"
        f" gradient {ulps_grad1} ulp; interior |grad| mean {gnorm:.6f}")
    check(err1 < CONFIG1_ERR_MAX and inside_neg and outside_pos, "config #1 against the exact EDT")
    check(ulps_img <= 1, "config #1: image_sdf differs from utils_2d beyond f32 rounding")
    check(max(ulps_sdf1, ulps_grad1) <= CPU_MAX_ULPS, "config #1: card vs CPU")

    # ---- (2) config #2: the 64^3 tutorial map ---------------------------
    n2, res2 = CONFIG2_N, CONFIG2_RES
    occ2 = np.zeros((n2,) * 3, np.float32)
    occ2[8:24, 8:24, 8:24] = 1.0
    occ2[40:56, 32:48, 8:40] = 1.0
    meta2 = GridMeta.create(eye, res2, occ2.shape, device=dev)
    cmap2 = CollisionMap.create(occ2, meta2)
    sdf2, (mx2, mn2) = run(f"config2 extract_sdf {CONFIG2_N}^3", lambda: cmo.extract_sdf(cmap2, math.inf), k123)
    mask2 = occ2 > 0.5
    d2f, d2e = exact_d2(mask2), exact_d2(~mask2)
    a2, b2 = edt.squared_edt_both(torch.as_tensor(mask2, device=dev))
    mism = int((a2.cpu().numpy() != d2f).sum() + (b2.cpu().numpy() != d2e).sum())
    want2 = (np.sqrt(d2f.astype(np.float64)) - np.sqrt(d2e.astype(np.float64))) * res2
    got2 = sdf2.values.cpu().numpy()
    ulp2 = float((np.abs(got2 - want2.astype(np.float32)) / np.maximum(np.abs(want2), 1e-12)
                  / np.finfo(np.float32).eps).max())
    occ2u = occ2.copy()
    occ2u[30:36, 28:34, 44:50] = 0.5  # unknown cells, in free space
    cmap2u = CollisionMap.create(occ2u, meta2)
    unk = {}
    for flag in (False, True):
        got = cmo.extract_sdf(cmap2u, math.inf, unknown_is_filled=flag)[0].values
        plain = edt.signed_field_from_masks(cmap2u.filled_mask(flag), res2, "plain")[0]
        unk[flag] = same_bits(got, plain) and bool(((got[30:36, 28:34, 44:50] < 0) == flag).all())
    border = cmo.extract_sdf(cmap2, math.inf, add_virtual_border=True)[0].values
    border_ok = same_bits(border, edt.signed_field_virtual_border(cmap2.filled_mask(), res2, "plain")[0])
    log(f"[phase8] config #2 {CONFIG2_N}^3: d^2 mismatches vs scipy {mism}, combine {ulp2:.2f} ulp of the float64 math,"
        f" max {float(mx2):.6f} min {float(mn2):.6f}; unknown cells as free / filled bitwise with the plain chain"
        f" {unk[False]} / {unk[True]}; virtual border bitwise {border_ok}")
    check(mism == 0 and ulp2 <= CONFIG2_ULP_MAX and unk[False] and unk[True] and border_ok, "config #2")
    del a2, b2

    # ---- (3) config #3: point cloud -> 256^3 -> queries -----------------
    n3, res3 = CONFIG3_N, CONFIG3_RES
    rng = np.random.default_rng(0)
    cloud = np.concatenate([rng.uniform(0.2 * n3 * res3, 0.5 * n3 * res3, (6000, 3)),
                            rng.uniform(0.6 * n3 * res3, 0.9 * n3 * res3, (6000, 3))]).astype(np.float32)
    pts200 = rng.uniform(-0.1, n3 * res3 + 0.1, size=(200, 3)).astype(np.float32)
    pts1m = np.random.default_rng(1).uniform(-0.1, n3 * res3 + 0.1, (N_QUERIES, 3)).astype(np.float32)
    meta3 = GridMeta.create(eye, res3, (n3,) * 3, device=dev)
    cloud_t = torch.as_tensor(cloud, device=dev)

    def build3():
        cmap = CollisionMap.create(voxelize.voxelize_points(cloud_t, meta3), meta3)
        return cmo.extract_sdf(cmap, -10000.0)[0]

    sdf3 = run(f"config3 voxelize + extract_sdf {CONFIG3_N}^3", build3, k123)
    check(same_bits(sdf3.values, edt.signed_field_from_masks(
        voxelize.voxelize_points(cloud_t, meta3) > 0.5, res3, "plain")[0]), "config #3: field != plain chain")

    def queries3(sdf, p):
        d, ok = query.estimate_distance(sdf, p)
        g, gok = query.gradient(sdf, sdf.meta.location_to_index(p), enable_edge_gradients=True)
        return d, ok, g, gok

    q3 = torch.as_tensor(pts1m, device=dev)
    out1m = run(f"config3 estimate_distance + gradient, {N_QUERIES} points", lambda: queries3(sdf3, q3), {})
    out200 = queries3(sdf3, torch.as_tensor(pts200, device=dev))
    sdf3_cpu = sdf3.to("cpu")
    bad = {"distance": 0, "bounds": 0, "gradient": 0}
    for label, out, p in (("200", out200, pts200), ("1M subset", tuple(x[:CPU_SUBSET] for x in out1m), pts1m[:CPU_SUBSET])):
        want = queries3(sdf3_cpu, torch.as_tensor(p))
        d, ok, g, gok = (x.cpu() for x in out)
        bad["bounds"] += int((ok != want[1]).sum() + (gok != want[3]).sum())
        both, gboth = ok & want[1], gok & want[3]
        bad["distance"] += int((~torch.isclose(d, want[0], **CONFIG3_DIST_TOL) & both).sum())
        bad["gradient"] += int((~torch.isclose(g, want[2], **CONFIG3_GRAD_TOL) & gboth[:, None]).any(-1).sum())
    log(f"[phase8] config #3 {CONFIG3_N}^3 ({int((sdf3.values < 0).sum())} filled cells): card vs CPU on the validator's 200"
        f" points and {CPU_SUBSET} of {N_QUERIES}: {json.dumps(bad)} outside the validator's bars; in bounds"
        f" {int(out1m[1].sum())} of {N_QUERIES}")
    check(not any(bad.values()), "config #3: card vs CPU")
    del out1m, q3, sdf3_cpu

    # ---- (4) the query surface on phase 4's 512^3 field -----------------
    mask4 = torch.as_tensor(mask_np, device=dev)
    sdf4 = engine.sdf_from_occupancy(mask4)
    q = torch.as_tensor(q_np, device=dev)
    res4 = engine.meta.resolution_float
    vals4 = run(f"get_value_by_location {N_QUERIES}", lambda: sdf4.get_value_by_location(q), {})
    smooth4 = run(f"smooth_gradient {N_QUERIES}", lambda: query.smooth_gradient(sdf4, q, SMOOTH_WINDOW), {})
    bound4 = run(f"distance_to_boundary {N_QUERIES}", lambda: query.distance_to_boundary(sdf4, q), {})
    sdf4_cpu = sdf4.to("cpu")
    qs = q[:CPU_SUBSET].cpu()
    v_cpu, s_cpu, b_cpu = (sdf4_cpu.get_value_by_location(qs), query.smooth_gradient(sdf4_cpu, qs, SMOOTH_WINDOW),
                           query.distance_to_boundary(sdf4_cpu, qs))
    v_ok = same_bits(vals4[0][:CPU_SUBSET].cpu(), v_cpu[0]) and torch.equal(vals4[1][:CPU_SUBSET].cpu(), v_cpu[1])
    s_err = float((smooth4[0][:CPU_SUBSET].cpu() - s_cpu[0]).abs().max())
    s_ok = s_err <= SMOOTH_ATOL and torch.equal(smooth4[1][:CPU_SUBSET].cpu(), s_cpu[1])
    b_ok = same_bits(bound4[0][:CPU_SUBSET].cpu(), b_cpu[0]) and torch.equal(bound4[1][:CPU_SUBSET].cpu(), b_cpu[1])
    log(f"[phase8] {N}^3 queries card vs CPU on {CPU_SUBSET}: get_value_by_location bitwise {v_ok}; smooth_gradient"
        f" max |diff| {s_err:.3e} (atol {SMOOTH_ATOL:.1e}), flags equal; distance_to_boundary bitwise {b_ok};"
        f" smooth valid {int(smooth4[1].sum())} of {N_QUERIES}")
    check(v_ok and s_ok and b_ok, f"{N}^3 queries: card vs CPU")
    del vals4, smooth4, bound4

    full4 = run(f"full_gradient {N}^3", lambda: query.full_gradient(sdf4), {})
    check(full4.shape == (N, N, N, 3), "full_gradient shape")
    worst = 0
    for x in FULL_GRADIENT_SLICES:
        lo, hi = max(x - 1, 0), min(x + 2, N)
        slab = type(sdf4_cpu)(sdf4_cpu.values[lo:hi].contiguous(),
                              GridMeta.create(torch.eye(4), res4, (hi - lo, N, N), device="cpu"), sdf4_cpu.oob_value)
        worst = max(worst, max_ulps(full4[x], query.full_gradient(slab)[x - lo]))
    log(f"[phase8] full_gradient {N}^3 card vs CPU on x-slices {list(FULL_GRADIENT_SLICES)}: max {worst} ulp")
    check(worst <= CPU_MAX_ULPS, "full_gradient: card vs CPU")
    del full4

    gen = torch.Generator(device=dev).manual_seed(7)
    cells = mask4.nonzero()
    cells = cells[torch.randint(0, cells.shape[0], (PROJECT_POINTS,), generator=gen, device=dev)]
    jitter = (torch.rand((PROJECT_POINTS, 3), generator=gen, device=dev) - 0.5) * 0.8
    p_in = (cells.to(torch.float32) + 0.5 + jitter) * res4
    d_in = query.estimate_distance(sdf4, p_in)[0]
    proj = run(f"project_out_of_collision {PROJECT_POINTS} points",
               lambda: query.project_out_of_collision(sdf4, p_in, PROJECT_MIN_DIST, max_steps=PROJECT_MAX_STEPS,
                                                      diag=True), {}, host_clock=True)
    p_out, success, diag = proj
    d_out = query.estimate_distance(sdf4, p_out)[0]
    rate = float(success.float().mean())
    clear = bool((d_out[success] > PROJECT_MIN_DIST).all())
    k = PROJECT_CPU_POINTS
    pc, sc = query.project_out_of_collision(sdf4_cpu, p_in[:k].cpu(), PROJECT_MIN_DIST, max_steps=PROJECT_MAX_STEPS)
    dc = query.estimate_distance(sdf4_cpu, pc)[0]
    p_err = float((p_out[:k].cpu() - pc).abs().max())
    d_err = float((d_out[:k].cpu() - dc).abs().max())
    near = (dc - PROJECT_MIN_DIST).abs() <= PROJECT_ATOL
    s_same = bool(((success[:k].cpu() == sc) | near).all())
    log(f"[phase8] project_out_of_collision {PROJECT_POINTS} points in obstacles (start distance min"
        f" {float(d_in.min()):.4f} max {float(d_in.max()):.4f}): success {rate:.6f}, every success clear of"
        f" {PROJECT_MIN_DIST} {clear}; {diag['steps']} steps, {diag['host_checks']} host checks, {diag['nudges']} steps"
        f" below the coordinates' float32 spacing replaced; card vs CPU on {k}:"
        f" points max |diff| {p_err:.3e}, distances {d_err:.3e}, success equal away from the minimum distance {s_same}")
    check(rate >= PROJECT_SUCCESS_MIN and clear, "project_out_of_collision: success or clearance")
    check(p_err <= PROJECT_ATOL and d_err <= PROJECT_ATOL and s_same, "project_out_of_collision: card vs CPU")
    del proj, p_out, success, d_out, p_in, cells, sdf4, sdf4_cpu, mask4, q

    # ---- (5) a tagged map: make_scene(256)'s spheres as objects ---------
    nt = TAGGED_N
    tags = device_tags(nt, dev)
    check(torch.equal(tags > 0, device_scene(nt, dev)[0]), f"tagged map: its occupancy != make_scene({nt})")
    tmap = TaggedCollisionMap.create((tags > 0).to(torch.float32), tags, GridMeta.create(eye, RES, tags.shape, device=dev))
    ids = [i for i in torch.unique(tags).tolist() if i > 0]
    filled = tmap.filled_mask()

    def plain(mask):
        return edt.signed_field_from_masks(mask, RES, "plain")[0]

    pick = [ids[0], ids[len(ids) // 2]]
    one = run("tagged extract_tagged_sdf, one id", lambda: cmo.extract_tagged_sdf(tmap, objects_to_use=pick[:1]), k123)
    two = run("tagged extract_tagged_sdf, two ids", lambda: cmo.extract_tagged_sdf(tmap, objects_to_use=pick), k123)
    ok_t = same_bits(one[0].values, plain(filled & (tags == pick[0])))
    ok_t &= same_bits(two[0].values, plain(filled & ((tags == pick[0]) | (tags == pick[1]))))
    del one, two
    k2 = {k: 2 * c for k, c in k123.items()}
    fn = run("tagged extract_free_and_named_objects_sdf", lambda: cmo.extract_free_and_named_objects_sdf(tmap), k2)
    free_p, named_p = plain(filled), plain(filled & (tags > 0))
    want_fn = torch.where(free_p >= 0.0, free_p, torch.where(named_p <= -0.0, named_p, torch.zeros_like(free_p)))
    ok_fn = same_bits(fn[0].values, want_fn)
    del fn, free_p, named_p, want_fn
    kn = {k: len(ids) * c for k, c in k123.items()}
    ok_o = []

    def verify_objects(objs):
        check(sorted(objs) == ids, f"make_object_sdfs: ids {sorted(objs)}, want {ids}")
        ok_o.extend(same_bits(objs[i].values, plain(filled & (tags == i))) for i in ids)

    # the 40 fields (64 MB each) are kept no longer than their check
    run("tagged make_object_sdfs, every id", lambda: cmo.make_object_sdfs(tmap), kn, verify=verify_objects)
    ok_o = all(ok_o)
    log(f"[phase8] tagged {nt}^3, {len(ids)} objects: extract_tagged_sdf (ids {pick[:1]}, {pick}) bitwise {ok_t},"
        f" free and named bitwise {ok_fn}, make_object_sdfs ({len(ids)} fields) bitwise {ok_o}, each against the"
        f" plain chain of its mask")
    check(ok_t and ok_fn and ok_o, "tagged map fields != plain chain")
    del tmap, tags, filled

    torch.cuda.synchronize()
    log(f"[timing] phase 8 stages, card: {smi}")
    for name, ts in stage_ms.items():
        log(f"[timing] {name}: {spread(ts)}; peak {stage_peak[name] / 2**30:.3f} GiB")
    log(f"[memory] phase 8 peak {max(stage_peak.values()) / 2**30:.3f} GiB (its stages' checked runs), of which"
        f" {held / 2**30:.3f} GiB held from earlier phases")
    log(f"[phase8] phase time {time.perf_counter() - t_phase:.1f} s; K1-K3 launches in its checked runs"
        f" {json.dumps(total)}")
    return total


def _plant(filled: np.ndarray) -> dict:
    """Plant the JAX topology tests' torus (a 6 x 6 x 2 ring around a 2 x 2
    hole) and hollow cube (6^3 around a 2^3 cavity) into ``filled`` (in
    place), each 5 cells inside one of the first two free PLANT_BLOCK^3
    blocks in raster order, so that it touches nothing. Returns a cell of
    each shape and of the cavity."""
    b = PLANT_BLOCK
    nb = [s // b for s in filled.shape]
    coarse = filled[: nb[0] * b, : nb[1] * b, : nb[2] * b].reshape(nb[0], b, nb[1], b, nb[2], b).any(axis=(1, 3, 5))
    free = np.argwhere(~coarse)
    check(len(free) >= 2, f"fewer than two free {b}^3 blocks to plant in")
    (x, y, z), (u, v, w) = (free[0] * b + 5).tolist(), (free[1] * b + 5).tolist()
    filled[x : x + 6, y : y + 6, z : z + 2] = True
    filled[x + 2 : x + 4, y + 2 : y + 4, z : z + 2] = False
    filled[u : u + 6, v : v + 6, w : w + 6] = True
    filled[u + 2 : u + 4, v + 2 : v + 4, w + 2 : w + 4] = False
    return {"torus": (x, y, z), "hollow_cube": (u, v, w), "cavity": (u + 2, v + 2, w + 2)}


def _scipy_components(filled: np.ndarray, dev):
    """The oracle labels of ``update_connected_components``: scipy's
    6-connected components of the filled and of the free cells, ranked by
    their first flat index (a stable sort on the card). Returns (labels
    int64 on ``dev``, count)."""
    import torch
    from scipy import ndimage

    s6 = ndimage.generate_binary_structure(3, 1)
    lab_f, n_f = ndimage.label(filled, s6)
    lab_e, n_e = ndimage.label(~filled, s6)
    ids = torch.as_tensor(np.where(filled, lab_f, lab_e + n_f), device=dev).reshape(-1).to(torch.int64)
    del lab_f, lab_e
    vals, order = torch.sort(ids, stable=True)
    starts = torch.ones_like(vals, dtype=torch.bool)
    starts[1:] = vals[1:] != vals[:-1]
    present, first = vals[starts], order[starts]
    del vals, order
    rank = torch.zeros(n_f + n_e + 1, dtype=torch.int64, device=dev)
    rank[present[torch.argsort(first)]] = torch.arange(1, len(present) + 1, device=dev)
    return rank[ids].view(filled.shape), n_f + n_e


def _numpy_surface_rules(lab: np.ndarray, filled: np.ndarray, pad_lo: bool, pad_hi: bool):
    """component_surface_mask, surface_mask_26 and candidate_corner_mask of
    the interior x-planes of a slab with one plane of neighbours on each
    side (``pad_lo`` / ``pad_hi``: that side is the grid's border), by the
    rules as stated: a cell is on a component surface if one of its 6
    neighbours holds another label or lies off the grid; a filled cell is
    on the 26-surface unless all 26 neighbours are filled cells of the
    grid; a corner has 2 or more of its in-grid 6 neighbours labelled
    otherwise."""
    px = (int(pad_lo), int(pad_hi))
    L = np.pad(lab, (px, (1, 1), (1, 1)), constant_values=-1)
    F = np.pad(filled, (px, (1, 1), (1, 1)), constant_values=False)
    V = np.pad(np.ones(lab.shape, bool), (px, (1, 1), (1, 1)), constant_values=False)
    X, Y, Z = L.shape[0] - 2, L.shape[1] - 2, L.shape[2] - 2

    def at(a, dx, dy, dz):
        return a[1 + dx : 1 + dx + X, 1 + dy : 1 + dy + Y, 1 + dz : 1 + dz + Z]

    c = at(L, 0, 0, 0)
    surf = np.zeros(c.shape, bool)
    count = np.zeros(c.shape, np.int32)
    for d in ((1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1)):
        differs = at(L, *d) != c
        surf |= differs
        count += at(V, *d) & differs
    all26 = np.ones(c.shape, bool)
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                if (dx, dy, dz) != (0, 0, 0):
                    all26 &= at(F, dx, dy, dz)
    return surf, at(F, 0, 0, 0) & ~all26, count >= 2


def _enclosure_oracle(filled: np.ndarray, comp: np.ndarray, n: int):
    """Expected voids per component (labels ``comp``, 1..n) from scipy's
    clusters: a component's surface has one connected set for each
    26-connected cluster of the other kind it touches (obstacles for a free
    component, free space for an obstacle; two of one kind that touch
    across an edge or a corner share a surface there), except that those
    that touch the grid's border, and the component's own border cells,
    merge into one. Its voids are its sets less one. Returns (voids [n] by
    the 26-connected clusters, voids [n] by the other kind's 6-connected
    components, shared: the components whose own 26-cluster holds several
    6-components, where either count is admitted)."""
    from scipy import ndimage

    s26 = np.ones((3, 3, 3), bool)
    ball = ndimage.generate_binary_structure(3, 1)
    clusters = {True: ndimage.label(filled, s26)[0], False: ndimage.label(~filled, s26)[0]}
    border = np.zeros(filled.shape, bool)
    for ax in range(3):
        border[(slice(None),) * ax + (0,)] = border[(slice(None),) * ax + (-1,)] = True
    on_border = {k: set(np.unique(v[border]).tolist()) - {0} for k, v in clusters.items()}
    comp_on_border = set(np.unique(comp[border]).tolist())
    want26, want6 = np.zeros(n, np.int64), np.zeros(n, np.int64)
    shared = set()
    for c, sl in enumerate(ndimage.find_objects(comp), start=1):
        box = tuple(slice(max(s_.start - 1, 0), s_.stop + 1) for s_ in sl)
        member = comp[box] == c
        kind = bool(filled[box][member][0])
        own = clusters[kind][box][member][0]
        in_own = comp[clusters[kind] == own]
        if in_own.min() != in_own.max():
            shared.add(c)
        ring = ndimage.binary_dilation(member, ball) & ~member  # the other kind only
        own_border = bool((border[box] & member).any())
        for want, ids, at_edge in ((want26, clusters[not kind][box][ring], on_border[not kind]),
                                   (want6, comp[box][ring], comp_on_border)):
            touching = set(np.unique(ids).tolist()) - {0}
            at_border = touching & at_edge
            sets = len(touching - at_border) + int(bool(at_border) or own_border)
            want[c - 1] = max(sets - 1, 0)
    return want26, want6, shared


def _census_check(name: str, census_np: np.ndarray, filled: np.ndarray, comp: np.ndarray, n: int) -> str:
    """Hold a census's voids to ``_enclosure_oracle``: every row equal to
    the 26-cluster count, or, for a shared component, to the 6-component
    count. Returns the log text; fails the run otherwise."""
    want26, want6, shared = _enclosure_oracle(filled, comp, n)
    diff = [c + 1 for c in np.flatnonzero(census_np[:, 1] != want26)]
    unexplained = [c for c in diff if c not in shared or census_np[c - 1, 1] != want6[c - 1]]
    check(not unexplained, f"{name}: census voids != scipy's enclosures for components"
          f" {[(c, census_np[c - 1].tolist(), int(want26[c - 1]), int(want6[c - 1])) for c in unexplained]}")
    free = int(comp.reshape(-1)[np.argmax(~filled.reshape(-1))]) if not filled.all() else None
    return (f"free space (label {free}) {census_np[free - 1].tolist() if free else None}, voids by scipy"
            f" {int(want26[free - 1]) if free else None}; rows differing from the 26-cluster count"
            f" {[(c, census_np[c - 1].tolist(), int(want26[c - 1])) for c in diff]}, each a shared"
            f" component equal to its 6-component count; {len(shared)} shared components")


def map_topology_phase(dev, engine, mask_np: np.ndarray, smi: str) -> dict:
    """Phase 9: the planner's map topology and io on the card (module
    docstring). Returns the K1-K3 launches of its checked runs."""
    import dataclasses
    import math
    import struct
    import tempfile
    import zlib

    import torch
    from sdf_tools_tpu_torch import CollisionMap, GridMeta, TaggedCollisionMap, collision_map_ops as cmo, io
    from sdf_tools_tpu_torch.ops import edt_cuda, query, render, topology, voxelize

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    eye = torch.eye(4, device=dev)
    stage_ms, stage_peak, total = {}, {}, {}
    phase_peak = [0]

    def count(got):
        for k, c in got.items():
            total[k] = total.get(k, 0) + c

    def run(name: str, fn, want: dict):
        """One checked run (launch counts reset before and read after, which
        must equal ``want``; its peak memory), then TOPO_RUNS timed ones on
        the host clock (the loops wait on the host)."""
        torch.cuda.synchronize()
        phase_peak[0] = max(phase_peak[0], torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()
        edt_cuda.reset_launches()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        first = (time.perf_counter() - t0) * 1e3
        stage_peak[name] = torch.cuda.max_memory_allocated()
        got = {k: c for k, c in edt_cuda.LAUNCHES.items() if c}
        check(got == want, f"{name}: launches {got}, want exactly {want}")
        count(got)
        stage_ms[name] = [first] + [timed(fn, host_clock=True)[1] for _ in range(TOPO_RUNS)]
        return out

    def bits_equal(a, b) -> bool:
        a, b = a.contiguous(), b.contiguous()
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        return a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b)

    # ---- (1) components of the 512^3 map ---------------------------------
    mask = torch.as_tensor(mask_np, device=dev)
    meta = GridMeta.create(eye, RES, mask.shape, device=dev)
    cmap0 = CollisionMap.create(mask.to(torch.float32), meta)
    cmap, n, diag = run(f"update_connected_components {N}^3", lambda: cmo.update_connected_components(cmap0, diag=True), {})
    del cmap0
    t0 = time.perf_counter()
    want, want_n = _scipy_components(mask_np, dev)
    t_scipy = time.perf_counter() - t0
    ok = torch.equal(cmap.component, want) and int(n) == want_n
    del want
    ms = stage_ms[f"update_connected_components {N}^3"]
    log(f"[phase9] components {N}^3: n {int(n)} (scipy {want_n}), labels equal to scipy's ranked by first index {ok};"
        f" rounds {diag['rounds']}, host checks {diag['host_checks']}, first run {ms[0]:.1f} ms, then"
        f" {np.median(ms[1:]):.1f} ms ({np.median(ms[1:]) / diag['rounds']:.2f} ms a round); peak"
        f" {stage_peak[f'update_connected_components {N}^3'] / 2**30:.3f} GiB; scipy oracle {t_scipy:.1f} s")
    check(ok, "components 512^3 != scipy")

    # ---- (2) surfaces and corners at 512^3 --------------------------------
    comp = cmap.component
    csurf = run(f"component_surface_mask {N}^3", lambda: topology.component_surface_mask(comp), {})
    surf26 = run(f"surface_mask_26 {N}^3", lambda: topology.surface_mask_26(mask), {})
    corner = run(f"candidate_corner_mask {N}^3", lambda: topology.candidate_corner_mask(comp), {})
    ok = []
    for x0 in SURFACE_SLAB_X0:
        lo, hi = max(x0 - 1, 0), min(x0 + SURFACE_SLAB + 1, N)
        want = _numpy_surface_rules(comp[lo:hi].cpu().numpy(), mask_np[lo:hi], lo == x0, hi == x0 + SURFACE_SLAB)
        got = (m_[x0 : x0 + SURFACE_SLAB].cpu().numpy() for m_ in (csurf, surf26, corner))
        ok.append(all(np.array_equal(g, w) for g, w in zip(got, want)))
    log(f"[phase9] surfaces {N}^3: component surface {int(csurf.sum())}, 26-surface {int(surf26.sum())}, corners"
        f" {int(corner.sum())} cells; equal to numpy's rules on x-slabs {list(SURFACE_SLAB_X0)} (+{SURFACE_SLAB}) {ok}")
    check(all(ok), "surface or corner masks != numpy")
    del csurf, surf26, corner

    # the census of the 512^3 map's components
    census, cdiag = run(f"component_topology_census {N}^3",
                        lambda: topology.component_topology_census(comp, int(n), diag=True), {})
    t0 = time.perf_counter()
    text = _census_check(f"census {N}^3", census.cpu().numpy(), mask_np, comp.cpu().numpy(), int(n))
    ms = stage_ms[f"component_topology_census {N}^3"]
    log(f"[phase9] census {N}^3 ({int(n)} components): rounds {cdiag['rounds']}, host checks {cdiag['host_checks']},"
        f" {np.median(ms[1:]):.1f} ms ({np.median(ms[1:]) / cdiag['rounds']:.2f} ms a round), peak"
        f" {stage_peak[f'component_topology_census {N}^3'] / 2**30:.3f} GiB; {text}; scipy oracle"
        f" {time.perf_counter() - t0:.1f} s")
    del census

    # ---- (3) the census of the tagged map with planted shapes -------------
    nt = TAGGED_N
    tags = device_tags(nt, dev)
    filled_np = (tags > 0).cpu().numpy()
    planted = _plant(filled_np)
    tmeta = GridMeta.create(eye, RES, tags.shape, device=dev)
    tmap0 = TaggedCollisionMap.create(torch.as_tensor(filled_np, device=dev).to(torch.float32), tags, tmeta)
    tmap, tn, jdiag = run(f"update_tagged_connected_components {nt}^3",
                          lambda: cmo.update_tagged_connected_components(tmap0, diag=True), {})
    tn = int(tn)
    want, want_n = _scipy_components(filled_np, dev)
    check(torch.equal(tmap.component, want) and tn == want_n, "tagged components != scipy")
    del want
    # the same components by the plain loop, one neighbour step a round
    plain, plain_n, pdiag = run(f"update_tagged_connected_components {nt}^3, plain loop",
                                  lambda: cmo.update_tagged_connected_components(tmap0, jump=False, diag=True), {})
    ok = torch.equal(plain.component, tmap.component) and int(plain_n) == tn
    ms_j = stage_ms[f"update_tagged_connected_components {nt}^3"]
    ms_p = stage_ms[f"update_tagged_connected_components {nt}^3, plain loop"]
    log(f"[phase9] components {nt}^3 ({tn}): rounds {jdiag['rounds']}, host checks {jdiag['host_checks']},"
        f" {np.median(ms_j[1:]):.1f} ms; the plain loop: rounds {pdiag['rounds']}, host checks"
        f" {pdiag['host_checks']}, {np.median(ms_p[1:]):.1f} ms; labels and count equal {ok}")
    check(ok, "tagged components: the loop != the plain loop")
    del plain, tmap0
    census, cdiag = run(f"component_topology_census {nt}^3",
                        lambda: topology.component_topology_census(tmap.component, tn, diag=True), {})
    census_np = census.cpu().numpy()
    check(np.array_equal(topology.compute_component_topology(tmap.component, tn), census_np.astype(np.int32)),
          "compute_component_topology != census")
    comp_np = tmap.component.cpu().numpy()
    rows = {k: tuple(census_np[comp_np[c] - 1].tolist()) for k, c in planted.items()}
    ms = stage_ms[f"component_topology_census {nt}^3"]
    log(f"[phase9] census {nt}^3 ({tn} components): rounds {cdiag['rounds']}, host checks {cdiag['host_checks']},"
        f" {np.median(ms[1:]):.1f} ms ({np.median(ms[1:]) / cdiag['rounds']:.2f} ms a round), peak"
        f" {stage_peak[f'component_topology_census {nt}^3'] / 2**30:.3f} GiB; planted rows {rows};"
        f" {_census_check(f'census {nt}^3', census_np, filled_np, comp_np, tn)}")
    check(rows["torus"] == (1, 0) and rows["hollow_cube"] == (0, 1) and rows["cavity"] == (0, 0), "planted rows")
    # card against the CPU path on a crop around the planted shapes
    x, y, z = (max(0, min(v - CENSUS_CROP // 4, nt - CENSUS_CROP)) for v in planted["torus"])
    crop = (tmap.occupancy[x : x + CENSUS_CROP, y : y + CENSUS_CROP, z : z + CENSUS_CROP] > 0.5).to(torch.int32)
    outs = []
    for c in (crop, crop.cpu()):
        lab_c, n_c = topology.connected_components_by_key(torch.ones_like(c, dtype=torch.bool), c)
        outs.append((lab_c.cpu(), int(n_c), topology.component_topology_census(lab_c, int(n_c)).cpu()))
    ok = torch.equal(outs[0][0], outs[1][0]) and outs[0][1] == outs[1][1] and torch.equal(outs[0][2], outs[1][2])
    log(f"[phase9] census card vs CPU on the {CENSUS_CROP}^3 crop at {(x, y, z)} ({outs[0][1]} components):"
        f" labels and census bitwise {ok}")
    check(ok, "census crop: card != CPU")

    # ---- (4) convex segments ---------------------------------------------
    k2 = {"line_pass_dual": 2, "envelope_dual": 2, "envelope_dual_combine": 2}
    tseg, nseg = run(f"update_convex_segments {nt}^3", lambda: cmo.update_convex_segments(tmap, CONVEX_THRESHOLD), k2)
    seg = tseg.convex_segment
    check(tseg.convex_segments_valid and 1 <= int(nseg) and int(seg.max()) == int(nseg), "convex segments")
    # card against CPU at 128^3: update_convex_segments' steps on one field
    # (the free + named SDF, its extrema map, the segments); not counted
    nc = CONVEX_CPU_N
    ext, segs = [], []
    for d in (dev, torch.device("cpu")):
        tg = device_tags(nc, d)
        m_ = TaggedCollisionMap.create((tg > 0).to(torch.float32), tg,
                                       GridMeta.create(torch.eye(4, device=d), RES, tg.shape, device=d))
        sdf_ = cmo.extract_free_and_named_objects_sdf(m_, math.inf, unknown_is_filled=True)[0]
        ext.append(topology.local_extrema_map(sdf_))
        segs.append(topology.convex_segments(m_, sdf_, CONVEX_THRESHOLD))
        del m_, sdf_
    torch.cuda.synchronize()
    edt_cuda.reset_launches()
    ext_ok = bits_equal(ext[0].cpu(), ext[1])
    ext_ulps = 0 if ext_ok else max_ulps(ext[0].cpu()[torch.isfinite(ext[1])], ext[1][torch.isfinite(ext[1])])
    seg_ok = torch.equal(segs[0][0].cpu(), segs[1][0]) and int(segs[0][1]) == int(segs[1][1])
    ms = stage_ms[f"update_convex_segments {nt}^3"]
    log(f"[phase9] convex segments {nt}^3: {int(nseg)} segments (threshold {CONVEX_THRESHOLD}), {np.median(ms[1:]):.1f} ms,"
        f" peak {stage_peak[f'update_convex_segments {nt}^3'] / 2**30:.3f} GiB; card vs CPU at {nc}^3"
        f" ({int(segs[1][1])} segments): extrema map bitwise {ext_ok} (max {ext_ulps} ulp), segment labels bitwise {seg_ok}")
    check(ext_ok or ext_ulps <= CPU_MAX_ULPS, "extrema map: card vs CPU")
    check(seg_ok, "convex segments: card vs CPU")
    del ext, segs

    # ---- (5) io round trips ----------------------------------------------
    io_rows = {}

    def header_and_cells(body: bytes, n_cells: int, fmt: str, want_rows) -> bool:
        """An independent read: 1 B initialized, two 128-B isometries, the
        uint64 count, then the cells."""
        (count_,) = struct.unpack_from("<Q", body, 1 + 2 * 128)
        size = struct.calcsize("<" + fmt)
        got = [struct.unpack_from("<" + fmt, body, 265 + i * size) for i in range(IO_RECORDS)]
        return body[0] == 1 and count_ == n_cells and got == want_rows

    def round_trip(name, grid, serialize, deserialize, fmt, rows, compress: bool):
        """pack + copy, zlib, unzip, copy + unpack: host-clock ms of each,
        the bytes, and the loaded grid."""
        t = [time.perf_counter()]
        body = serialize(grid)
        t.append(time.perf_counter())
        packed = zlib.compress(body) if compress else body
        t.append(time.perf_counter())
        body2 = zlib.decompress(packed) if compress else packed
        t.append(time.perf_counter())
        back = deserialize(body2, device=dev)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        ms_ = [(b - a) * 1e3 for a, b in zip(t, t[1:])]
        io_rows[name] = (ms_, len(body), len(packed))
        n_cells = int(np.prod(grid.meta.shape))
        check(header_and_cells(body, n_cells, fmt, rows), f"{name}: header or leading cells")
        return body, back

    def leading(*tensors):
        flat = [t_.reshape(-1)[:IO_RECORDS].cpu().tolist() for t_ in tensors]
        return [tuple(v) for v in zip(*flat)]

    def same_meta(a, b) -> bool:
        return (a.shape == b.shape and a.frame == b.frame and a.resolution_float == b.resolution_float
                and bits_equal(a.origin_transform, b.origin_transform.to(a.origin_transform.device))
                and bits_equal(a.inv_origin_transform, b.inv_origin_transform.to(a.inv_origin_transform.device)))

    def same_grid(a, b) -> bool:
        fields = [f.name for f in dataclasses.fields(a) if f.name != "meta"]
        ok_ = same_meta(a.meta, b.meta)
        for f in fields:
            x_, y_ = getattr(a, f), getattr(b, f)
            ok_ &= bits_equal(x_, y_.to(x_.device)) if isinstance(x_, torch.Tensor) else x_ == y_
        return ok_

    edt_cuda.reset_launches()
    sdf4 = engine.sdf_from_occupancy(mask)
    torch.cuda.synchronize()
    got = {k: c for k, c in edt_cuda.LAUNCHES.items() if c}
    want = {"line_pass_dual": 1, "envelope_dual": 1, "envelope_dual_combine": 1}
    check(got == want, f"the {N}^3 field: launches {got}, want exactly {want}")
    count(got)
    checks = {}
    for magic, compress in (("SDFR", False), ("SDFZ", True)):
        body, back = round_trip(f"{magic} {N}^3", sdf4, io.serialize_sdf,
                                lambda b, device: io.deserialize_sdf(b, device=device)[0],
                                "f", [(v,) for v in sdf4.values.reshape(-1)[:IO_RECORDS].cpu().tolist()], compress)
        checks[magic] = same_grid(back, sdf4) and (compress or body == io.serialize_sdf(sdf4.to("cpu")))
        del back, body
    body, back = round_trip(f"CMGZ {N}^3", cmap, lambda g: io.serialize_collision_map(g, int(n)),
                            io.deserialize_collision_map, "fI", leading(cmap.occupancy, cmap.component), True)
    cmap_cpu = CollisionMap(cmap.occupancy.cpu(), cmap.component.cpu(), cmap.meta.to("cpu"), cmap.oob_occupancy.cpu(),
                            cmap.components_valid)
    checks["CMGZ"] = same_grid(back, cmap) and body == io.serialize_collision_map(cmap_cpu, int(n))
    del back, body, cmap_cpu
    body, back = round_trip(f"TCMZ {nt}^3", tseg, io.serialize_tagged_map, io.deserialize_tagged_map, "fIII",
                            leading(tseg.occupancy, tseg.component, tseg.object_id, tseg.convex_segment), True)
    tseg_cpu = dataclasses.replace(
        tseg, occupancy=tseg.occupancy.cpu(), component=tseg.component.cpu(), object_id=tseg.object_id.cpu(),
        convex_segment=tseg.convex_segment.cpu(), meta=tseg.meta.to("cpu"), oob_occupancy=tseg.oob_occupancy.cpu())
    checks["TCMZ"] = same_grid(back, tseg) and body == io.serialize_tagged_map(tseg_cpu)
    del back, body
    t0 = time.perf_counter()
    msg = io.tagged_map_message(tseg, stamp=(1, 2), seq=3)
    t1 = time.perf_counter()
    back = io.tagged_map_from_message(msg, device=dev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    io_rows[f"ROS message {nt}^3"] = ([(t1 - t0) * 1e3, (t2 - t1) * 1e3], len(msg), len(msg))
    checks["message"] = same_grid(back, tseg) and msg == io.tagged_map_message(tseg_cpu, stamp=(1, 2), seq=3)
    del back, msg, tseg_cpu
    with tempfile.TemporaryDirectory() as tmp:
        for name, grid in ((f"SdfGrid {N}^3", sdf4), (f"CollisionMap {N}^3", cmap),
                           (f"TaggedCollisionMap {nt}^3", tseg)):
            path = str(Path(tmp) / "grid.npz")
            t0 = time.perf_counter()
            io.save_checkpoint(path, grid)
            t1 = time.perf_counter()
            back = io.load_checkpoint(path, device=dev)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            io_rows[f".npz {name}"] = ([(t1 - t0) * 1e3, (t2 - t1) * 1e3], Path(path).stat().st_size,
                                       Path(path).stat().st_size)
            checks[f".npz {name}"] = same_grid(back, grid)
            del back
    log(f"[phase9] io round trips, bitwise on the card and the card's bytes equal the CPU's: {json.dumps(checks)}")
    for name, (ms_, raw, packed) in io_rows.items():
        what = ("save, load" if name.startswith((".npz", "ROS")) else "pack + copy, zlib, unzip, copy + unpack")
        log(f"[timing] io {name}: {what} {', '.join(f'{t_:.1f}' for t_ in ms_)} ms (host clock); {raw} B"
            + (f", {packed} B compressed, ratio {raw / packed:.2f}" if packed != raw else ""))
    check(all(checks.values()), f"io round trips: {checks}")

    # ---- (6) non-finite and out-of-range points, card against CPU ----------
    pts = []
    for v in (float("nan"), float("inf"), float("-inf"), 1e30, -1e30, 3e9):
        for ax in range(3):
            p_ = [1.0, 1.0, 0.8]
            p_[ax] = v
            pts.append(p_)
    pts.append([1.0, 1.0, 0.8])
    pts = torch.tensor(pts, dtype=torch.float32)
    sdf_cpu = sdf4.to("cpu")
    up = torch.zeros_like(pts)
    up[:, 2] = 1.0

    def casts(sdf_, p_, v_, tm_):
        out = [sdf_.meta.location_to_index(p_), sdf_.meta.location_in_bounds(p_), *sdf_.get_value_by_location(p_),
               *query.estimate_distance(sdf_, p_), *query.smooth_gradient(sdf_, p_, SMOOTH_WINDOW),
               voxelize.voxelize_points(p_, tm_).nonzero(),
               *render._trace_depth(sdf_, p_, v_, 0.0, 4 * N * RES, RENDER_EPS, 4, None)]
        return [o.cpu() for o in out]

    card = casts(sdf4, pts.to(dev), up.to(dev), tmeta)
    host = casts(sdf_cpu, pts, up, tmeta.to("cpu"))
    same = [bits_equal(a, b) for a, b in zip(card, host)]
    log(f"[phase9] casts: {len(pts)} points (NaN, +-inf, +-1e30, 3e9 on each axis, one finite) through"
        f" location_to_index, location_in_bounds, get_value_by_location, estimate_distance, smooth_gradient,"
        f" voxelize_points and a 4-step march: card == CPU bitwise {same}; in bounds {card[1].tolist()}")
    check(all(same) and card[1].sum() == 1, "casts: card != CPU")
    del sdf4, sdf_cpu

    torch.cuda.synchronize()
    phase_peak[0] = max(phase_peak[0], torch.cuda.max_memory_allocated())
    log(f"[timing] phase 9 stages, card: {smi}")
    for name, ts in stage_ms.items():
        log(f"[timing] {name}: first run {ts[0]:.3f} ms, then {spread(ts[1:])} (host clock); peak"
            f" {stage_peak[name] / 2**30:.3f} GiB")
    log(f"[memory] phase 9 peak {phase_peak[0] / 2**30:.3f} GiB, of which {held / 2**30:.3f} GiB held from earlier phases")
    log(f"[phase9] phase time {time.perf_counter() - t_phase:.1f} s; K1-K3 launches {json.dumps(total)}")
    return total


def main() -> None:
    import torch

    # ---- 1. device ------------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this script runs only on a GPU")
    from bench import make_scene
    from sdf_tools_tpu_torch import GridMeta, SdfEngine, SdfGrid, _build, sdf_from_occupancy_ft
    from sdf_tools_tpu_torch.ops import edt, edt_cuda, query, render, render_plane

    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    from plane_scenes import K8_EDGE_CASES, K8_EDGE_T_MAX, k8_edge_case, sphere_values

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # ---- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    _build.library()
    log(f"[build] {_build.library_path().name} in {time.perf_counter() - t0:.3f} s")

    # ---- 3. kernels against their plain versions ------------------------
    max_err = {name: 0.0 for name in KERNELS}

    def compare(name: str, got, want, where: str, bits: bool = True) -> None:
        """Equal bit for bit, or with ``bits=False`` equal as values (K8:
        -0.0 == 0.0)."""
        for g, w in zip(got, want):
            check(g.shape == w.shape and g.dtype == w.dtype, f"{name} {where}: {g.shape}/{g.dtype} vs {w.shape}/{w.dtype}")
            same = g == w  # inf == inf; no NaN is produced
            err = 0.0 if bool(same.all()) else float((g.double() - w.double())[~same].abs().max())
            max_err[name] = max(max_err[name], err)
            if bits:
                g = g.view(torch.int32) if g.dtype == torch.float32 else g
                w = w.view(torch.int32) if w.dtype == torch.float32 else w
            check(torch.equal(g, w), f"{name} {where}: kernel != plain (max |err| {err})")

    def single_kernels_vs_plain(mask, where: str, f=None) -> None:
        """K4 in both modes on ``mask``; K5 and K9 along axes 1 and 2 on
        ``f`` (default: the mask's squared line pass) and on its axis-1
        envelope."""
        for square in (True, False):
            compare("line_pass", (edt_cuda.line_pass(mask, square),), (edt_cuda.line_pass_plain(mask, square),),
                    f"{where} {'squared' if square else 'linear'}")
        if f is None:
            f = edt_cuda.line_pass_plain(mask)
        f1 = edt_cuda.envelope_plain(f, 1)
        for axis, fin in ((1, f), (2, f1)):
            compare("envelope", (edt_cuda.envelope(fin, axis),), (edt_cuda.envelope_plain(fin, axis),),
                    f"{where} axis {axis}")
            compare("envelope_cht", (edt_cuda.envelope_cht(fin, axis),), (edt_cuda.envelope_cht_plain(fin, axis),),
                    f"{where} axis {axis}")
        torch.cuda.synchronize()

    def kernels_vs_plain(mask, where: str, training: bool = True) -> None:
        if training:
            single_kernels_vs_plain(mask, where)
        compare("line_pass_dual", edt_cuda.line_pass_dual(mask, False), edt_cuda.line_pass_dual_plain(mask, False),
                f"{where} linear")
        got = edt_cuda.line_pass_dual(mask)
        fa, fb = edt_cuda.line_pass_dual_plain(mask)
        compare("line_pass_dual", got, (fa, fb), f"{where} squared")
        for axis in (1, 2):
            got = edt_cuda.envelope_dual(fa, fb, axis)
            want = edt_cuda.envelope_dual_plain(fa, fb, axis)
            compare("envelope_dual", got, want, f"{where} axis {axis}")
        ea, eb = edt_cuda.envelope_dual_plain(fa, fb, 1)
        got = edt_cuda.envelope_dual_combine(ea, eb, RES)
        want = edt_cuda.envelope_dual_combine_plain(ea, eb, RES)
        compare("envelope_dual_combine", (got,), (want,), where)
        if training:
            training_kernels_vs_plain(mask, where)
        torch.cuda.synchronize()

    def training_kernels_vs_plain(mask, where: str, carry: bool = True) -> None:
        """K6 (winner form along axes 1 and 2 of the FT forward's inputs,
        and with three payloads) and K7 (axes 0, 1, 2 with the FT's own
        int16 winner maps, and with random int16 and int32 winners in
        [-1, n], against a random cotangent)."""
        f, x0 = edt.line_seed_d2(mask, 0)
        f1, jy = edt_cuda.envelope_argmin_plain(f, 1)
        for axis, fin in ((1, f), (2, f1)):
            compare("envelope_carry", edt_cuda.envelope_argmin(fin, axis),
                    edt_cuda.envelope_argmin_plain(fin, axis), f"{where} argmin axis {axis}")
            if carry:
                pays = (x0, fin + 1, torch.full_like(fin, -5))
                compare("envelope_carry", edt_cuda.envelope_carry(fin, pays, axis),
                        edt_cuda.envelope_carry_plain(fin, pays, axis), f"{where} carry axis {axis}")
        _, kz = edt_cuda.envelope_argmin_plain(f1, 2)
        g = torch.randn(mask.shape, device=mask.device, generator=torch.Generator(device=mask.device).manual_seed(1))
        for axis, w in ((2, kz), (1, jy), (0, x0)):
            w16 = w.to(torch.int16)
            compare("winner_segment_sum", (edt_cuda.winner_segment_sum(g, w16, axis),),
                    (edt_cuda.winner_segment_sum_plain(g, w16, axis),), f"{where} axis {axis}")
            for dtype in (torch.int16, torch.int32):
                wr = random_winners(mask.shape, axis, dtype, mask.device, seed=axis)
                compare("winner_segment_sum", (edt_cuda.winner_segment_sum(g, wr, axis),),
                        (edt_cuda.winner_segment_sum_plain(g, wr, axis),), f"{where} axis {axis} random {dtype}")

    def envelope_edges() -> None:
        """The envelope kernels against their plain versions on
        ``envelope_cases`` at every length of ENVELOPE_LINES along axes 1 and
        2: K5, K6 (winner form, and carrying three payloads) and K9 (lengths
        up to 1024; also sources at CHT_CLAMP +- 4 and the convex profile) on
        each case, K2 on each case paired with the next, K3 (axis 2) on each
        case paired with the finite ties; K6 on a line of CARRY_LONG_LINE
        along axis 2."""
        for n in ENVELOPE_LINES:
            for axis in (1, 2):
                cases = envelope_cases(n, axis, dev, seed=n + axis)
                for label, f in cases:
                    where = f"{label} n={n} axis {axis}"
                    compare("envelope", (edt_cuda.envelope(f, axis),), (edt_cuda.envelope_plain(f, axis),), where)
                    carry_vs_plain(f, axis, where)
                if n <= edt_cuda.CHT_MAX_AXIS:
                    for label, f in cases + cht_cases(n, axis, dev, seed=n + axis):
                        compare("envelope_cht", (edt_cuda.envelope_cht(f, axis),),
                                (edt_cuda.envelope_cht_plain(f, axis),), f"{label} n={n} axis {axis}")
                for (la, fa_), (lb, fb_) in zip(cases, cases[1:] + cases[:1]):
                    compare("envelope_dual", edt_cuda.envelope_dual(fa_, fb_, axis),
                            edt_cuda.envelope_dual_plain(fa_, fb_, axis), f"{la}/{lb} n={n} axis {axis}")
                if axis == 2:
                    lb, fb_ = cases[-1]
                    for la, fa_ in cases:
                        compare("envelope_dual_combine", (edt_cuda.envelope_dual_combine(fa_, fb_, RES),),
                                (edt_cuda.envelope_dual_combine_plain(fa_, fb_, RES),), f"{la}/{lb} n={n}")
        for label, f in envelope_cases(CARRY_LONG_LINE, 2, dev, seed=5, width=1):
            carry_vs_plain(f, 2, f"{label} n={CARRY_LONG_LINE} axis 2")
        torch.cuda.synchronize()

    def line_pass_edges() -> None:
        """K1 and K4 in both modes against their plain versions on
        ``line_pass_case`` masks of every length in LINE_PASS_X and every
        column shape in LINE_PASS_COLUMNS."""
        for X in LINE_PASS_X:
            for Y, Z in LINE_PASS_COLUMNS:
                m = torch.as_tensor(line_pass_case(X, Y, Z, seed=X + Y), device=dev)
                for square in (True, False):
                    where = f"uint8 {X}x{Y}x{Z} {'squared' if square else 'linear'}"
                    compare("line_pass_dual", edt_cuda.line_pass_dual(m, square),
                            edt_cuda.line_pass_dual_plain(m, square), where)
                    compare("line_pass", (edt_cuda.line_pass(m, square),), (edt_cuda.line_pass_plain(m, square),),
                            where)
        torch.cuda.synchronize()

    def carry_vs_plain(f, axis: int, where: str) -> None:
        """K6 in its winner form and carrying three payloads."""
        compare("envelope_carry", edt_cuda.envelope_argmin(f, axis), edt_cuda.envelope_argmin_plain(f, axis),
                f"{where} argmin")
        pays = (f + 1, torch.full_like(f, -5), random_winners(f.shape, axis, torch.int32, f.device, seed=6))
        compare("envelope_carry", edt_cuda.envelope_carry(f, pays, axis), edt_cuda.envelope_carry_plain(f, pays, axis),
                f"{where} carry")

    def plane_vs_plain(sdf, o, v, t_max, where: str):
        """K8 against its plain version on the tables of rays (o, v); all
        six outputs. Returns (tables, kernel outputs)."""
        _, tables = plane_tables(sdf, o, v, t_max)
        got = render_plane.plane_sweep_rows(tables.tab, tables.ch, tables.vols, RENDER_EPS, t_max)
        want = render_plane.plane_sweep_rows_plain(tables.tab, tables.ch, tables.vols, RENDER_EPS, t_max)
        compare("plane_sweep", got, want, where, bits=False)
        torch.cuda.synchronize()
        check(int(tables.tab[:, 0].sum()) > 0 and bool(got[1].any()), f"plane_sweep {where}: no active slab or no hit")
        return tables, got

    eye = torch.eye(4, device=dev)
    t0 = time.perf_counter()
    for shape in SMALL_SHAPES:
        rng = np.random.default_rng(sum(shape))
        m = rng.random(shape) < 0.12
        kernels_vs_plain(torch.as_tensor(m, device=dev), f"random {shape}")
    for fill, label in ((False, "all-empty"), (True, "all-full")):
        mask = torch.full((16, 24, 32), fill, dtype=torch.bool, device=dev)
        kernels_vs_plain(mask, label)
        a, b = edt.squared_edt_both(mask)
        seedless, seeded = (a, b) if not fill else (b, a)
        check(bool((seedless == edt.INF_D2).all()), f"{label}: seedless field is not exactly INF_D2")
        check(bool((seeded == 0).all()), f"{label}: seeded field is not 0")
    envelope_edges()
    line_pass_edges()
    for shape in SEGSUM_LONG_SHAPES:
        axis = int(np.argmax(shape))
        g_long = torch.randn(shape, device=dev, generator=torch.Generator(device=dev).manual_seed(3))
        w_long = random_winners(shape, axis, torch.int32, dev, seed=4)
        compare("winner_segment_sum", (edt_cuda.winner_segment_sum(g_long, w_long, axis),),
                (edt_cuda.winner_segment_sum_plain(g_long, w_long, axis),), f"{shape} axis {axis} random int32")
    mask256 = torch.as_tensor(make_scene(256), device=dev)
    kernels_vs_plain(mask256, "make_scene(256)")
    # K8: make_scene(256) from bench.py's camera (marching +x), and the
    # two-sphere scene from its +x side looking back (marching -x)
    vals256, _, _ = edt.signed_field_from_masks(mask256, RES, "auto")
    sdf256 = SdfGrid.create(vals256, GridMeta.create(eye, RES, mask256.shape, device=dev), 1e3)
    c256 = np.full(3, 0.5 * 256 * RES)
    o, v = render.camera_rays(c256 + np.array([-1.2, 0.0, 0.4]) * 256 * RES, c256, (0.0, 0.0, 1.0), 50.0, 256, 256,
                              device=dev)
    plane_vs_plain(sdf256, o, v, 4 * 256 * RES, "make_scene(256) 256x256")
    spheres = sphere_values()
    sdf_sph = SdfGrid.create(torch.as_tensor(spheres, device=dev),
                             GridMeta.create(eye, 0.1, spheres.shape, device=dev), float("inf"))
    c_sph = np.array(spheres.shape) * 0.1 * 0.5
    o, v = render.camera_rays(c_sph + np.array([spheres.shape[0] * 0.1 * 1.5, spheres.shape[1] * 0.1 * 0.1, 0.0]),
                              c_sph, (0.0, 0.0, 1.0), 40.0, 64, 128, device=dev)
    tables_sph, _ = plane_vs_plain(sdf_sph, o, v, 40.0, "two spheres from +x 64x128")
    check(bool((tables_sph.ch[:, 5] < 0).all()), "two spheres from +x: the rays do not march -x")
    del mask256, vals256, sdf256, sdf_sph
    # K8 on its edges
    for case in K8_EDGE_CASES:
        values, res_c, o_np, v_np = k8_edge_case(case)
        sdf_c = SdfGrid.create(torch.as_tensor(values, device=dev),
                               GridMeta.create(eye, res_c, values.shape, device=dev), float("inf"))
        tables_c, got_c = plane_vs_plain(sdf_c, torch.as_tensor(o_np, device=dev), torch.as_tensor(v_np, device=dev),
                                         K8_EDGE_T_MAX, f"edge case {case}")
        log(f"[kernels] K8 edge case {case}: rows {tables_c.tab.shape[0]}, executed slabs"
            f" {int(got_c[5][:, 0].sum())}, axes {sorted(set(tables_c.tab[tables_c.tab[:, 0] > 0, 1].tolist()))}")
    k8_attrs = (ctypes.c_int * 6)()
    check(_build.library().sdf_plane_sweep_attrs(render_plane.HDR + 64, ctypes.cast(k8_attrs, ctypes.c_void_p)) == 0,
          "sdf_plane_sweep_attrs")
    k8_attrs = dict(zip(("registers", "local_bytes", "static_smem", "max_threads", "blocks_per_sm", "dynamic_smem"),
                        list(k8_attrs)))
    log(f"[kernels] K8 attributes at a 64-slot table: {json.dumps(k8_attrs)}")
    log(f"[kernels] K1-K7 and K9 bitwise equal to plain at {len(SMALL_SHAPES)} random shapes, empty, full"
        f" and 256^3 (K1 and K4 in both modes; K7 also with random non-monotone int16/int32 winners in [-1, n],"
        f" and on lines of 60000); K1 and K4 (both modes) on uint8 masks of x length {list(LINE_PASS_X)} and"
        f" columns {list(LINE_PASS_COLUMNS)};"
        f" K2, K3, K5, K6 (both forms) and K9 (n <= 1024; also near CHT_CLAMP and convex) on tie-heavy, all-INF and"
        f" single-seed lines of length {list(ENVELOPE_LINES)} along axes 1 and 2, K6 on lines of {CARRY_LONG_LINE}"
        f" along axis 2; K8 equal to plain (6 outputs) on make_scene(256) 256x256, on two spheres marching -x and"
        f" on its edge cases {list(K8_EDGE_CASES)}"
        f" ({time.perf_counter() - t0:.1f} s)")

    # ---- 4. main path at full size -------------------------------------
    t0 = time.perf_counter()
    mask_np = make_scene(N)
    log(f"[scene] make_scene({N}) fill {mask_np.mean():.4f} in {time.perf_counter() - t0:.1f} s")
    engine = SdfEngine(
        shape=(N, N, N), resolution=RES, device=dev, image_hw=IMAGE_HW,
        render_max_steps=MAX_STEPS, render_t_max=4 * N * RES, oob_value=1e3,
    )
    rng = np.random.default_rng(0)
    q_np = rng.uniform(0.0, N * RES, (N_QUERIES, 3)).astype(np.float32)
    center = np.full(3, 0.5 * N * RES)
    cam = center + np.array([-1.2 * N * RES, 0.0, 0.4 * N * RES])
    mask = torch.as_tensor(mask_np, device=dev)
    q = torch.as_tensor(q_np, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    edt_cuda.reset_launches()
    sdf = engine.sdf_from_occupancy(mask)
    dist, in_bounds = engine.query(sdf, q)
    depth, hit = engine.render(sdf, cam, center)
    torch.cuda.synchronize()
    launches = dict(edt_cuda.LAUNCHES)
    peak_main = torch.cuda.max_memory_allocated()
    log(f"[main] LAUNCHES {json.dumps(launches)}")
    for name in SERVING_KERNELS:
        check(launches[name] >= 1, f"kernel {name} was not launched on the serving path")

    # each kernel against its plain version at the main path's shape, then
    # the whole field against the plain chain (a check of its own)
    kernels_vs_plain(mask, f"main path {N}^3", training=False)
    res32 = engine.meta.resolution
    plain_vals, _, _ = edt.signed_field_from_masks(mask, engine.meta.resolution_float, "plain")
    check(torch.equal(sdf.values.view(torch.int32), plain_vals.view(torch.int32)),
          f"signed field {N}^3: kernel chain != plain chain")
    del plain_vals
    check(bool((sdf.values[mask] <= -res32).all()), "a filled cell is above -res")
    check(bool((sdf.values[~mask] >= res32).all()), "a free cell is below +res")
    check(dist.shape == (N_QUERIES,) and bool(torch.isfinite(dist).all()) and bool(in_bounds.all()), "query output")
    check(depth.shape == IMAGE_HW and bool(torch.isfinite(depth).all()), "render output")
    hit_frac = float(hit.float().mean())
    mean_depth = float(depth.mean())
    check(0.0 < hit_frac < 1.0, f"hit fraction {hit_frac}")
    log(f"[main] K1 (both modes), K2 (axis 1, 2), K3 and the signed field {N}^3 bitwise equal to plain; min {float(sdf.values.min()):.6f}"
        f" max {float(sdf.values.max()):.6f}; query mean {float(dist.mean()):.6f}")
    log(f"[main] render {IMAGE_HW[0]}x{IMAGE_HW[1]} (plane sweep): hit fraction {hit_frac:.6f}, mean depth {mean_depth:.6f}")

    # the plane render: its counts (every ray resolved, so the agreement
    # below is the sweep's and not the march fallback's), K8 against its
    # plain version on the render's own tables, and the sweep against the
    # card's march on all rays
    o, v = render.camera_rays(cam, center, engine.render_up, engine.fov_deg, *IMAGE_HW, device=dev)
    kw = dict(t_max=engine.render_t_max, eps=engine.render_eps, max_steps=MAX_STEPS)
    d_pl, h_pl, _, diag = render_plane.plane_sweep_depth(sdf, o, v, 0.0, kw["t_max"], kw["eps"], MAX_STEPS, None, diag=True)
    diag = {k: int(x) for k, x in diag.items()}
    log(f"[main] plane sweep counts {json.dumps(diag)}")
    check(diag["unresolved"] == 0, f"plane render: {diag['unresolved']} unresolved rays took the march fallback")
    check(torch.equal(d_pl, depth) and torch.equal(h_pl, hit), "engine.render differs from plane_sweep_depth")
    main_tables, main_k8 = plane_vs_plain(sdf, o, v, kw["t_max"], f"main path {IMAGE_HW[0]}x{IMAGE_HW[1]}")
    r_march = render.render_depth(sdf, o, v, backend="march", **kw)
    agree_pm = float((r_march.hit == hit).float().mean())
    both = r_march.hit & hit
    err = (depth - r_march.depth)[both].abs().double()
    p95, med = float(torch.quantile(err, 0.95)), float(err.median())
    res_f = engine.meta.resolution_float
    log(f"[main] plane vs march on {hit.numel()} rays: hit agreement {agree_pm:.6f} (disagreement"
        f" {100 * (1 - agree_pm):.3f}%; the JAX package's plane vs its march: 0.463% of the bench rays, an"
        f" algorithm property, docs/NOTES.md §13); common-hit |depth diff| p95 {p95:.6f} ({p95 / res_f:.4f} res),"
        f" median {med:.6f} ({med / res_f:.4f} res); K8 equal to plain on the render's tables")
    check(agree_pm >= PLANE_HIT_AGREE_MIN and p95 < PLANE_P95_MAX * res_f and med < PLANE_MEDIAN_MAX * res_f,
          "plane render vs march")
    del d_pl, h_pl, r_march, err

    # the card against the port's CPU path on a subset (march on both sides)
    sdf_cpu = sdf.to("cpu")
    dq_cpu, _ = query.estimate_distance(sdf_cpu, q[:4096].cpu())
    check(bool(torch.allclose(dist[:4096].cpu(), dq_cpu, rtol=0, atol=QUERY_ATOL)), "query: card vs CPU")
    o_s, v_s = o[::32, ::32].contiguous(), v[::32, ::32].contiguous()
    r_gpu = render.render_depth(sdf, o_s, v_s, backend="march", **kw)
    r_cpu = render.render_depth(sdf_cpu, o_s.cpu(), v_s.cpu(), backend="march", **kw)
    h_gpu, h_cpu = r_gpu.hit.cpu(), r_cpu.hit
    agree = float((h_gpu == h_cpu).float().mean())
    both = h_gpu & h_cpu
    ddiff = float((r_gpu.depth.cpu() - r_cpu.depth)[both].abs().max()) if bool(both.any()) else 0.0
    log(f"[main] march card vs CPU on {h_cpu.numel()} rays: hit agreement {agree:.6f}, max common-hit depth diff {ddiff:.3e}")
    check(agree >= HIT_AGREE_MIN and ddiff <= DEPTH_ATOL, "march: card vs CPU")

    # ---- 5. training path at full size ----------------------------------
    res = engine.meta.resolution_float
    target = depth.detach()
    occ_a = mask.float() * 0.9 + 0.05
    logits = initial_logits(mask, TRAIN_SHIFT)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    edt_cuda.reset_launches()
    values_ft, d_occ = ft_field_grad(occ_a, res)
    loss_b, d_values, r_b = render_value_and_grad(sdf.values, engine.meta, engine.oob_value, o, v, kw)
    losses = []
    for _ in range(TRAIN_STEPS):
        loss, g_logits = train_step(logits, target, engine.meta, engine.oob_value, o, v, kw)
        logits = logits - TRAIN_LR * g_logits
        losses.append(loss)
    torch.cuda.synchronize()
    train_launches = dict(edt_cuda.LAUNCHES)
    peak_train = torch.cuda.max_memory_allocated()
    log(f"[train] LAUNCHES {json.dumps(train_launches)}")
    for name in TRAINING_KERNELS + ("plane_sweep",):
        check(train_launches[name] >= 1, f"kernel {name} was not launched on the training path")
    losses = [float(x) for x in losses]
    log(f"[train] (c) SGD lr {TRAIN_LR:g}, losses " + ", ".join(f"{x:.6f}" for x in losses))

    check(torch.equal(values_ft.view(torch.int32), sdf.values.view(torch.int32)), "FT field != K1-K3 field")
    _, d_occ_plain = ft_field_grad(occ_a, res, "plain")
    check(torch.equal(d_occ.view(torch.int32), d_occ_plain.view(torch.int32)), "FT d occ: kernels != plain")
    del d_occ_plain
    # both fields have seeds, so every cell's cotangent 2 * value is routed
    mass = float(d_occ.double().sum())
    want_mass = float(-2.0 * engine.meta.resolution.double() * (2.0 * values_ft.double()).sum())
    mass_err = abs(mass - want_mass) / abs(want_mass)
    log(f"[train] (a) FT field bitwise equal to the K1-K3 field; d occ bitwise equal to 'plain'; routed mass"
        f" {mass:.6e} vs -2 res sum(cotangent) {want_mass:.6e} (rel err {mass_err:.3e})")
    check(mass_err <= MASS_RTOL, "FT routed mass")
    grads = {"d occ": d_occ, "d values": d_values, "d logits": g_logits}
    for name, gr in grads.items():
        check(bool(torch.isfinite(gr).all()) and bool((gr != 0).any()), f"{name}: not finite or all zero")
    check(all(np.isfinite(losses)) and bool(torch.isfinite(loss_b)), "training losses not finite")
    log(f"[train] (b) sum(depth^2) {float(loss_b):.6e}, d values non-zero on {int((d_values != 0).sum())} cells")
    # the render gradient on the ray subset: the card's backward against the
    # port's CPU backward fed the card's depth and hit
    vals_s = sdf.values.detach().requires_grad_(True)
    o_g, v_g = o_s.clone().requires_grad_(True), v_s.clone().requires_grad_(True)
    r_s = render.render_depth(SdfGrid.create(vals_s, engine.meta, engine.oob_value), o_g, v_g, **kw)
    (r_s.depth**2).sum().backward()
    d_s = r_s.depth.detach().cpu()
    want = render.ift_backward(sdf_cpu, o_s.cpu(), v_s.cpu(), d_s, r_s.hit.cpu(), 2.0 * d_s)
    for name, got, w in zip(("d values", "d origins", "d directions"), (vals_s.grad, o_g.grad, v_g.grad), want):
        err = float((got.cpu() - w).abs().max())
        tol = RENDER_GRAD_ATOL_REL * float(w.abs().max())
        log(f"[train] render {name} card vs CPU on {d_s.numel()} rays: max |diff| {err:.3e} (atol {tol:.3e})")
        check(bool(torch.allclose(got.cpu(), w, rtol=RENDER_GRAD_RTOL, atol=tol)), f"render {name}: card vs CPU")
    check(bool((want[0] != 0).any()), "render gradient on the subset is all zero")
    # K6 and K7 against their plain versions at the training path's inputs
    training_kernels_vs_plain(mask, f"training path {N}^3", carry=False)
    torch.cuda.synchronize()
    log(f"[train] K6 (axis 1, 2) and K7 (axis 0, 1, 2; FT and random int16/int32 winners) bitwise equal to plain"
        f" at {N}^3")

    # ---- 6. timings ------------------------------------------------------
    fa, fb = edt_cuda.line_pass_dual(mask)
    ea, eb = edt_cuda.envelope_dual(fa, fb, 1)
    ms = {}
    k1_ms = {}
    for square in (True, False):
        k1_ms[square] = abba(
            lambda: edt_cuda.line_pass_dual_plain(mask, square), lambda: edt_cuda.line_pass_dual(mask, square),
            on_warm=lambda got, want: compare("line_pass_dual", got, want,
                                              f"{N}^3 {'squared' if square else 'linear'} (timing run)"))
    ms["line_pass_dual"] = k1_ms[True]
    ms["envelope_dual"] = abba(lambda: edt_cuda.envelope_dual_plain(fa, fb, 1), lambda: edt_cuda.envelope_dual(fa, fb, 1))
    ms["envelope_dual_combine"] = abba(
        lambda: edt_cuda.envelope_dual_combine_plain(ea, eb, RES), lambda: edt_cuda.envelope_dual_combine(ea, eb, RES)
    )
    field_ms, field_plain_ms = abba(
        lambda: edt.signed_field_from_masks(mask, res32, "plain"), lambda: engine.sdf_from_occupancy(mask)
    )
    render_ms = [cuda_ms(lambda: engine.render(sdf, cam, center)) for _ in range(6)]
    march_ms = [cuda_ms(lambda: engine.render(sdf, cam, center, backend="march")) for _ in range(6)]
    split_ms = np.median([plane_split(sdf, o, v, kw) for _ in range(6)], axis=0)
    # the tail's resume march alone, on as many rays as the main render resumed
    n_res = max(diag["n_resumed"], 1)
    o_r, v_r = o.reshape(-1, 3)[:n_res].contiguous(), v.reshape(-1, 3)[:n_res].contiguous()
    resume_ms = [cuda_ms(lambda: render._trace_depth(sdf, o_r, v_r, 0.0, kw["t_max"], kw["eps"], MAX_STEPS, None,
                                                       coarse=False)) for _ in range(6)]
    tab, ch, vols = main_tables.tab, main_tables.ch, main_tables.vols
    ms["plane_sweep"] = abba(
        lambda: render_plane.plane_sweep_rows_plain(tab, ch, vols, kw["eps"], kw["t_max"]),
        lambda: render_plane.plane_sweep_rows(tab, ch, vols, kw["eps"], kw["t_max"]),
    )
    k8_bound_ms, k8_bound_by, k8_detail = k8_bound(main_tables, main_k8[5][:, 0])
    del tab, ch, vols
    query_ms = [cuda_ms(lambda: engine.query(sdf, q)) for _ in range(6)]

    # K6 on both axes of the FT forward, K7 on the three axes of its backward
    f0, x0 = edt.line_seed_d2(mask, 0)
    f1, jy = edt_cuda.envelope_argmin(f0, 1)
    _, kz = edt_cuda.envelope_argmin(f1, 2)
    per_axis = {"envelope_carry": {}, "winner_segment_sum": {}}
    for axis, fin in ((1, f0), (2, f1)):
        per_axis["envelope_carry"][axis] = abba(
            lambda: edt_cuda.envelope_argmin_plain(fin, axis), lambda: edt_cuda.envelope_argmin(fin, axis)
        )
    g_rand = torch.randn(mask.shape, device=dev, generator=torch.Generator(device=dev).manual_seed(2))
    library = {name: None for name in KERNELS}
    lib_axis = {}
    for axis, w in ((0, x0), (1, jy), (2, kz)):
        w16 = w.to(torch.int16)
        per_axis["winner_segment_sum"][axis] = abba(
            lambda: edt_cuda.winner_segment_sum_plain(g_rand, w16, axis),
            lambda: edt_cuda.winner_segment_sum(g_rand, w16, axis),
        )
        # one PyTorch call computing the same function (with an int64 index
        # made beforehand, and its atomics' order of summation)
        idx = w.to(torch.int64)
        lib_axis[axis] = float(np.median([cuda_ms(lambda: torch.zeros_like(g_rand).scatter_add_(axis, idx, g_rand)) for _ in range(6)]))
    del idx
    for name, by_axis in per_axis.items():
        ms[name] = tuple(float(np.mean([t[k] for t in by_axis.values()])) for k in (0, 1))
    library["winner_segment_sum"] = float(np.mean(list(lib_axis.values())))

    # the training path's stages
    occ_r = occ_a.clone().requires_grad_(True)
    ft_fwd_ms = [cuda_ms(lambda: sdf_from_occupancy_ft(occ_a, res)) for _ in range(6)]
    values_r = sdf_from_occupancy_ft(occ_r, res)
    cot = 2.0 * values_r.detach()
    ft_bwd_ms = [cuda_ms(lambda: torch.autograd.grad(values_r, occ_r, cot, retain_graph=True)) for _ in range(6)]
    del values_r, occ_r
    render_vg_ms = [cuda_ms(lambda: render_value_and_grad(sdf.values, engine.meta, engine.oob_value, o, v, kw))
                    for _ in range(6)]
    step_ms = [cuda_ms(lambda: train_step(logits, target, engine.meta, engine.oob_value, o, v, kw)) for _ in range(6)]
    peak_all = torch.cuda.max_memory_allocated()

    log(f"[timing] card: {smi}")
    for name, (k, p) in ms.items():
        at = f"{N}^3, {IMAGE_HW[0]}x{IMAGE_HW[1]} rays" if name == "plane_sweep" else f"{N}^3"
        log(f"[timing] {name} at {at}: kernel {k:.3f} ms, plain {p:.3f} ms (median of {2 * TIMING_ROUNDS})")
    k1_bound = bytes_bound_ms("line_pass_dual", N)
    for square, (k, p) in k1_ms.items():
        log(f"[timing] line_pass_dual {'squared' if square else 'linear'} at {N}^3: kernel {k:.3f} ms, plain"
            f" {p:.3f} ms (median of {2 * TIMING_ROUNDS}); bound {k1_bound:.4f} ms, {100 * k1_bound / k:.1f}% of it")
    log(f"[timing] signed field {N}^3 end to end: kernels {field_ms:.3f} ms, plain {field_plain_ms:.3f} ms")
    log(f"[timing] render {IMAGE_HW[0]}x{IMAGE_HW[1]} plane sweep (engine.render): {np.median(render_ms):.3f} ms"
        f" (median of {len(render_ms)}; min {min(render_ms):.3f}, max {max(render_ms):.3f})")
    log(f"[timing] render {IMAGE_HW[0]}x{IMAGE_HW[1]} march max_steps={MAX_STEPS}: {np.median(march_ms):.3f} ms"
        f" (median of {len(march_ms)}; min {min(march_ms):.3f}, max {max(march_ms):.3f})")
    log("[timing] plane render split (median of 6): " + ", ".join(
        f"{name} {t:.3f} ms" for name, t in zip(("precompute", "K8", "tail", "fallback"), split_ms)))
    log(f"[timing] K8 bound: {k8_bound_ms:.4f} ms by {k8_bound_by}, {100 * k8_bound_ms / ms['plane_sweep'][0]:.1f}%"
        f" of the kernel's time; {json.dumps(k8_detail)}")
    log(f"[timing] the tail's resume march alone ({n_res} rays, coarse=False): {spread(resume_ms)}")
    for name, fn in (("plane", lambda: engine.render(sdf, cam, center)),
                     ("march", lambda: engine.render(sdf, cam, center, backend="march"))):
        n_k, busy, wall = device_profile(fn)
        idle = f"{1 - busy / wall:.3f}" if busy > 0 else "not measured (no device events recorded)"
        log(f"[profile] render {IMAGE_HW[0]}x{IMAGE_HW[1]} {name}: {n_k} kernels, device busy {busy:.3f} ms in a"
            f" {wall:.3f} ms wall under the profiler, idle share {idle}")
    log(f"[timing] query {N_QUERIES} points: {np.median(query_ms):.3f} ms (median of {len(query_ms)})")
    for name, by_axis in per_axis.items():
        for axis, (k, p) in by_axis.items():
            lib = f", scatter_add_ {lib_axis[axis]:.3f} ms (median of 6)" if name == "winner_segment_sum" else ""
            log(f"[timing] {name} axis {axis} at {N}^3: kernel {k:.3f} ms, plain {p:.3f} ms (median of"
                f" {2 * TIMING_ROUNDS}){lib}")

    log(f"[timing] FT forward {N}^3 (sdf_from_occupancy_ft): {spread(ft_fwd_ms)}")
    log(f"[timing] FT backward {N}^3 (6 winner segment sums): {spread(ft_bwd_ms)}")
    log(f"[timing] render value-and-grad {IMAGE_HW[0]}x{IMAGE_HW[1]}: {spread(render_vg_ms)}")
    log(f"[timing] training step (sigmoid -> FT field -> render -> loss -> backward): {spread(step_ms)}")
    log(f"[memory] max_memory_allocated: serving path {peak_main / 2**30:.3f} GiB, training path"
        f" {peak_train / 2**30:.3f} GiB, whole run {peak_all / 2**30:.3f} GiB")

    # ---- 7. BASELINE config #5's one-card leg at 1024^3 ------------------
    del mask, sdf, q, dist, in_bounds, depth, hit, fa, fb, ea, eb, f0, x0, f1, jy, kz, g_rand
    del values_ft, d_occ, logits, target, occ_a, main_tables, main_k8, r_b, d_values, sdf_cpu
    del r_s, vals_s, o_g, v_g, o, v, o_s, v_s, r_gpu, r_cpu
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    held = torch.cuda.memory_allocated()
    log(f"[config5] device memory held from earlier phases: {held / 2**30:.3f} GiB")
    t0 = time.perf_counter()
    mask5, centers, radii = device_scene(N5, dev)
    torch.cuda.synchronize()
    t_scene = time.perf_counter() - t0
    for x in N5_CHECK_SLICES:
        check(np.array_equal(mask5[x].cpu().numpy(), scene_slice(N5, centers, radii, x)),
              f"device scene {N5}^3: x-slice {x} differs from make_scene's formula")
    fill5 = int(mask5.sum()) / mask5.numel()
    log(f"[config5] make_scene({N5}) on the card in {t_scene:.3f} s, fill {fill5:.6f}; x-slices"
        f" {list(N5_CHECK_SLICES)} equal to make_scene's formula on the host")

    route_ms, route_peak, route_launches = {}, {}, {}

    def route(name: str, fn, want: dict, host_clock: bool = False):
        """Run a route once with the launch counts reset before and read
        after; record its time, peak memory and launches."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        edt_cuda.reset_launches()
        out, t = timed(fn, host_clock)
        got = {k: c for k, c in edt_cuda.LAUNCHES.items() if c}
        route_ms[name], route_peak[name], route_launches[name] = [t], torch.cuda.max_memory_allocated(), got
        log(f"[config5] route {name}: {t:.3f} ms (first run), LAUNCHES {json.dumps(got)},"
            f" peak {route_peak[name] / 2**30:.3f} GiB")
        check(got == want, f"route {name}: launches {got}, want exactly {want}")
        return out

    def fused():
        return edt.signed_field_from_masks(mask5, RES, "auto")[0]

    def route_a():
        return edt.squared_edt(mask5), edt.squared_edt(~mask5)

    def route_b():
        return edt.signed_field_lowmem(mask5, RES)

    def route_c():
        # the device-resident slab build of scripts/bench_render_1024.py
        vals = torch.empty(mask5.shape, dtype=torch.float32, device=dev)
        sl = N5 // N5_SLABS
        pairs = zip(edt.squared_edt_slabbed(mask5, N5_SLABS), edt.squared_edt_slabbed(~mask5, N5_SLABS))
        for i, (a, b) in enumerate(pairs):
            vals[i * sl : (i + 1) * sl] = edt.d2_to_distance(a, RES).sub_(edt.d2_to_distance(b, RES))
        return vals

    def route_d():
        return edt.signed_field_slabbed(mask5, RES, n_slabs=N5_SLABS, prefetch=N5_PREFETCH)

    def route_e():
        return edt.signed_field_from_masks(mask5, RES, "cht")[0]

    def same(x, y) -> bool:
        return torch.equal(x.view(torch.int32), y.view(torch.int32))

    ref = route("fused", fused, {"line_pass_dual": 1, "envelope_dual": 1, "envelope_dual_combine": 1})
    a5, b5 = route("a", route_a, {"line_pass": 2, "envelope": 4})
    fa5, fb5 = edt.squared_edt_both(mask5)
    check(torch.equal(a5, fa5) and torch.equal(b5, fb5), f"(a) squared_edt != squared_edt_both at {N5}^3")
    del fa5, fb5
    check(same(edt.d2_to_distance(a5, RES).sub_(edt.d2_to_distance(b5, RES)), ref),
          f"(a) combined != the fused K1-K3 field at {N5}^3")
    del a5, b5
    for name, fn, want in (("b", route_b, {"line_pass": 2, "envelope": 4}),
                           ("c", route_c, {"line_pass": 2 * N5_SLABS, "envelope": 4 * N5_SLABS}),
                           ("e", route_e, {"line_pass": 2, "envelope_cht": 4})):
        got = route(name, fn, want)
        check(same(got, ref), f"({name}) != the fused K1-K3 field at {N5}^3")
        del got
    host5 = route("d", route_d, {"line_pass": 2 * N5_SLABS, "envelope": 4 * N5_SLABS}, host_clock=True)
    check(np.array_equal(host5.view(np.uint32), ref.cpu().numpy().view(np.uint32)),
          f"(d) != the fused K1-K3 field at {N5}^3 (on the host)")
    del host5
    log(f"[config5] routes (a) squared_edt x2 vs squared_edt_both, (b) lowmem, (c) device slab build, (d) host"
        f" slab stream, (e) cht: each bitwise equal to the fused K1-K3 field {N5}^3; min {float(ref.min()):.6f}"
        f" max {float(ref.max()):.6f}")

    # K4, K5 and K9 against their plain versions on one slab's inputs
    sl5 = N5 // N5_SLABS
    f5 = edt_cuda.line_pass_plain(mask5)
    single_kernels_vs_plain(mask5[:sl5], f"{N5}^3 slab 0 ({sl5}x{N5}x{N5})", f=f5[:sl5])
    log(f"[config5] K4 (both modes), K5 and K9 (axes 1, 2) bitwise equal to plain on slab 0 ({sl5}x{N5}x{N5})")

    # the render over the 1024^3 field
    meta5 = GridMeta.create(eye, RES, (N5, N5, N5), device=dev)
    sdf5 = SdfGrid.create(ref, meta5, 1e3)
    c5 = np.full(3, 0.5 * N5 * RES)
    cam5 = c5 + np.array([-1.2, 0.0, 0.4]) * N5 * RES
    o5, v5 = render.camera_rays(cam5, c5, (0.0, 0.0, 1.0), 50.0, *IMAGE_HW, device=dev)
    kw5 = dict(t_max=4 * N5 * RES, eps=RENDER_EPS, max_steps=N5_MAX_STEPS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    edt_cuda.reset_launches()
    r5 = render.render_depth(sdf5, o5, v5, backend="auto", **kw5)
    torch.cuda.synchronize()
    render5_launches = {k: c for k, c in edt_cuda.LAUNCHES.items() if c}
    peak_render5 = torch.cuda.max_memory_allocated()
    log(f"[config5] render {IMAGE_HW[0]}x{IMAGE_HW[1]} over {N5}^3: LAUNCHES {json.dumps(render5_launches)},"
        f" peak {peak_render5 / 2**30:.3f} GiB")
    check(render5_launches.get("plane_sweep", 0) >= 1, f"render over {N5}^3: K8 was not launched")
    check(r5.depth.shape == IMAGE_HW and bool(torch.isfinite(r5.depth).all()), f"render over {N5}^3: output")
    hit5 = float(r5.hit.float().mean())
    check(0.0 < hit5 < 1.0, f"render over {N5}^3: hit fraction {hit5}")
    d_pl, h_pl, _, diag5 = render_plane.plane_sweep_depth(sdf5, o5, v5, 0.0, kw5["t_max"], kw5["eps"], N5_MAX_STEPS,
                                                          None, diag=True)
    diag5 = {k: int(x) for k, x in diag5.items()}
    check(torch.equal(d_pl, r5.depth) and torch.equal(h_pl, r5.hit), "render_depth differs from plane_sweep_depth")
    del d_pl, h_pl
    log(f"[config5] plane sweep counts {json.dumps(diag5)}; unresolved rays {diag5['unresolved']}; hit fraction"
        f" {hit5:.6f}, mean depth {float(r5.depth.mean()):.6f}")
    tables5, k8_out5 = plane_vs_plain(sdf5, o5, v5, kw5["t_max"], f"{N5}^3 {IMAGE_HW[0]}x{IMAGE_HW[1]}")
    r_m5 = render.render_depth(sdf5, o5, v5, backend="march", **kw5)
    agree5 = float((r_m5.hit == r5.hit).float().mean())
    both5 = r_m5.hit & r5.hit
    err5 = (r5.depth - r_m5.depth)[both5].abs().double()
    p95_5, med5 = float(torch.quantile(err5, 0.95)), float(err5.median())
    log(f"[config5] plane vs march on {r5.hit.numel()} rays: hit agreement {agree5:.6f}; common-hit |depth diff|"
        f" p95 {p95_5:.6f} ({p95_5 / RES:.4f} res), median {med5:.6f} ({med5 / RES:.4f} res); K8 equal to plain on"
        f" the render's tables")
    check(agree5 >= PLANE_HIT_AGREE_MIN and p95_5 < PLANE_P95_MAX * RES and med5 < PLANE_MEDIAN_MAX * RES,
          f"plane render vs march over {N5}^3")
    del r_m5, err5

    # timings: the new kernels at the slab and at the full volume (the
    # untimed full-volume runs are compared bitwise too), the routes, the
    # render
    f1_5 = edt_cuda.envelope(f5, 1)
    ms5 = {}
    for label, m_in, f_in, f1_in, rounds in (("slab", mask5[:sl5], f5[:sl5], f1_5[:sl5], TIMING_ROUNDS),
                                             ("full", mask5, f5, f1_5, FULL_ROUNDS)):
        def on_warm(name, where):
            return lambda got, want: compare(name, (got,), (want,), f"{N5}^3 {label} {where} (timing run)")

        for square in (True, False):
            ms5[("line_pass", label, square)] = abba(
                lambda: edt_cuda.line_pass_plain(m_in, square), lambda: edt_cuda.line_pass(m_in, square), rounds,
                on_warm=on_warm("line_pass", "squared" if square else "linear"))
        for axis, fin in ((1, f_in), (2, f1_in)):
            ms5[("envelope", label, axis)] = abba(
                lambda: edt_cuda.envelope_plain(fin, axis), lambda: edt_cuda.envelope(fin, axis), rounds,
                on_warm=on_warm("envelope", f"axis {axis}"))
            ms5[("envelope_cht", label, axis)] = abba(
                lambda: edt_cuda.envelope_cht_plain(fin, axis), lambda: edt_cuda.envelope_cht(fin, axis), rounds,
                on_warm=on_warm("envelope_cht", f"axis {axis}"))
        torch.cuda.synchronize()
    del m_in, f_in, f1_in, fin  # the loop's last inputs: 9 GB at 1024^3, held into phase 8 otherwise
    # K9 (the banded hull, O(n) a line) against K5 (the row-minimum search,
    # O(n log n)) on the same 1024^3 inputs, in turns K5, K9, K9, K5: the
    # config's scene, and make_scene(256) tiled 4x4x4 (64 times the objects
    # at a quarter of the size)
    k9_vs_k5 = {}

    def k9_against_k5(label, f_in, f1_in):
        for axis, fin in ((1, f_in), (2, f1_in)):
            k9_vs_k5[(label, axis)] = abba(lambda: edt_cuda.envelope(fin, axis),
                                           lambda: edt_cuda.envelope_cht(fin, axis))

    k9_against_k5(f"make_scene({N5})", f5, f1_5)
    del f5, f1_5
    f5 = edt_cuda.line_pass(torch.as_tensor(make_scene(N5 // 4), device=dev).repeat(4, 4, 4))
    k9_against_k5(f"make_scene({N5 // 4}) tiled 4x4x4", f5, edt_cuda.envelope(f5, 1))
    del f5

    def drain_only():
        """The device-to-host part of (d) alone: each slab of the field into
        pinned memory, one event per slab, then into one numpy array."""
        out = np.empty(tuple(ref.shape), np.float32)
        for i in range(N5_SLABS):
            h = torch.empty((sl5, N5, N5), dtype=torch.float32, pin_memory=True)
            h.copy_(ref[i * sl5 : (i + 1) * sl5], non_blocking=True)
            ev = torch.cuda.Event()
            ev.record()
            ev.synchronize()
            out[i * sl5 : (i + 1) * sl5] = h.numpy()
        return out

    for name, fn, host_clock in (("fused", fused, False), ("a", route_a, False), ("b", route_b, False),
                                 ("c", route_c, False), ("d", route_d, True), ("e", route_e, False)):
        for _ in range(ROUTE_RUNS):
            route_ms[name].append(timed(fn, host_clock)[1])
    drain_ms = [timed(drain_only, host_clock=True)[1] for _ in range(ROUTE_RUNS)]
    render5_ms = [timed(lambda: render.render_depth(sdf5, o5, v5, backend="auto", **kw5))[1] for _ in range(ROUTE_RUNS)]
    march5_ms = [timed(lambda: render.render_depth(sdf5, o5, v5, backend="march", **kw5))[1] for _ in range(ROUTE_RUNS)]
    split5_ms = np.median([plane_split(sdf5, o5, v5, kw5) for _ in range(ROUTE_RUNS)], axis=0)
    tab5, ch5, vols5 = tables5.tab, tables5.ch, tables5.vols
    k8_ms5 = abba(lambda: render_plane.plane_sweep_rows_plain(tab5, ch5, vols5, kw5["eps"], kw5["t_max"]),
                  lambda: render_plane.plane_sweep_rows(tab5, ch5, vols5, kw5["eps"], kw5["t_max"]))
    k8_bound5 = k8_bound(tables5, k8_out5[5][:, 0])
    del tab5, ch5, vols5, tables5, k8_out5

    log(f"[timing] config #5 leg at {N5}^3, card: {smi}")
    for (name, label, arg), (k, p) in ms5.items():
        what = ("squared" if arg else "linear") if name == "line_pass" else f"axis {arg}"
        runs = 2 * (TIMING_ROUNDS if label == "slab" else FULL_ROUNDS)
        shape = f"{sl5}x{N5}x{N5}" if label == "slab" else f"{N5}^3"
        bound = bytes_bound_ms(name, N5) / (N5_SLABS if label == "slab" else 1)
        log(f"[timing] {name} {what} at {shape}: kernel {k:.3f} ms, plain {p:.3f} ms (median of {runs}); bound"
            f" {bound:.4f} ms, {100 * bound / k:.1f}% of it")
    for (label, axis), (k9, k5) in k9_vs_k5.items():
        log(f"[timing] K9 vs K5 axis {axis} at {N5}^3 on {label}, in turns: K9 {k9:.3f} ms, K5 {k5:.3f} ms,"
            f" K9 / K5 {k9 / k5:.3f} (median of {2 * TIMING_ROUNDS}): {'K9' if k9 < k5 else 'K5'} is faster")
    for name, ts in route_ms.items():
        log(f"[timing] route {name} at {N5}^3 (first run {ts[0]:.3f} ms): {spread(ts[1:])}, peak"
            f" {route_peak[name] / 2**30:.3f} GiB")
    log(f"[timing] the device-to-host drain alone (8 pinned slabs, then numpy): {spread(drain_ms)}")
    log(f"[timing] render {IMAGE_HW[0]}x{IMAGE_HW[1]} over {N5}^3 plane sweep (render_depth auto): {spread(render5_ms)}")
    log(f"[timing] render {IMAGE_HW[0]}x{IMAGE_HW[1]} over {N5}^3 march max_steps={N5_MAX_STEPS}: {spread(march5_ms)}")
    log(f"[timing] plane render over {N5}^3 split (median of {ROUTE_RUNS}): " + ", ".join(
        f"{name} {t:.3f} ms" for name, t in zip(("precompute", "K8", "tail", "fallback"), split5_ms)))
    log(f"[timing] plane_sweep at {N5}^3, {IMAGE_HW[0]}x{IMAGE_HW[1]} rays: kernel {k8_ms5[0]:.3f} ms, plain"
        f" {k8_ms5[1]:.3f} ms (median of {2 * TIMING_ROUNDS}); bound {k8_bound5[0]:.4f} ms by {k8_bound5[1]},"
        f" {100 * k8_bound5[0] / k8_ms5[0]:.1f}% of it; {json.dumps(k8_bound5[2])}")
    log(f"[memory] config #5 leg peaks: " + ", ".join(
        f"{name} {peak / 2**30:.3f} GiB" for name, peak in route_peak.items()) + f", render {peak_render5 / 2**30:.3f} GiB")
    log(f"[config5] phase time {time.perf_counter() - t_phase:.1f} s")
    for name in CONFIG5_KERNELS:
        by_axis = [v for (n_, label, _), v in ms5.items() if n_ == name and label == "full"]
        if name == "line_pass":
            by_axis = [ms5[(name, "full", True)]]
        ms[name] = tuple(float(np.mean([t[k] for t in by_axis])) for k in (0, 1))
    del ref, sdf5, r5, mask5

    # ---- 8. configs #1-#3 and the query surface --------------------------
    phase8 = query_surface_phase(dev, engine, mask_np, q_np, smi)
    for name in SERVING_KERNELS[:3]:
        check(phase8.get(name, 0) >= 1, f"kernel {name} was not launched in phase 8")

    # ---- 9. the planner's map topology and io ---------------------------
    phase9 = map_topology_phase(dev, engine, mask_np, smi)
    for name in SERVING_KERNELS[:3]:
        check(phase9.get(name, 0) >= 1, f"kernel {name} was not launched in phase 9")

    # ---- 10. result ------------------------------------------------------
    # ms and plain_ms: one launch (K6: mean of its axis-1 and axis-2 medians,
    # K7: mean of its three axes; K8: on the main render's tables; K4: the
    # squared mode at 1024^3; K5, K9: mean of axes 1 and 2 at 1024^3);
    # launches: the main path's (K1-K3: with phase 8's and 9's runs; K4, K5,
    # K9: the sum over config #5's routes (a)-(e)); bound_ms: that launch's
    # bytes at peak rate (K8: k8_bound)
    main_launches = {**{k: launches[k] for k in SERVING_KERNELS}, **{k: train_launches[k] for k in TRAINING_KERNELS}}
    for name in SERVING_KERNELS[:3]:
        main_launches[name] += phase8[name] + phase9[name]
    for name in CONFIG5_KERNELS:
        main_launches[name] = sum(got.get(name, 0) for got in route_launches.values())
    bounds = {name: (bytes_bound_ms(name, n), "bytes") for name, (_, _, b, n) in KERNELS.items() if b is not None}
    bounds["plane_sweep"] = (k8_bound_ms, k8_bound_by)
    kernels = [
        {
            "name": name, "route": "cuda", "source": src, "replaces": tpu,
            "launches": main_launches[name], "max_abs_err": max_err[name],
            "ms": ms[name][0], "plain_ms": ms[name][1],
            "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
            "library_ms": library[name],
        }
        for name, (src, tpu, _, _) in KERNELS.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }))


if __name__ == "__main__":
    main()
