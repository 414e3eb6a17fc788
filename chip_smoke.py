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
   backward, the render value-and-grad and one training step (each row's
   first call timed apart, its six runs after it logged in order); K8's bound
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
10. BASELINE config #5's mesh and the last modules (``parallel/``,
   ``scene``, ``sparse``, ``viz``, ``profiling``), timed with
   ``profiling.StageTimer``. The single-device references are computed
   here first, saved to a temporary directory and freed; then ranks start
   as spawned processes on this card (the kernels already built), each
   rank's exit code checked: (a) config #5's x-slab mesh, 2 ranks over
   gloo with CUDA tensors (NCCL takes one rank a GPU; the collectives gloo
   refuses on CUDA tensors, send and recv, go through the host, counted):
   ``make_scene(1024)``, each rank rasterising only its slab;
   ``sharded_signed_field`` (K1 linear, one all_gather, K2, K3) and
   ``sharded_squared_edt`` (K4 linear, K5 twice) bitwise equal to the
   single-device field and d^2 on each slab; ``sharded_render_depth`` of
   1024^2 rays (halo 2, max_steps 96) with ``"auto"`` (the plane sweep on
   each slab, K8; the resolved backend logged) and with the march, each
   bitwise equal to its tiles marched in this process and composited, and
   against the single-device renders of its backend with the JAX sharded
   render tests' bars (``_render_bars``: the hit bar against the field's
   render; ``_depth_bars`` against the render of the field with the ranks'
   outer halo: on interior rays the two agree within res/2 (march) or res
   (plane sweep), or the sharded one is right by the field's crossings,
   sampled every res/16, or neither is and the sharded hit lies on a
   surface); (b) the (x, y) = (2, 2) tile mesh on 4
   ranks at 512^3: ``sharded_signed_field_2d`` with both methods bitwise,
   ``sharded_render_depth_2d`` with the same checks, one
   ``make_train_step_2d`` step; (c) one ``make_train_step`` step on
   (dp=1, x=2) at 512^3 with a 256^2 image: loss and new points against
   ``train.reference_step`` (the same tiles in one process), the
   gradient within rtol 1e-4, atol 1e-5 max (not the mesh size times it),
   the step's forward against ``train.untiled_forward`` (no tile: the same
   bars, the loss within 1e-3), and no collective of a volume's size;
   (b)'s step has the same checks; (d) one rank over NCCL:
   ``sharded_signed_field`` at 512^3 bitwise; each rank's ms, peak memory,
   collectives, bytes and staged calls logged; (e) ``SdfBuilder`` at
   512^3 (make_scene(512) as the octomap, 12 posed primitives, a torus
   mesh): every update mode's occupancy as expected and its field bitwise
   ``extract_signed_distance_field``'s, ``USE_CACHED`` returns the cached
   objects, the occupancy on a 128^3 crop equal to the CPU run's; (f)
   ``DynamicSpatialHashedCollisionMap`` (chunk 16) filled from the 512^3
   map (uniform chunks by ``set_chunk``, the rest by ``set_cell``),
   ``densify()`` onto the card equal to the map; (g) ``viz`` displays of
   phase 9's outputs, card against CPU on a 128^3 crop bitwise. The
   ranks' and the builder's launches are the phase's main-path launches.
11. The system's entry points outside the package, with launch counts reset
   before and read after: (a) config #4's pixel gradients on phase 4's
   512^3 field and 1024^2 rays (``scripts/validate_baseline.py``'s
   ``fd_probes``): at 8 hit pixels evenly spaced, ``ift_backward``'s field
   gradient of the pixel's depth at its largest corner against central
   differences of that depth at 0.2 and 0.4 res, each a render of the
   probe's 8 x 16 tile of rays alone (the plane sweep's row of 128 rays)
   through the image's backend (the plane sweep, K8), its depth the
   image's at every probe; at least 6 of 8 within a ratio of 2.5 (the JAX
   bar); the field bitwise unchanged after (the tighter measure,
   ``fd_jittered``, runs in the validator only); (b) the four examples at their own
   sizes: the tutorial and the point cloud card against the port's CPU run
   (fields, labels, displays and the PLY bitwise, queries within
   ``CPU_MAX_ULPS``), the mesh scene's field at the icosphere's centre
   within 0.05 of -0.5, the carve (FT, 60 steps, K6 and K7) rising in IoU
   and ending within 0.05 of the port's CPU run, which runs meanwhile in a
   process of its own; (c) the image CLI on config #1's 256^2 image, its
   files byte-equal to the CPU run's.
12. The system's measurement programs (``sdf_tools_tpu_torch/scripts``):
   (a) ``bench_ft_bwd`` at 512^3 (K6, K7,
   K4, K5; the scatter-add beside the six K7 launches); (b)
   ``bench_1024`` (config #5's host-streamed slabs, 8 of them) and
   ``bench_render_1024`` (the device slab build, then the 1024^2 plane
   render, ``max_steps=96``) at 1024^3, their min/max and mean depth equal
   to phase 7's; (c) ``sdf_from_occupancy_ft`` with ``"reference"`` and
   ``"stencil"`` at 256^3: the forward bitwise
   ``signed_field_from_masks`` of the backend, the occupancy gradient for
   the cotangent of sum(sdf^2) at the exact field bitwise the ``"auto"``
   gradient. Launches reset before (a) and read
   after (c) are the phase's main-path launches (K4, K5, K6, K7, K8 must
   have run).
13. The envelope-design probes (``sdf_tools_tpu_torch/scripts/
   bench_micro_gather{,2,3}.py``, the five kernels of
   ``csrc/micro_gather.cu``; the TPU probes of ``scripts/`` of the same
   names): the three programs' ``main`` on the card (launches reset before
   and read after; each of the 24 probes must have launched), each timing
   its kernel on the device alone at B = 1 (the TPU probe's call) and at
   B_fill (4 instances, one block each, on every SM) beside an empty
   kernel, and its wrapper's calls back to back at B = 1; then each
   probe's kernel bitwise its plain version at B = 1 and B_fill, and on
   both sides of its launch geometry's first switch (every kernel takes
   several blocks an instance at a small batch; ``_micro.switch_batch``);
   a row scan [3, 1000, 13] along axis 1 and G8's chain on [3, 40], x at
   the int32 extremes, bitwise at the same batches; B = 1 bitwise the
   plain version of the JAX probe's inputs on the CPU, the plain version's
   time at B = 1 (the median of three warm calls) and the library call's
   on the device alone where one computes the probe (``torch.gather`` for
   E1-E3, ``torch.sum`` over the gathered axis for E1b, G1, G2 and H5,
   ``Tensor.scatter`` for E6), each probe's line with the one-block
   design's times beside the kernel's. Phases 13 and 14 are one function,
   ``probe_phase``, under one time limit each.
14. The render-design probes (``sdf_tools_tpu_torch/scripts/
   probe_smem_block.py``, ``probe_dma_align.py``,
   ``bench_micro_render{,2,3,4,5,6}.py``, the three kernels of
   ``csrc/micro_render.cu``; the TPU probes of ``scripts/`` of the same
   names), under a time limit (a copy whose barrier never completes traps
   in the kernel; a hang past the limit ends the run): the eight programs'
   ``main`` on the card (launches reset before and read after; each of
   the 30 variants must have launched, S1's, S2's and D1's own checks
   against numpy must hold exactly), each timing its kernel on the device
   alone at B = 1 and B_fill (R5 and R6 at two iteration counts, and their
   slope), with the copy rate of the copy probes; then each variant's
   kernel bitwise its plain version at B = 1 and B_fill, the 27 variants
   of ``micro_band_sum``, ``micro_sampler`` and R6's three copies of
   ``micro_band_copy`` (several blocks an instance at a small batch) also
   on both sides of their geometry's first switch
   (the plain version's time at B = 1, as in 13), ``mxu`` bitwise
   ``full``, ``unroll8`` ``dyn2d`` and ``dma_ovl`` ``dma``, B = 1 bitwise
   the plain version of the JAX probe's inputs on the CPU, D1's library
   call (``torch.take`` of its bands' flat indices) on the device alone,
   and each redesigned variant's line with the one-block design's times.
15. The signed field in float64, bfloat16 and float16 at 512^3
   (``make_scene(512)``, res 0.05): ``signed_field_from_masks`` and
   ``signed_field_virtual_border`` in each dtype, from the tensor and from
   the numpy mask with ``device="cuda"``, with launch counts reset before
   and read after (exactly K1 and K2, K1 -> K2 -> K2 a field; no K3, which
   only the float32 route takes); each field and extremum bitwise equal to
   the plain path (``edt.signed_from_d2``, ``edt.virtual_border_combine``)
   on the card's own d^2 copied to the host, in the same dtype; the numpy
   masks' outputs bitwise the tensors'; free cells positive and filled
   cells negative; each dtype within 4 units of its roundoff of the float64
   field (float32: the fused field), float16 infinite exactly where d^2
   rounds past its range; each route's CUDA-event time and peak memory
   beside the float32 fused route's.
16. The exact march's kernel (``csrc/render_march.cu``), ``march_phase``:
   equal to ``render._march`` on the card in depth, hit and steps at the
   training step's 1024^2 bundle (coarse skip on and off), the tail resume
   march's and the fallback's ray counts, a rotated grid and degenerate
   rays; the plane sweep of four views with the kernel equal to the same
   render with ``_march`` in its place; the IFT backward's gradients
   through both forwards equal; one launch a call; kernel against plain
   and the bytes bound at the bundle and at 20,000 rays; the first call in
   a fresh process (``tools/march_first_call.py``) within 0.2 s of a warm
   one.
17. One JSON line with the kernels (the eight probe kernels with their
   probes' numbers nested), then the last line
   ``{"ok": true, "device": {...}}``.

Imports neither JAX nor ``sdf_tools_tpu`` nor ``bench.py`` (its scene is the
port's copy, ``sdf_tools_tpu_torch/scripts/_scenes.py``).
"""
from __future__ import annotations

import ctypes
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

from sdf_tools_tpu_torch.scripts._scenes import baseline_image, device_scene, make_scene, scene_spheres

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
    # bound per ray (MARCH_BYTES_PER_RAY), not per cell: march_phase
    "march": ("sdf_tools_tpu_torch/csrc/render_march.cu",
              "replaces no Pallas kernel: the JAX march is plain XLA", None, None),
}
# the exact march (phase 16): rays a call of the plane sweep's tail resume
# march (a few hundred) and of its fallback (about 20,000 in the render
# cell), the training step's bundle being IMAGE_HW's
MARCH_TAIL_RAYS = (1, 37, 300, 700)
MARCH_FALLBACK_RAYS = 20000
MARCH_VIEWS = 4  # the render cell's views a call
# bytes a ray: origin and direction in (24), depth, hit and steps out (9),
# and the least it gathers, one trilinear stencil's 8 cells (32)
MARCH_BYTES_PER_RAY = 24 + 9 + 32
MARCH_FIRST_CALL_MAX_MS = 200.0  # the first call's cost over a warm one, in a fresh process
SERVING_KERNELS = ("line_pass_dual", "envelope_dual", "envelope_dual_combine", "plane_sweep")
# phase 10's paths: the sharded fields (K1-K3, K4-K5), the slab and tile renders (K8)
MESH_KERNELS = ("line_pass_dual", "envelope_dual", "envelope_dual_combine", "line_pass", "envelope", "plane_sweep")
TRAINING_KERNELS = ("envelope_carry", "winner_segment_sum")
CONFIG5_KERNELS = ("line_pass", "envelope", "envelope_cht")
# phase 11's paths: the field, the examples and the CLI (K1-K3), the FD
# renders (K8), the carve's FT forward and backward (K6, K7)
ENTRY_KERNELS = ("line_pass_dual", "envelope_dual", "envelope_dual_combine", "plane_sweep", "envelope_carry",
                 "winner_segment_sum")


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

    from sdf_tools_tpu_torch.scripts import _timing

    if host_clock:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3
    return _timing.cuda_timed(fn)


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


def warm_ms(fn, runs: int = 6, time_one=cuda_ms):
    """(first, runs): ``time_one``'s ms of a first call of ``fn``, kept
    apart, and of ``runs`` more calls in order."""
    return time_one(fn), [time_one(fn) for _ in range(runs)]


def spread(ts, first=None):
    return (f"{np.median(ts):.3f} ms (median of {len(ts)}; min {min(ts):.3f}, max {max(ts):.3f}; in order "
            + ", ".join(f"{t:.3f}" for t in ts) + ("" if first is None else f"; after a first call of {first:.3f}")
            + ")")


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


def same_bits(a, b) -> bool:
    """Two tensors or arrays equal bit for bit: one shape and dtype, float32
    compared as int32 (compared on the host when their devices differ)."""
    import torch

    a, b = (torch.as_tensor(x).detach() for x in (a, b))
    if a.device != b.device:
        a, b = a.cpu(), b.cpu()
    a, b = a.contiguous(), b.contiguous()
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and a.dtype == b.dtype and bool(torch.equal(a, b))


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
    docstring). Returns the K1-K3 launches of its checked runs, and its
    512^3 field, 512^3 map and tagged map with segments for phase 10."""
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
    ext_ok = same_bits(ext[0].cpu(), ext[1])
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
                and same_bits(a.origin_transform, b.origin_transform.to(a.origin_transform.device))
                and same_bits(a.inv_origin_transform, b.inv_origin_transform.to(a.inv_origin_transform.device)))

    def same_grid(a, b) -> bool:
        fields = [f.name for f in dataclasses.fields(a) if f.name != "meta"]
        ok_ = same_meta(a.meta, b.meta)
        for f in fields:
            x_, y_ = getattr(a, f), getattr(b, f)
            ok_ &= same_bits(x_, y_.to(x_.device)) if isinstance(x_, torch.Tensor) else x_ == y_
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
    same = [same_bits(a, b) for a, b in zip(card, host)]
    log(f"[phase9] casts: {len(pts)} points (NaN, +-inf, +-1e30, 3e9 on each axis, one finite) through"
        f" location_to_index, location_in_bounds, get_value_by_location, estimate_distance, smooth_gradient,"
        f" voxelize_points and a 4-step march: card == CPU bitwise {same}; in bounds {card[1].tolist()}")
    check(all(same) and card[1].sum() == 1, "casts: card != CPU")
    del sdf_cpu

    torch.cuda.synchronize()
    phase_peak[0] = max(phase_peak[0], torch.cuda.max_memory_allocated())
    log(f"[timing] phase 9 stages, card: {smi}")
    for name, ts in stage_ms.items():
        log(f"[timing] {name}: first run {ts[0]:.3f} ms, then {spread(ts[1:])} (host clock); peak"
            f" {stage_peak[name] / 2**30:.3f} GiB")
    log(f"[memory] phase 9 peak {phase_peak[0] / 2**30:.3f} GiB, of which {held / 2**30:.3f} GiB held from earlier phases")
    log(f"[phase9] phase time {time.perf_counter() - t_phase:.1f} s; K1-K3 launches {json.dumps(total)}")
    return total, {"sdf": sdf4, "cmap": cmap, "tseg": tseg}


# ---- phase 10: config #5's mesh and the last modules -------------------------

MESH_RANKS = 2  # (a) and (c): config #5's x-slab mesh, ranks on the one card
MESH_TILES = (2, 2)  # (b): the (x, y) tile mesh
MESH_HALO = 2
MESH_MAX_STEPS = 96
# the JAX package's sharded render bars, by the backend each rank resolved
# to: (hits that differ from the single-device render's, at most this share
# of rays; common-hit depths within this times res), interior rays agreeing
# (``_depth_bars``): the march's tests/test_sharded.py:276-282, the plane
# sweep's :331-336
MESH_BARS = {"march": (0.03, 0.5), "plane": (0.01, 1.0)}
DENSE_STEP = 1.0 / 16  # x res: the sampling of a ray's crossings (``_crossing_runs``)
MESH_RENDER_BACKENDS = ("auto", "march")  # the main path's (the plane sweep), and the exact march
TRAIN_GRID = N
TRAIN_IMAGE = (256, 256)
TRAIN_POINTS = 1 << 18  # a closed shell at 512^3 (about two points a surface cell)
TRAIN_STEP_LR = 1e-2
# the sharded step against the single-process step of the same forward:
# the same float operations, summed in another order (the gradient's
# reduction over ranks, the halo cotangents, the card's atomics)
TRAIN_GRAD_RTOL, TRAIN_GRAD_ATOL_REL = 1e-4, 1e-5
TRAIN_LOSS_RTOL = 1e-5
# the sharded forward's loss against the untiled single-device forward's:
# the depth bars let silhouette rays flip, each by up to (t_max - target)^2,
# 1.7e-5 of this configuration's loss; 1e-3 admits about 60 of 65,536
TRAIN_FWD_LOSS_RTOL = 1e-3
BUILDER_PRIMS = 12
CROP = 128  # card against CPU on CROP^3 crops (the builder's first, viz's middle)
SPARSE_CHUNK = 16
RANK_TIMEOUT_S = 600
NCCL = "nccl"  # (d)'s backend


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _torus_mesh(c, big_r: float, r: float, nu: int = 48, nv: int = 24):
    """A watertight torus (vertices [nu * nv, 3] f32, faces int32) around
    ``c``, its axis along z."""
    u = 2 * np.pi * np.arange(nu)[:, None] / nu
    w = 2 * np.pi * np.arange(nv)[None, :] / nv
    verts = np.stack([(big_r + r * np.cos(w)) * np.cos(u), (big_r + r * np.cos(w)) * np.sin(u),
                      r * np.sin(w) + 0 * u], -1).reshape(-1, 3)
    faces = []
    for i in range(nu):
        for j in range(nv):
            a, b = i * nv + j, ((i + 1) % nu) * nv + j
            b1, a1 = ((i + 1) % nu) * nv + (j + 1) % nv, i * nv + (j + 1) % nv
            faces += [(a, b, b1), (a, b1, a1)]
    return (verts + np.asarray(c)).astype(np.float32), np.array(faces, np.int32)


def _train_inputs(cfg, seed: int = 0):
    """(points [1, TRAIN_POINTS, 3], target [1, H, W]): a sphere shell at a
    fifth of the grid around its centre, and a constant depth target."""
    rng = np.random.default_rng(seed)
    center = np.full(3, 0.5 * cfg.grid_n * cfg.resolution)
    u = rng.normal(size=(1, TRAIN_POINTS, 3))
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    pts = (center + u * (0.2 * cfg.grid_n * cfg.resolution)).astype(np.float32)
    return pts, np.full((1, cfg.image_h, cfg.image_w), 1.4 * cfg.grid_n * cfg.resolution, np.float32)


def _train_cfg():
    from sdf_tools_tpu_torch.parallel import train

    n = TRAIN_GRID
    return train.PipelineConfig(grid_n=n, resolution=RES, image_h=TRAIN_IMAGE[0], image_w=TRAIN_IMAGE[1],
                                t_max=4 * n * RES, lr=TRAIN_STEP_LR)


def _bench_rays(n: int, dev):
    """bench.py's camera (phase 4's and 7's) at n^3: 1024^2 rays."""
    from sdf_tools_tpu_torch.ops import render

    c = np.full(3, 0.5 * n * RES)
    cam = c + np.array([-1.2, 0.0, 0.4]) * n * RES
    return render.camera_rays(cam, c, (0.0, 0.0, 1.0), 50.0, *IMAGE_HW, device=dev)


def _render_kw(n: int) -> dict:
    return dict(t_max=4 * n * RES, eps=RENDER_EPS, max_steps=MESH_MAX_STEPS)


def _rank_stage(fn):
    """(output, host-clock ms of the checked call and of one more, peak
    bytes) on this rank; launches are read between the two calls."""
    import torch
    from sdf_tools_tpu_torch.ops import edt_cuda

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    edt_cuda.reset_launches()
    out, ms = timed(fn, host_clock=True)
    launched = {k: c for k, c in edt_cuda.LAUNCHES.items() if c}
    peak = torch.cuda.max_memory_allocated()
    again = timed(fn, host_clock=True)[1]
    return out, (ms, again), peak, launched


def _ref_equal(got, path: str, cut) -> bool:
    """``got`` (this rank's tile) bitwise equal to the tile ``cut`` of the
    reference saved at ``path``."""
    import torch

    return same_bits(got, torch.from_numpy(np.array(np.load(path, mmap_mode="r")[cut])).to(got.device))


def _job_fields(job, dev, ref_dir):
    """(a), (b), (d): this rank's tile of make_scene(n); the sharded signed
    field (x slabs, or both 2-D methods on tiles), against the parent's
    single-device field; on slabs the sharded d^2 against squared_edt; the
    sharded render of 1024^2 rays against nothing here (the parent holds
    the single-device render)."""
    import torch
    from sdf_tools_tpu_torch import GridMeta
    from sdf_tools_tpu_torch.ops import render
    from sdf_tools_tpu_torch.parallel import sharded

    n = job["n"]
    mesh = sharded.make_mesh(job["mesh"])
    ax = mesh.axis("x")
    ay = mesh.axis("y") if "y" in mesh.names else None
    nl = n // ax.size
    ml = n // ay.size if ay else n
    x0, y0 = ax.index * nl, (ay.index * ml if ay else 0)
    cut = (slice(x0, x0 + nl), slice(y0, y0 + ml))
    mask = device_scene(n, dev, x_range=(x0, x0 + nl), y_range=(y0, y0 + ml))[0]
    out = {"ms": {}, "peak": {}, "stats": {}, "launches": {}, "ok": {}}

    def stage(name, fn):
        mesh.stats.reset()
        res_, out["ms"][name], out["peak"][name], out["launches"][name] = _rank_stage(fn)
        out["stats"][name] = mesh.stats.summary()  # the two calls'
        return res_

    field = None
    for method in (("reshard", "halo") if ay else (None,)):
        name = f"field {method}" if method else "field"
        f_ = stage(name, (lambda m=method: sharded.sharded_signed_field_2d(mask, RES, method=m, mesh=mesh)) if ay
                   else (lambda: sharded.sharded_signed_field(mask, RES, mesh=mesh)))
        out["ok"][name] = _ref_equal(f_, f"{ref_dir}/field{n}.npy", cut)
        field = f_ if field is None else field
        del f_
    if job.get("d2"):
        d2 = stage("d2", lambda: sharded.sharded_squared_edt(mask, mesh=mesh))
        out["ok"]["d2"] = _ref_equal(d2, f"{ref_dir}/d2_{n}.npy", cut)
        del d2
    del mask
    if job.get("render"):
        meta = GridMeta.create(torch.eye(4, device=dev), RES, (n, n, n), device=dev)
        o, v = _bench_rays(n, dev)
        ext = (nl + 2 * MESH_HALO, ml + 2 * MESH_HALO if ay else n, n)
        out["backend"] = render._resolve_backend("auto", ext, o)
        out["depth"], out["hit"] = {}, {}
        for backend in MESH_RENDER_BACKENDS:  # "auto" is the main path (K8 on the card)
            if ay:
                fn = lambda b=backend: sharded.sharded_render_depth_2d(  # noqa: E731
                    field, meta, 1e3, o, v, halo=MESH_HALO, backend=b, mesh=mesh, **_render_kw(n))
            else:
                fn = lambda b=backend: sharded.sharded_render_depth(  # noqa: E731
                    field, meta, 1e3, o, v, halo=MESH_HALO, backend=b, mesh=mesh, **_render_kw(n))
            depth, hit = stage(f"render {backend}", fn)
            if mesh.rank == 0:
                out["depth"][backend], out["hit"][backend] = depth.cpu().numpy(), hit.cpu().numpy()
    return out


def _job_train(job, dev, ref_dir):
    """(b), (c): one step of the sharded training step; rank 0 returns the
    new points and the loss."""
    import torch
    from sdf_tools_tpu_torch.parallel import sharded, train

    mesh = sharded.make_mesh(job["mesh"])
    cfg = _train_cfg()
    pts, target = (torch.as_tensor(a, device=dev) for a in _train_inputs(cfg))
    make = train.make_train_step_2d if "y" in mesh.names else train.make_train_step
    step = make(mesh, cfg)
    mesh.stats.reset()
    (new_pts, loss), ms, peak, launched = _rank_stage(lambda: step(pts, target))
    out = {"ms": {"step": ms}, "peak": {"step": peak}, "stats": {"step": mesh.stats.summary()},
           "launches": {"step": launched}, "ok": {}}
    forward = train._forward_local_2d if "y" in mesh.names else train._forward_local
    with torch.no_grad():
        depth = forward(pts[0], cfg, mesh)  # the step's forward, for the untiled check
    if mesh.rank == 0:
        out["points"], out["loss"], out["depth"] = new_pts.cpu().numpy(), float(loss), depth.cpu().numpy()
    return out


MESH_JOBS = {"fields": _job_fields, "train": _job_train}


def _mesh_rank(rank: int, world: int, port: int, backend: str, device: str, jobs, ref_dir: str, results) -> None:
    """A rank of phase 10 (a process of its own on the parent's ``device``):
    the jobs in order, their outputs (or the traceback) put on ``results``."""
    import traceback

    try:
        import torch
        import torch.distributed as dist
        from sdf_tools_tpu_torch import _build
        from sdf_tools_tpu_torch.parallel import runtime

        torch.backends.cuda.matmul.allow_tf32 = False
        dev = torch.device(device)
        torch.cuda.set_device(dev)
        _build.library()  # the parent's build
        runtime.initialize(f"tcp://localhost:{port}", world, rank, backend=backend)
        outs = {job["name"]: MESH_JOBS[job["kind"]](job, dev, ref_dir) for job in jobs}
        outs["backend"] = dist.get_backend()
        dist.destroy_process_group()
        results.put((rank, None, outs))
    except BaseException:
        results.put((rank, traceback.format_exc(), None))
        raise


def _run_ranks(world: int, backend: str, device, jobs, ref_dir: str):
    """Start ``world`` ranks (spawned processes on ``device``), wait for each
    one's outputs; any rank's traceback or non-zero exit fails the run.
    Returns the outputs in rank order."""
    import multiprocessing as mp
    import queue

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_mesh_rank, args=(r, world, port, backend, str(device), jobs, ref_dir, results))
             for r in range(world)]
    for p in procs:
        p.start()
    got = {}
    deadline = time.perf_counter() + RANK_TIMEOUT_S
    try:
        while len(got) < world:
            try:
                rank, err, outs = results.get(timeout=5)
            except queue.Empty:
                dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                check(not dead and time.perf_counter() < deadline, f"ranks: exit codes {[p.exitcode for p in procs]}")
                continue
            check(err is None, f"rank {rank} of {world} failed:\n{err}")
            got[rank] = outs
        for p in procs:
            p.join(timeout=60)
        check(all(p.exitcode == 0 for p in procs), f"ranks: exit codes {[p.exitcode for p in procs]}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return [got[r] for r in range(world)]


def _crossing_runs(grid, o, v, t_max: float, eps: float):
    """Per ray (o, v [K, 3] on the grid's device): the runs of samples,
    every ``DENSE_STEP`` res along t in [0, t_max), at which the grid's
    trilinear distance is below ``eps``; a list of K (starts, lengths)
    pairs of float arrays in t."""
    import torch
    from sdf_tools_tpu_torch.ops import query

    step = grid.meta.resolution_float * DENSE_STEP
    ts = torch.arange(0.0, t_max, step, device=o.device)
    runs = []
    for r0 in range(0, o.shape[0], 512):
        oo, vv = o[r0 : r0 + 512], v[r0 : r0 + 512]
        below = []
        for k in range(0, len(ts), 2048):
            tt = ts[k : k + 2048]
            d, ok = query.estimate_distance(grid, (oo[:, None] + tt[None, :, None] * vv[:, None]).reshape(-1, 3))
            below.append((ok & (d < eps)).reshape(oo.shape[0], -1).cpu().numpy())
        below = np.concatenate(below, 1)
        edges = np.diff(np.pad(below.astype(np.int8), ((0, 0), (1, 1))), axis=1)
        for e in edges:
            up, down = np.flatnonzero(e == 1), np.flatnonzero(e == -1)
            runs.append((up * step, (down - up) * step))
    return runs


def _field_judge(runs, depth, hit, tol: float):
    """([K] right, [K] on a surface) of each ray's render (depth, hit) by
    the field's crossings ``runs`` (``_crossing_runs``). A run thinner than
    the march's least step (res / 2) may be stepped over; so a hit is right
    where it lies within ``tol`` of a run's start and no thicker run starts
    before that, and a miss is right where the ray has no thicker run. On a
    surface: a hit within ``tol`` of a run (its start, its end or between),
    or a miss."""
    least = 0.5 * RES
    right, on = np.zeros(len(runs), bool), np.zeros(len(runs), bool)
    for i, (starts, lengths) in enumerate(runs):
        solid = starts[lengths >= least]
        if not hit[i]:
            right[i] = solid.size == 0
            on[i] = True
        else:
            at = np.abs(starts - depth[i]) <= tol
            right[i] = at.any() and not (solid < starts[at].min() - tol).any()
            on[i] = ((starts - tol <= depth[i]) & (depth[i] <= starts + lengths + tol)).any()
    return right, on


def _depth_bars(depth, hit, ref, dense, backend: str, where: str) -> str:
    """The sharded depth image against ``ref`` = (depth, hit), the
    single-device render of the same field with the ranks' outer halo (2 res
    beyond the volume's faces along the mesh axes), with the depth part of
    the JAX package's sharded render bars for ``backend`` (``MESH_BARS``:
    interior rays agree, common hits within res / 2, res for the plane
    sweep). Interior rays: the ray's 3 x 3 neighbourhood in ``ref`` all
    miss, or all hit within 2 res of one another. Where the two disagree
    (hit masks, or depths beyond the bar), each is judged by the field's
    crossings along the ray (``dense(rays)``, ``_field_judge``): the march
    is approximate (a graze can use up its rounds), and a tile restarts it.
    Required on each such ray: the sharded render is right, or neither is
    and the sharded hit lies on one of the field's surfaces (a tile placed
    at the wrong offset, or a band that misses its cells, fails this).
    Returns the log text."""
    from scipy import ndimage

    d_r, h_r = ref
    lo = ndimage.minimum_filter(np.where(h_r, d_r, np.inf), 3, mode="nearest")
    hi = ndimage.maximum_filter(np.where(h_r, d_r, -np.inf), 3, mode="nearest")
    interior = ~ndimage.maximum_filter(h_r, 3, mode="nearest") | (
        ndimage.minimum_filter(h_r, 3, mode="nearest") & (hi - lo <= 2 * RES))
    hit_max, tol = MESH_BARS[backend][0], MESH_BARS[backend][1] * RES
    both = interior & hit & h_r
    err = np.abs(depth - d_r)
    far = both & (err > tol)
    lost, extra = interior & h_r & ~hit, interior & hit & ~h_r
    differ = np.flatnonzero(far | lost | extra)
    check(differ.size <= hit_max * hit.size, f"{where}: {differ.size} interior rays disagree")
    runs = dense(differ)
    right, on = _field_judge(runs, depth.reshape(-1)[differ], hit.reshape(-1)[differ], tol)
    ref_right, _ = _field_judge(runs, d_r.reshape(-1)[differ], h_r.reshape(-1)[differ], tol)
    ok = (right | (~ref_right & on)).all()
    e = err[both]
    text = (f"on its {int(interior.sum())} interior rays common-hit |depth diff| median"
            f" {np.median(e) if e.size else 0.0:.6f}, p95 {np.quantile(e, 0.95) if e.size else 0.0:.6f}, max"
            f" {e.max() if e.size else 0.0:.6f}; they disagree on {differ.size} (beyond {tol / RES:g} res {int(far.sum())},"
            f" hit only there {int(lost.sum())}, hit only by the sharded render {int(extra.sum())}); by the field's"
            f" crossings the sharded render is right on {int(right.sum())}, the single one on {int(ref_right.sum())},"
            f" neither on {int((~right & ~ref_right).sum())}, the sharded hit then on a surface on"
            f" {int((~right & ~ref_right & on).sum())} (res {RES})")
    check(both.any() and ok, f"{where}: {text}")
    return text


def _render_bars(depth, hit, single, padded, tiles, dense, backend: str, where: str) -> str:
    """The sharded render (rank 0's, replicated) against three renders of
    the same backend in this process (``backend``: the one the ranks
    resolved to), every bar required: ``single``, the field's single-device
    render, with the JAX sharded render tests' hit bar (``MESH_BARS``);
    ``padded``, the single-device render of the field with the ranks' outer
    halo, with the depth bars (``_depth_bars``); and ``tiles``, the ranks'
    tiles marched here one after another from the padded field and
    composited (the same work without collectives): bitwise. Returns the
    log text."""
    differ_s = hit != single[1]
    both_s = hit & single[1]
    err_s = np.abs(depth - single[0])
    same = bool(np.array_equal(hit, tiles[1]) and np.array_equal(depth.view(np.int32), tiles[0].view(np.int32)))
    text = (f"bitwise the tiles marched in one process {same}; against the single render: hits differ on"
            f" {int(differ_s.sum())} of {hit.size} rays ({differ_s.mean():.5f}), common-hit |depth diff| median"
            f" {np.median(err_s[both_s]):.6f}, p95 {np.quantile(err_s[both_s], 0.95):.6f}; against the padded"
            f" render: hits differ on {int((hit != padded[1]).sum())}; ")
    check(same and differ_s.mean() <= MESH_BARS[backend][0], f"{where}: sharded render ({backend}): {text}")
    return text + _depth_bars(depth, hit, padded, dense, backend, f"{where}: sharded render ({backend})")


def _dense_fn(grid, rays, t_max: float):
    """``dense(rays)`` for ``_depth_bars``: the crossings (``_crossing_runs``)
    along the rays (flat indices into the image) of the camera ``rays``
    through ``grid``."""
    import torch

    o, v = (x.reshape(-1, 3) for x in rays)

    def dense(idx):
        i = torch.as_tensor(idx, dtype=torch.long, device=o.device)
        return _crossing_runs(grid, o[i], v[i], t_max, RENDER_EPS)

    return dense


def _forward_check(out, untiled, dense, cfg, where: str) -> str:
    """The sharded forward's depth image (``out["depth"]``, rank 0's) and
    the step's loss against the untiled single-device forward's
    (``train.untiled_forward``, ``untiled`` = (depth, loss, the backend it
    resolved to)): the hit bar and the depth bars (``MESH_BARS``,
    ``_depth_bars``), and the loss within ``TRAIN_FWD_LOSS_RTOL``."""
    depth, (d_u, loss_u, backend) = out["depth"], untiled
    hit, h_u = depth < cfg.t_max, d_u < cfg.t_max
    differ = (hit != h_u).mean()
    text = (f"backend {backend}; hits differ on {int((hit != h_u).sum())} of {hit.size} rays ({differ:.5f}); loss"
            f" {out['loss']:.6f} vs {loss_u:.6f} (rel. {abs(out['loss'] - loss_u) / abs(loss_u):.2e}); ")
    check(differ <= MESH_BARS[backend][0] and abs(out["loss"] - loss_u) <= TRAIN_FWD_LOSS_RTOL * abs(loss_u),
          f"{where}: sharded forward: {text}")
    return text + _depth_bars(depth, hit, (d_u, h_u), dense, backend, f"{where}: sharded forward")


def _grad_check(pts, got, want, loss, want_loss, p: int, where: str) -> str:
    """The sharded step's gradient and loss against the single-process
    step's; the text also gives the distance to ``p`` (the volume axes'
    size) times the gradient, the JAX package's sharded gradient."""
    g, w = (pts - got) / TRAIN_STEP_LR, (pts - want) / TRAIN_STEP_LR
    err = np.abs(g - w)
    bound = TRAIN_GRAD_RTOL * np.abs(w) + TRAIN_GRAD_ATOL_REL * np.abs(w).max()
    text = (f"loss {loss:.6f} vs {want_loss:.6f}; gradient max |diff| {err.max():.3e} of max |grad|"
            f" {np.abs(w).max():.3e} ({int((err > bound).sum())} beyond rtol {TRAIN_GRAD_RTOL}, atol"
            f" {TRAIN_GRAD_ATOL_REL} max); max |diff| from {p} times it {np.abs(g - p * w).max():.3e}")
    check(np.abs(w).max() > 0 and (err <= bound).all() and abs(loss - want_loss) <= TRAIN_LOSS_RTOL * abs(want_loss),
          f"{where}: {text}")
    return text


def _rank_log(tag: str, outs, job: str) -> dict:
    """Log each rank's ms (the checked call, then one more), peak and
    collective bytes of ``job``; returns the ranks' launches summed (the
    checked calls')."""
    total = {}
    for r, o in enumerate(outs):
        o = o[job]
        for name, (first, again) in o["ms"].items():
            st = o["stats"][name]
            log(f"[phase10] {tag} rank {r} {name}: {first:.1f} ms, again {again:.1f} ms (host clock), peak"
                f" {o['peak'][name] / 2**30:.3f} GiB; collectives of the two calls {json.dumps(st['calls'])}, bytes"
                f" {json.dumps(st['bytes'])}, staged through the host"
                f" {json.dumps({k: v for k, v in st['staged'].items() if v})}, largest {st['max_elems']} elements"
                + (f", halo rounds {st['halo_rounds']}" if st["halo_rounds"] else "")
                + f"; launches {json.dumps(o['launches'][name])}")
            for k, c in o["launches"][name].items():
                total[k] = total.get(k, 0) + c
    return total


def mesh_phase(dev, smi: str, mask_np: np.ndarray, outs9: dict) -> dict:
    """Phase 10 (module docstring). Returns the kernel launches of its
    main-path runs (the ranks', summed, and the builder's)."""
    import tempfile

    import torch
    from sdf_tools_tpu_torch import GridMeta, SdfGrid, profiling, scene, sparse, viz
    from sdf_tools_tpu_torch.ops import edt, edt_cuda, render, voxelize
    from sdf_tools_tpu_torch.parallel import sharded, train

    t_phase = time.perf_counter()
    timer = profiling.StageTimer()
    launches = {}

    def count(got):
        for k, c in got.items():
            launches[k] = launches.get(k, 0) + c

    tmp = tempfile.TemporaryDirectory()
    ref_dir = tmp.name
    eye = torch.eye(4, device=dev)

    # ---- references in this process, saved and freed before the ranks ---
    # (the padded fields stay, 4.3 GiB at 1024^3: ``_depth_bars`` samples
    # rays through them after the ranks)
    with timer.stage("references", sync=dev):
        refs, dense = {}, {}
        for n in (N5, N):
            mask = device_scene(n, dev)[0]
            if n == N:
                check(np.array_equal(mask.cpu().numpy(), mask_np), f"device_scene({N}) != make_scene({N})")
            field = edt.signed_field_from_masks(mask, RES)[0]
            np.save(f"{ref_dir}/field{n}.npy", field.cpu().numpy())
            if n == N5:
                np.save(f"{ref_dir}/d2_{n}.npy", edt.squared_edt(mask).cpu().numpy())
            del mask
            meta = GridMeta.create(eye, RES, (n, n, n), device=dev)
            rays, kw = _bench_rays(n, dev), _render_kw(n)
            # the ranks pad the volume's faces along their mesh axes (x at 1024^3, x and y at 512^3)
            faces = 1 if n == N5 else 2
            pad = [0, 0, 0, 0, MESH_HALO, MESH_HALO] if faces == 1 else [0, 0] + [MESH_HALO] * 4
            padded = torch.nn.functional.pad(field, pad, value=2.0 * RES)
            dense[n] = _dense_fn(sharded._tile_grid(padded, meta, 1e3, (-MESH_HALO,) * faces), rays, kw["t_max"])
            tiles = (MESH_RANKS,) if faces == 1 else MESH_TILES
            local = [n // t for t in tiles]
            for backend in MESH_RENDER_BACKENDS:
                r = render.render_depth(SdfGrid.create(field, meta, 1e3), *rays, backend=backend, **kw)
                refs[(n, backend)] = (r.depth.cpu().numpy(), r.hit.cpu().numpy())
                # the ranks' halos (the tile render may widen y's for the plane sweep)
                halos = ((MESH_HALO,) if faces == 1
                         else sharded.tile_halos((local[0], local[1], n), MESH_HALO, rays[0], backend))
                hx, hy = halos[0], (halos[1] if faces == 2 else 0)
                padded = torch.nn.functional.pad(field, [0, 0, hy, hy, hx, hx], value=2.0 * RES)
                d_, h_ = sharded.render_tile(padded, meta, 1e3, [-h for h in halos], *rays, 0.0, kw["t_max"],
                                             kw["eps"], kw["max_steps"], None, backend)
                refs[(n, backend, "padded")] = (d_.cpu().numpy(), h_.cpu().numpy())
                # the ranks' tiles marched here, one after another, and composited
                depths, hits = [], []
                for coords in np.ndindex(*tiles):
                    cut = tuple(slice(k * m, (k + 1) * m + 2 * h) for k, m, h in zip(coords, local, halos))
                    d_, h_ = sharded.render_tile(padded[cut].contiguous(), meta, 1e3,
                                                 [k * m - h for k, m, h in zip(coords, local, halos)], *rays, 0.0,
                                                 kw["t_max"], kw["eps"], kw["max_steps"], None, backend)
                    depths.append(d_)
                    hits.append(h_)
                d_ = train._composite_local(depths, hits, kw["t_max"])
                refs[(n, backend, "tiles")] = (d_.cpu().numpy(), torch.stack(hits).any(0).cpu().numpy())
                refs[(n, backend, "halos")] = halos
                del depths, hits
            del field, r, padded, d_, h_
        cfg = _train_cfg()
        pts_np, target_np = _train_inputs(cfg)
        for tiles in ((MESH_RANKS,), MESH_TILES):
            new, loss = train.reference_step(cfg, torch.as_tensor(pts_np, device=dev),
                                             torch.as_tensor(target_np, device=dev), tiles)
            refs[tiles] = (new.cpu().numpy(), float(loss))
            # the untiled single-device forward, which shares no tile with the ranks
            depth, grid = train.untiled_forward(cfg, torch.as_tensor(pts_np[0], device=dev), tiles)
            loss = float(((depth - torch.as_tensor(target_np[0], device=dev)) ** 2).sum()) / depth.numel()
            backend = render._resolve_backend("auto", grid.values.shape, train._camera(cfg, dev)[0])
            refs[tiles, "untiled"] = (depth.cpu().numpy(), loss, backend)
            dense[tiles] = _dense_fn(grid, train._camera(cfg, dev), cfg.t_max)
            del new, depth, grid
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    log(f"[phase10] references (single-device fields at {N5}^3 and {N}^3, d^2 at {N5}^3, renders, the training"
        f" steps' single-process form) in {timer.stages['references']:.1f} s; card memory before the ranks"
        f" {torch.cuda.memory_allocated() / 2**30:.3f} GiB")

    # ---- (a) + (c): config #5's x-slab mesh, 2 ranks over gloo ----------
    jobs = [dict(name="a", kind="fields", n=N5, mesh={"x": MESH_RANKS}, d2=True, render=True),
            dict(name="c", kind="train", mesh={"dp": 1, "x": MESH_RANKS})]
    with timer.stage("(a) + (c): 2 ranks", sync=dev):
        outs = _run_ranks(MESH_RANKS, "gloo", dev, jobs, ref_dir)
    count(_rank_log(f"(a) {N5}^3 x-slabs", outs, "a"))
    oks = [o["a"]["ok"] for o in outs]
    log(f"[phase10] (a) {N5}^3 on {MESH_RANKS} ranks ({outs[0]['backend']}): each rank's slab bitwise equal to the"
        f" single-device field / squared_edt: {oks}; the slab render resolved to {[o['a']['backend'] for o in outs]}")
    check(all(all(ok.values()) for ok in oks), f"(a): sharded field or d^2 != single-device: {oks}")
    for backend in MESH_RENDER_BACKENDS:
        resolved = outs[0]["a"]["backend"] if backend == "auto" else backend
        text = _render_bars(outs[0]["a"]["depth"][backend], outs[0]["a"]["hit"][backend], refs[(N5, backend)],
                            refs[(N5, backend, "padded")], refs[(N5, backend, "tiles")], dense[N5], resolved,
                            f"(a) {N5}^3")
        log(f"[phase10] (a) sharded render {IMAGE_HW[0]}x{IMAGE_HW[1]} over {N5}^3, backend {backend!r}, vs the"
            f" single-device render: {text}")
    count(_rank_log(f"(c) train {TRAIN_GRID}^3", outs, "c"))
    want_pts, want_loss = refs[(MESH_RANKS,)]
    text = _grad_check(pts_np, outs[0]["c"]["points"], want_pts, outs[0]["c"]["loss"], want_loss, MESH_RANKS,
                       "(c)")
    big = max(o["c"]["stats"]["step"]["max_elems"] for o in outs)
    log(f"[phase10] (c) make_train_step (dp=1, x={MESH_RANKS}) at {TRAIN_GRID}^3, {TRAIN_IMAGE[0]}x{TRAIN_IMAGE[1]}"
        f" rays, {TRAIN_POINTS} points vs the single-process step: {text}; largest collective {big} elements"
        f" (volume {TRAIN_GRID**3})")
    log(f"[phase10] (c) the sharded forward vs the untiled single-device forward:"
        f" {_forward_check(outs[0]['c'], refs[(MESH_RANKS,), 'untiled'], dense[(MESH_RANKS,)], cfg, '(c)')}")
    check(0 < big < TRAIN_GRID**3, f"(c): a collective moved {big} elements")
    del outs

    # ---- (b): the 2-D tile mesh, 4 ranks over gloo -----------------------
    ranks_b = MESH_TILES[0] * MESH_TILES[1]
    tiles_mesh = {"x": MESH_TILES[0], "y": MESH_TILES[1]}
    jobs = [dict(name="b", kind="fields", n=N, mesh=tiles_mesh, render=True),
            dict(name="b train", kind="train", mesh={"dp": 1, **tiles_mesh})]
    with timer.stage("(b): 4 ranks", sync=dev):
        outs = _run_ranks(ranks_b, "gloo", dev, jobs, ref_dir)
    count(_rank_log(f"(b) {N}^3 tiles", outs, "b"))
    oks = [o["b"]["ok"] for o in outs]
    log(f"[phase10] (b) {N}^3 on {tiles_mesh}: each tile bitwise equal to the single-device field, both methods:"
        f" {oks}; the tile render resolved to {[o['b']['backend'] for o in outs]}")
    check(all(all(ok.values()) for ok in oks), f"(b): sharded 2-D field != single-device: {oks}")
    for backend in MESH_RENDER_BACKENDS:
        resolved = outs[0]["b"]["backend"] if backend == "auto" else backend
        text = _render_bars(outs[0]["b"]["depth"][backend], outs[0]["b"]["hit"][backend], refs[(N, backend)],
                            refs[(N, backend, "padded")], refs[(N, backend, "tiles")], dense[N], resolved,
                            f"(b) {N}^3")
        log(f"[phase10] (b) sharded 2-D render {IMAGE_HW[0]}x{IMAGE_HW[1]} over {N}^3, backend {backend!r} (halos"
            f" {refs[(N, backend, 'halos')]}), vs the single-device render: {text}")
    count(_rank_log(f"(b) train_2d {TRAIN_GRID}^3", outs, "b train"))
    want_pts, want_loss = refs[MESH_TILES]
    text = _grad_check(pts_np, outs[0]["b train"]["points"], want_pts, outs[0]["b train"]["loss"], want_loss,
                       ranks_b, "(b)")
    big = max(o["b train"]["stats"]["step"]["max_elems"] for o in outs)
    log(f"[phase10] (b) make_train_step_2d (dp=1, {tiles_mesh}) vs the single-process step: {text}; largest"
        f" collective {big} elements")
    log(f"[phase10] (b) the sharded 2-D forward vs the untiled single-device forward:"
        f" {_forward_check(outs[0]['b train'], refs[MESH_TILES, 'untiled'], dense[MESH_TILES], cfg, '(b)')}")
    check(0 < big < TRAIN_GRID**3, f"(b): a collective moved {big} elements")
    del outs

    # ---- (d): one rank over NCCL ----------------------------------------
    with timer.stage("(d): 1 rank, NCCL", sync=dev):
        outs = _run_ranks(1, NCCL, dev, [dict(name="d", kind="fields", n=N, mesh={"x": 1})], ref_dir)
    count(_rank_log(f"(d) {N}^3 NCCL", outs, "d"))
    log(f"[phase10] (d) {N}^3 on one rank over {outs[0]['backend']}: bitwise equal to the unsharded field"
        f" {outs[0]['d']['ok']}")
    check(outs[0]["backend"] == NCCL and all(outs[0]["d"]["ok"].values()), "(d): NCCL field")
    del outs
    tmp.cleanup()

    # ---- (e): SdfBuilder on config #4's 512^3 grid ------------------------
    rng = np.random.default_rng(10)
    ext = N * RES
    prims = []
    for k in range(BUILDER_PRIMS):
        c = rng.uniform(0.1 * ext, 0.9 * ext, 3)
        if k < 4:  # the first in the CPU crop too
            c = rng.uniform(0.2, 0.8, 3) * CROP * RES
        a, b_ = rng.uniform(-np.pi, np.pi, 2)
        rot = (np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]])
               @ np.array([[1, 0, 0], [0, np.cos(b_), -np.sin(b_)], [0, np.sin(b_), np.cos(b_)]]))
        if k % 3 == 0:
            prims.append(scene.Primitive.box(c, rng.uniform(0.5, 3.0, 3), rot))
        elif k % 3 == 1:
            prims.append(scene.Primitive.sphere(c, rng.uniform(0.3, 1.5)))
        else:
            prims.append(scene.Primitive.cylinder(c, rng.uniform(0.2, 1.0), rng.uniform(0.5, 3.0), rot))
    verts, faces = _torus_mesh([0.5 * CROP * RES, 0.5 * CROP * RES, 0.3 * CROP * RES], 0.3 * CROP * RES,
                               0.1 * CROP * RES)
    octo = torch.as_tensor(mask_np, device=dev).to(torch.float32)

    def builder(meta, octomap):
        b = scene.SdfBuilder(meta, oob_value=1e3)
        for p in prims:
            b.add_primitive(p)
        b.add_mesh(verts, faces)
        b.set_octomap(octomap)
        return b

    meta = GridMeta.create(eye, RES, (N, N, N), device=dev)
    with timer.stage("(e) SdfBuilder", sync=dev):
        b = builder(meta, octo)
        objects = torch.maximum(scene.primitives_to_occupancy(prims, meta), voxelize.mesh_to_occupancy(verts, faces, meta))
        want_occ = {scene.UpdateMode.USE_ONLY_OCTOMAP: octo, scene.UpdateMode.USE_ONLY_COLLISION_OBJECTS: objects,
                    scene.UpdateMode.USE_FULL_PLANNING_SCENE: torch.maximum(octo, objects)}
        rows = {}
        for mode, want in want_occ.items():
            edt_cuda.reset_launches()
            (cmap_b, sdf_b), ms = timed(lambda: (b.update_collision_map(mode), b.update_sdf(mode)), host_clock=True)
            got = {k: c for k, c in edt_cuda.LAUNCHES.items() if c}
            count(got)
            ref = edt.extract_signed_distance_field(cmap_b.occupancy > 0.5, meta, 1e3)[0]
            rows[mode.name] = (torch.equal(cmap_b.occupancy, want) and same_bits(sdf_b.values, ref.values), ms, got, int((want > 0.5).sum()))
        cached = b.update_sdf(scene.UpdateMode.USE_CACHED) is sdf_b and \
            b.update_collision_map(scene.UpdateMode.USE_CACHED) is cmap_b
        cpu_meta = GridMeta.create(torch.eye(4), RES, (CROP,) * 3, device="cpu")
        cpu_occ = builder(cpu_meta, octo[:CROP, :CROP, :CROP].cpu()).update_collision_map().occupancy
        crop_ok = torch.equal(cpu_occ, cmap_b.occupancy[:CROP, :CROP, :CROP].cpu())
    for mode, (ok, ms, got, filled) in rows.items():
        log(f"[phase10] (e) SdfBuilder {N}^3 {mode}: {filled} filled cells; occupancy as expected and the field"
            f" bitwise extract_signed_distance_field's {ok}; {ms:.1f} ms (host clock); launches {json.dumps(got)}")
    log(f"[phase10] (e) {BUILDER_PRIMS} primitives (boxes and cylinders rotated), a torus mesh of {len(faces)}"
        f" triangles, make_scene({N}) as the octomap: USE_CACHED returns the cached objects {cached}; the"
        f" occupancy on the {CROP}^3 crop equals the CPU run's {crop_ok}")
    check(all(r[0] for r in rows.values()) and cached and crop_ok, "(e) SdfBuilder")
    del b, objects, want_occ, cmap_b, sdf_b, ref, cpu_occ

    # ---- (f): the sparse map, filled from the 512^3 map --------------------
    with timer.stage("(f) sparse", sync=dev):
        m = sparse.DynamicSpatialHashedCollisionMap(np.eye(4), RES, chunk_cells=SPARSE_CHUNK)
        occ_np = mask_np.astype(np.float32)
        k = N // SPARSE_CHUNK
        blocks = occ_np.reshape(k, SPARSE_CHUNK, k, SPARSE_CHUNK, k, SPARSE_CHUNK).transpose(0, 2, 4, 1, 3, 5)
        lo, hi = blocks.min(axis=(3, 4, 5)), blocks.max(axis=(3, 4, 5))
        ii = np.stack(np.meshgrid(*([np.arange(SPARSE_CHUNK)] * 3), indexing="ij"), -1).reshape(-1, 3)
        n_uniform = n_cells = 0
        for key in np.ndindex(k, k, k):
            if lo[key] == hi[key]:
                m.set_chunk((np.asarray(key) + 0.5) * SPARSE_CHUNK * RES, float(lo[key]))
                n_uniform += 1
            else:
                centers = ((np.asarray(key) * SPARSE_CHUNK + ii) + 0.5) * RES
                m.set_cell(centers, blocks[key].reshape(-1))
                n_cells += len(centers)
        dense, ms_dense = timed(lambda: m.densify(device=dev), host_clock=True)
        sparse_ok = (dense.meta.shape == (N,) * 3 and torch.equal(dense.occupancy, octo)
                     and torch.equal(dense.meta.origin_transform, eye))
    log(f"[phase10] (f) sparse map, chunk {SPARSE_CHUNK}: {n_uniform} uniform chunks (set_chunk), {k**3 - n_uniform}"
        f" cell-wise ({n_cells} cells by set_cell); densify() onto the card {ms_dense:.1f} ms (host clock), equal to"
        f" the {N}^3 map {sparse_ok}; fill {timer.stages['(f) sparse'] - ms_dense / 1e3:.1f} s on the host")
    check(sparse_ok, "(f) sparse densify != the map")
    del m, dense, blocks, occ_np

    # ---- (g): viz on phase 9's outputs ------------------------------------
    sdf9, cmap9, tseg9 = outs9["sdf"], outs9["cmap"], outs9["tseg"]
    displays = {
        "sdf_display": (viz.sdf_display, sdf9),
        "collision_map_display": (viz.collision_map_display, cmap9),
        "components_display": (viz.components_display, cmap9),
        "convex_segments_display": (viz.convex_segments_display, tseg9),
    }
    with timer.stage("(g) viz", sync=dev):
        viz_rows = {}
        for name, (fn, grid) in displays.items():
            (pts_, cols), ms = timed(lambda: fn(grid), host_clock=True)
            crop = _crop(grid, (grid.meta.shape[0] - CROP) // 2)  # the middle CROP^3 cells
            card = fn(crop)
            host = fn(_to_cpu(crop))
            same = all(a.dtype == b.dtype and np.array_equal(a.view(np.uint32), b.view(np.uint32))
                       for a, b in zip(card, host))
            viz_rows[name] = (len(pts_), ms, len(card[0]), same)
            del pts_, cols, card, host
    for name, (n_pts, ms, n_crop, same) in viz_rows.items():
        log(f"[phase10] (g) {name}: {n_pts} points at full size in {ms:.1f} ms (host clock, the copy to numpy"
            f" included); on the middle {CROP}^3 crop ({n_crop} points) card == CPU bitwise {same}")
    check(all(r[3] and r[2] > 0 for r in viz_rows.values()), f"(g) viz: card != CPU or an empty crop: {viz_rows}")

    log(f"[timing] phase 10 stages (profiling.StageTimer, s), card: {smi}: {timer.report()}")
    log(f"[phase10] phase time {time.perf_counter() - t_phase:.1f} s; launches of its main-path runs"
        f" {json.dumps(launches)}")
    return launches


def _crop(grid, start: int):
    """A grid (SDF or map) cut to the CROP^3 cells from (start, start,
    start), its origin moved there."""
    import dataclasses

    import torch
    from sdf_tools_tpu_torch import GridMeta

    sl = (slice(start, start + CROP),) * 3
    origin = grid.meta.origin_transform.clone()
    origin[:3, 3] += torch.tensor([start * RES] * 3, dtype=torch.float32, device=origin.device)
    fields = {f.name: getattr(grid, f.name) for f in dataclasses.fields(grid)}
    for name, t in fields.items():
        if isinstance(t, torch.Tensor) and t.dim() == 3:
            fields[name] = t[sl].contiguous()
    fields["meta"] = GridMeta.create(origin, grid.meta.resolution_float, (CROP,) * 3, device=origin.device)
    return type(grid)(**fields)


def _to_cpu(grid):
    """The same grid with every tensor (the meta's too) on the CPU."""
    import dataclasses

    import torch

    fields = {f.name: getattr(grid, f.name) for f in dataclasses.fields(grid)}
    for name, t in fields.items():
        if isinstance(t, torch.Tensor):
            fields[name] = t.cpu()
    fields["meta"] = grid.meta.to("cpu")
    return type(grid)(**fields)


# ---- phase 11: the entry points outside the package --------------------------

CARVE_IOU_TOL = 0.05  # the card's final IoU against the CPU run's (FT ties may route differently)
MESH_CENTER_WANT, MESH_CENTER_TOL = -0.5, 0.05  # the icosphere's radius
CARVE_CPU_THREADS = 4  # the carve's CPU run shares the host with this process
CARVE_CPU_TIMEOUT_S = 600


def _carve_cpu_run():
    """The carve example's CPU run, a process of its own started now (it
    takes about half a minute on the host while the card works): a
    ``subprocess.Popen`` whose last line of output is its JSON summary."""
    import os

    prog = (f"import json, torch; torch.set_num_threads({CARVE_CPU_THREADS}); "
            "from sdf_tools_tpu_torch.examples import carve_occupancy as c; r = c.main('cpu'); "
            "print(json.dumps({k: r[k] for k in ('start_iou', 'final_iou', 'final_loss')}))")
    return subprocess.Popen([sys.executable, "-c", prog], cwd=Path(__file__).resolve().parent, env=dict(os.environ),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def entry_points_phase(dev, engine, mask_np: np.ndarray, smi: str) -> dict:
    """Phase 11 (module docstring): config #4's pixel gradients against
    finite differences on phase 4's field, the four examples and the image
    CLI on the card. Returns the launches of its card runs."""
    import tempfile

    import torch
    from sdf_tools_tpu_torch.examples import carve_occupancy, mesh_scene_demo, pointcloud_demo, tutorial
    from sdf_tools_tpu_torch.ops import edt_cuda, render
    from sdf_tools_tpu_torch.scripts import image_sdf_cli, validate_baseline as vb

    t_phase = time.perf_counter()
    carve_cpu = _carve_cpu_run()
    try:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        stage_s = {}
        edt_cuda.reset_launches()

        # ---- (a) config #4's pixel gradients on phase 4's field and rays ----
        t0 = time.perf_counter()
        sdf = engine.sdf_from_occupancy(torch.as_tensor(mask_np, device=dev))
        saved = sdf.values.clone()
        camera = vb.bench_camera(N, RES, IMAGE_HW[0])
        kw = vb.render_kw(N, RES)
        check(kw["max_steps"] == MAX_STEPS and kw["t_max"] == engine.render_t_max, "phase 11 render settings")
        o, v = render.camera_rays(**camera, device=dev)
        backend = render._resolve_backend("auto", sdf.meta.shape, o)
        check(backend == "plane", f"phase 11: the 1024^2 image resolved to {backend!r}")
        image = render.render_depth(sdf, o, v, **kw)
        fd = vb.fd_probes(sdf, o, v, image, kw, backend)
        stage_s["fd probes"] = time.perf_counter() - t0
        check(same_bits(sdf.values, saved), "phase 11: the FD probes left the field changed")
        del saved
        log(f"[phase11] (a) FD probes ({backend} for the image and each probe's tile): {fd['agree']}/{fd['n']}"
            f" within {vb.FD_RATIO_MAX}x (bar {vb.FD_PASS_MIN}), ratios {json.dumps(fd['ratios'])}; the tile's depth"
            f" equal to the image's on {fd['image_depth_equal']}/{fd['n']}; probes {json.dumps(fd['probes'])}")
        check(fd["image_depth_equal"] == fd["n"],
              f"config #4 FD probes: the tile's depth is the image's on {fd['image_depth_equal']}/{fd['n']}")
        check(fd["ok"], f"config #4 FD probes: {fd['agree']}/{fd['n']} within {vb.FD_RATIO_MAX}x")
        del sdf, image, o, v

        with tempfile.TemporaryDirectory() as tmp:
            # ---- (b) the examples, the card against the port's CPU run ------
            t0 = time.perf_counter()
            got, cpu = tutorial.main(dev), tutorial.main("cpu")
            check(got["n_components"] == cpu["n_components"] and same_bits(got["index"], cpu["index"]),
                  "tutorial: components or index, card vs CPU")
            check(same_bits(got["sdf"].values, cpu["sdf"].values) and same_bits(got["cmap"].component,
                  cpu["cmap"].component), "tutorial: field or labels, card vs CPU")
            ulps_t = max(max_ulps(torch.as_tensor(got[k]), torch.as_tensor(cpu[k])) for k in ("gradients", "distance"))
            check(ulps_t <= CPU_MAX_ULPS and same_bits(got["centers"], cpu["centers"])
                  and same_bits(got["colors"], cpu["colors"]), "tutorial: queries or display, card vs CPU")
            stage_s["tutorial"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            got, cpu = (pointcloud_demo.main(d, ply_path=f"{tmp}/cloud_{d}.ply") for d in (dev, "cpu"))
            ulps_p = max_ulps(got["gradient"], cpu["gradient"])
            check(got["occupied"] == cpu["occupied"] and same_bits(got["sdf"].values, cpu["sdf"].values)
                  and ulps_p <= CPU_MAX_ULPS, "point cloud: occupancy, field or gradient, card vs CPU")
            check(Path(f"{tmp}/cloud_{dev}.ply").read_bytes() == Path(f"{tmp}/cloud_cpu.ply").read_bytes(),
                  "point cloud: PLY, card vs CPU")
            stage_s["point cloud"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            mesh = mesh_scene_demo.main(dev, ply_path=f"{tmp}/mesh.ply")
            check(abs(mesh["sdf_at_center"] - MESH_CENTER_WANT) <= MESH_CENTER_TOL,
                  f"mesh scene: field {mesh['sdf_at_center']} at the icosphere's centre")
            stage_s["mesh scene"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            carve = carve_occupancy.main(dev)
            stage_s["carve (card)"] = time.perf_counter() - t0

            # ---- (c) the image CLI on config #1's 256^2 image ---------------
            t0 = time.perf_counter()
            np.save(f"{tmp}/img.npy", baseline_image())
            outs = {}
            for d in ("card", "cpu"):
                image_sdf_cli.main([f"{tmp}/img.npy", f"{tmp}/{d}", "--device", str(dev) if d == "card" else d])
                outs[d] = {p.name[len(d):]: p.read_bytes() for p in Path(tmp).glob(f"{d}_*")}
            check(len(outs["card"]) == 3 and outs["card"] == outs["cpu"],
                  f"image CLI: files of the card {sorted(outs['card'])} != the CPU's {sorted(outs['cpu'])}")
            stage_s["image CLI"] = time.perf_counter() - t0
        torch.cuda.synchronize()
        launched = dict(edt_cuda.LAUNCHES)

        t0 = time.perf_counter()
        out, err = carve_cpu.communicate(timeout=CARVE_CPU_TIMEOUT_S)
        stage_s["carve (CPU, waited for)"] = time.perf_counter() - t0
        check(carve_cpu.returncode == 0, f"carve CPU run: exit {carve_cpu.returncode}\n{err[-2000:]}")
    finally:
        if carve_cpu.poll() is None:
            carve_cpu.kill()
            carve_cpu.wait()
    ref = json.loads(out.strip().splitlines()[-1])
    log(f"[phase11] (b) tutorial, point cloud: card equal to CPU (fields and labels bitwise, queries within"
        f" {max(ulps_t, ulps_p)} ulp); mesh scene: field {mesh['sdf_at_center']:.6f} at the icosphere's centre;"
        f" carve (ft, 60 steps, lr {carve_occupancy.LR:g}): IoU {carve['start_iou']:.6f} -> {carve['final_iou']:.6f},"
        f" loss {carve['losses'][0]:.6f} -> {carve['final_loss']:.6f}; CPU run IoU {ref['start_iou']:.6f} ->"
        f" {ref['final_iou']:.6f}, loss {ref['final_loss']:.6f}")
    check(carve["final_iou"] > carve["start_iou"], "carve: the IoU did not rise on the card")
    check(abs(carve["final_iou"] - ref["final_iou"]) <= CARVE_IOU_TOL, "carve: final IoU, card vs CPU")
    log(f"[phase11] (c) image CLI 256^2: {sorted(outs['card'])} byte-equal to the CPU run's")
    log(f"[timing] phase 11 stages (host clock, s), card: {smi}: " + ", ".join(
        f"{k} {t:.3f}" for k, t in stage_s.items()))
    log(f"[phase11] phase time {time.perf_counter() - t_phase:.1f} s; launches {json.dumps(launched)}")
    return launched


# ---- phase 12: the system's measurement programs ---------------------------

FT_BACKEND_N = 256
FT_BACKENDS = ("reference", "stencil")  # the FT's other routes: the bucket queue's forward, and "stencil"'s
PROGRAM_KERNELS = ("line_pass", "envelope", "plane_sweep", "envelope_carry", "winner_segment_sum")


def measurement_programs_phase(dev, smi: str, config5: dict) -> dict:
    """Phase 12 (module docstring): the port's FT-backward and config #5
    programs, and the FT's other backends on the card. Returns the
    launches of its runs."""
    import torch
    from sdf_tools_tpu_torch import sdf_from_occupancy_ft
    from sdf_tools_tpu_torch.ops import edt, edt_cuda
    from sdf_tools_tpu_torch.scripts import bench_1024, bench_ft_bwd, bench_render_1024

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    stage_s = {}

    edt_cuda.reset_launches()
    # ---- (a) module 4, the FT backward's parts at 512^3 ----------------------
    t0 = time.perf_counter()
    ft = bench_ft_bwd.run(N, "auto", dev)
    stage_s["bench_ft_bwd"] = time.perf_counter() - t0
    # ---- (b) modules 2 and 3, config #5's field and render at 1024^3 --------
    t0 = time.perf_counter()
    f1024 = bench_1024.run(N5, N5_SLABS, dev)
    stage_s["bench_1024"] = time.perf_counter() - t0
    check((f1024["min"], f1024["max"]) == config5["minmax"],
          f"bench_1024: min/max {f1024['min']}/{f1024['max']}, phase 7's {config5['minmax']}")
    t0 = time.perf_counter()
    r1024 = bench_render_1024.run(N5, *IMAGE_HW, dev)
    stage_s["bench_render_1024"] = time.perf_counter() - t0
    check(r1024["render_backend"] == "plane" and r1024["mean_depth"] == config5["mean_depth"],
          f"bench_render_1024: {r1024['render_backend']} mean depth {r1024['mean_depth']!r}, phase 7's"
          f" {config5['mean_depth']!r}")
    # ---- (c) the FT's other backends at 256^3 --------------------------------
    t0 = time.perf_counter()
    mask = device_scene(FT_BACKEND_N, dev)[0]
    occ = mask.float() * 0.9 + 0.05

    def ft_vjp(backend, cot):
        o = occ.clone().requires_grad_(True)
        values = sdf_from_occupancy_ft(o, RES, backend)
        return values.detach(), torch.autograd.grad(values, o, cot)[0]

    # one cotangent for every backend: sum(sdf^2)'s at the exact field
    ft_out = {"auto": ft_field_grad(occ, RES)}
    cot = 2.0 * ft_out["auto"][0]
    ft_out.update({b: ft_vjp(b, cot) for b in FT_BACKENDS})
    torch.cuda.synchronize()
    stage_s["FT backends"] = time.perf_counter() - t0
    launched = dict(edt_cuda.LAUNCHES)
    for name in PROGRAM_KERNELS:
        check(launched.get(name, 0) >= 1, f"kernel {name} was not launched in phase 12")

    _, d_auto = ft_out["auto"]
    for b in FT_BACKENDS:
        values, d_occ = ft_out[b]
        want = edt.signed_field_from_masks(mask, RES, b)[0]
        check(same_bits(values, want), f"FT {b}: forward != signed_field_from_masks(..., {b!r})")
        check(same_bits(d_occ, d_auto), f"FT {b}: gradient != the 'auto' gradient")
    ref_over = int((ft_out["reference"][0] != ft_out["auto"][0]).sum())
    log(f"[phase12] (c) FT {FT_BACKEND_N}^3 'reference' and 'stencil': forward bitwise signed_field_from_masks of the"
        f" backend ('reference' differs from the exact field on {ref_over} cells); the gradient of each for the"
        f" cotangent 2 sdf_auto bitwise the 'auto' gradient")
    log(f"[phase12] (a) bench_ft_bwd {N}^3: {json.dumps(ft)}")
    log(f"[phase12] (b) bench_1024: {json.dumps(f1024)}")
    log(f"[phase12] (b) bench_render_1024: {json.dumps(r1024)}; min/max and mean depth equal phase 7's")
    log(f"[timing] phase 12 stages (host clock, s), card: {smi}: " + ", ".join(
        f"{k} {t:.3f}" for k, t in stage_s.items()))
    log(f"[phase12] phase time {time.perf_counter() - t_phase:.1f} s; launches {json.dumps(launched)}")
    return launched


# ---- phases 13 and 14: the design probes ----------------------------------------

PROBE_PLAIN_RUNS = 3  # timed runs of each probe's plain version at B = 1, after a first
PROBE_PHASE_LIMIT_S = 300  # a probe phase's time limit (phase 14 takes about a minute): past it the run ends, failed
RENDER_PAIRS = (("R2-mxu", "R2-full"), ("R3-unroll8", "R3-dyn2d"), ("R6-dma_ovl", "R6-dma"))
RENDER_CHECKED = ("S1", "S2", "D1")  # the probes whose JAX scripts check their output against numpy
# the device times (B = 1 us, B_fill ms) of the one-block-an-instance designs that were replaced, on an
# NVIDIA H100 80GB HBM3 at 700 W (PERF.md's probe table): the five kernels' of phase 13,
# micro_band_sum's, micro_sampler's and R6's copies' in phase 14 (R5, R6 at their higher iteration count)
ONE_BLOCK_TIMES = {
    "E1": (2.93, 0.0054), "E1b": (32.08, 0.3569), "E2": (2.99, 0.0053), "E3": (3.05, 0.0058),
    "E4": (44.41, 0.8084), "E4b": (44.44, 0.8046), "E5": (190.84, 2.7134), "E6": (44.52, 0.8040),
    "G1": (92.76, 1.4515), "G2": (16.89, 1.0121), "G3": (22.42, 0.0814), "G4": (225.32, 0.5457),
    "G5": (622.84, 0.7333), "G6": (24.92, 0.1258), "G7": (44.54, 0.8047), "G8": (11.80, 0.0407),
    "H1": (12.67, 0.0432),
    "H2": (84.56, 0.3274), "H3": (2881.44, 51.8858), "H4": (43.61, 0.1637), "H5": (23.12, 0.0834),
    "H6": (10.48, 0.0110), "H7": (84.49, 0.3275), "H8": (960.11, 3.8300),
    "R1": (16580, 43.55), "R2-load": (17970, 46.26), "R2-loadtaa": (10930, 30.88), "R2-full": (8330, 21.86),
    "R2-static": (6260, 16.32), "R2-mxu": (225030, 891.15), "R3-scalars": (6990, 12.51),
    "R3-static": (18000, 46.47), "R3-smalldyn": (11120, 25.84), "R3-dyn2d": (17980, 46.41),
    "R3-dynrow": (22700, 59.72), "R3-dyncol": (17990, 46.29), "R3-dynrot": (31970, 84.77),
    "R3-unroll8": (17980, 46.27), "R4-tab_load": (2680, 7.23), "R4-tab_full": (6660, 17.38),
    "R5-fori": (8570, 11.72), "R5-smem": (10290, 15.71), "R5-load_s": (42630, 114.86),
    "R5-load_d0": (149840, 192.72), "R5-load_dsub": (149770, 192.50), "R5-load_d2d": (86010, 128.75),
    "R5-sample": (13470, 33.17), "R6-smem_rw": (291, 0.298), "R6-dma": (45500, 254.06),
    "R6-dma_ovl": (55870, 272.38), "R6-sample9": (47570, 269.26),
}


def int32_extremes(shape, seed: int) -> np.ndarray:
    """int32 values from a seed over the whole range, a third of them small
    (near a row scan's outputs), with runs of INT32_MIN and INT32_MAX along
    the last axis."""
    rng = np.random.default_rng(seed)
    lo, hi = np.iinfo(np.int32).min, np.iinfo(np.int32).max
    x = rng.integers(lo, hi, shape, dtype=np.int64, endpoint=True)
    small = rng.random(shape) < 1 / 3
    x[small] = rng.integers(-3, 2 * shape[-2] + 3, int(small.sum()))
    flat = x.reshape(-1, shape[-1])
    flat[::5, : shape[-1] // 2] = lo
    flat[2::7, shape[-1] // 3:] = hi
    return x.astype(np.int32)


def extreme_probes():
    """The row scan and G8's chain on uneven shapes whose x reaches INT32_MIN
    and INT32_MAX (``int32_extremes``): the card's check of the kernels'
    tails (columns no multiple of 8, rows no multiple of a run, lanes no
    multiple of a warp) and of the wrapping doubling."""
    from sdf_tools_tpu_torch.scripts import _micro

    return (_micro.row_scan("X-scan", "row scan [3,1000,13] axis 1, int32 extremes", "-",
                            lambda: (int32_extremes((3, 1000, 13), 9),), axis=1),
            _micro.ops("X-ops", "G8 chain (3,40), int32 extremes", "-", lambda: (int32_extremes((3, 40), 10),),
                       steps=512))


PROBE_KEYS = ("ms", "launch_ms", "fill_ms", "plain_ms", "library_ms", "bound_ms", "fill_bound_ms", "bound_by", "bytes",
              "us_per_step", "ns_per_element_step", "unit", "steps", "launches", "max_abs_err", "memory", "replaces",
              "lo_ms", "lo_fill_ms", "slope_ns", "fill_slope_ns", "copy_GBps", "fill_copy_GBps")


def probe_phase(dev, smi: str, phase: int, title: str, modules, kernel_names, source: str, pairs=(), checked=(),
                extremes=()):
    """Phase 13 or 14 (module docstring), under a time limit of
    PROBE_PHASE_LIMIT_S: the probe programs' ``main`` on the card
    (launches reset before, read after; every probe must have launched,
    the ``checked`` probes' own checks must hold), then each probe's kernel
    bitwise its plain version at B = 1 and B_fill (a probe with a launch
    geometry also either side of its first switch), each of ``pairs`` equal,
    and at B = 1 the plain version of the JAX probe's inputs on the CPU;
    the ``extremes`` probes (outside the programs) bitwise at the same
    batches;
    the plain version's time (the median of PROBE_PLAIN_RUNS warm calls)
    and the library call's. Returns (the main path's launches per probe,
    the entries of ``kernel_names`` for the kernels line)."""
    import faulthandler

    import torch
    from sdf_tools_tpu_torch import _build
    from sdf_tools_tpu_torch.scripts import _micro, _timing

    torch.backends.cuda.matmul.allow_tf32 = False  # R2 mxu's plain version is a float32 product
    faulthandler.dump_traceback_later(PROBE_PHASE_LIMIT_S, exit=True)
    try:
        t_phase = time.perf_counter()
        _build.reset_launches()
        runs = [m.main(["--device", str(dev)]) for m in modules]
        torch.cuda.synchronize()
        launched = {k: c for k, c in _build.LAUNCHES.items() if c}
        t_main = time.perf_counter() - t_phase
        probes = [p for m in modules for p in m.PROBES]
        recs = {key: rec for run in runs for key, rec in run["probes"].items()}
        b_fill = runs[0]["b_fill"]
        sms = _micro.sm_count(dev)
        switches = {}
        for p in probes:
            switch = _micro.switch_batch(p, sms)
            switches[p.key] = [] if switch is None else sorted({switch - 1, switch} - {1, b_fill})
        for p in probes:
            check(launched.get(f"probe_{p.key}", 0) >= 1, f"probe {p.key} was not launched in phase {phase}")
        for key in checked:
            check(recs[key]["ok"], f"probe {key}: the JAX script's check against numpy failed on the card")

        outs = {}
        for p in probes:
            rec = recs[p.key]
            rec["launches"] = launched.get(f"probe_{p.key}", 0)
            rec["max_abs_err"] = 0.0
            for batch in (1, b_fill, *switches[p.key]):
                args = p.inputs(batch, dev)
                got, want = p(*args), p.plain(*args)
                check(got.shape == want.shape == (batch, *p.out_shape) and got.dtype == want.dtype,
                      f"probe {p.key} B={batch}: {tuple(got.shape)}/{got.dtype} vs {tuple(want.shape)}/{want.dtype}")
                if not torch.equal(got, want):
                    rec["max_abs_err"] = max(rec["max_abs_err"], float((got.double() - want.double()).abs().max()))
                check(torch.equal(got, want), f"probe {p.key} B={batch}: kernel != plain (max |err| {rec['max_abs_err']})")
                check(bool(torch.isfinite(got).all()), f"probe {p.key} B={batch}: not finite")
                if any(p.key in pair for pair in pairs):
                    outs[p.key, batch] = got
                if batch == 1:
                    cpu = p.plain(*p.inputs(1, "cpu"))
                    check(torch.equal(got.cpu(), cpu), f"probe {p.key}: B=1 on the card != the JAX probe's inputs'"
                          " plain version on the CPU")
                    rec["plain_ms"] = float(np.median([cuda_ms(lambda: p.plain(*args))
                                                       for _ in range(PROBE_PLAIN_RUNS)]))
                    rec["library_ms"] = None
                    if p.library is not None:
                        lib_args = p.library_args(args)
                        check(torch.equal(p.library(*lib_args), want), f"probe {p.key}: the library call != plain")
                        rec["library_ms"] = _timing.device_ms(lambda: p.library(*lib_args), dev)
                        del lib_args
                del args, got, want
            torch.cuda.empty_cache()
        for a, b in pairs:
            for batch in (1, b_fill):
                check(torch.equal(outs[a, batch], outs[b, batch]), f"probes {a} and {b} differ at B={batch}")
        del outs
        for p in extremes:
            switch = _micro.switch_batch(p, sms)
            batches = sorted({1, b_fill, *(() if switch is None else (switch - 1, switch))})
            for batch in batches:
                args = p.inputs(batch, dev)
                check(torch.equal(p(*args), p.plain(*args)), f"probe {p.key} B={batch}: kernel != plain")
            log(f"[phase{phase}] {p.key} ({p.kernel}; {p.label}): kernel == plain bitwise at"
                f" {', '.join(f'B={b}' for b in batches)} (geometry at B=1 {tuple(p.geometry(1, sms))})")
            del args
        torch.cuda.empty_cache()
    finally:
        faulthandler.cancel_dump_traceback_later()

    log(f"[timing] phase {phase}, {title}, card: {smi}; B_fill {b_fill}; empty kernel {_micro.us(runs[0]['empty_ms'])}"
        f" on the device (calls queued behind a sleeping kernel), {_micro.us(runs[0]['empty_launch_ms'])} launched"
        " back to back (the host's launch path)")
    for p in probes:
        r = recs[p.key]
        library = "none" if r["library_ms"] is None else f"{r['library_ms'] * 1e3:.2f} us"
        extra = ""
        if "slope_ns" in r:
            extra += (f"; slope {r['slope_ns']:.3f} ns an iteration at B=1 ({p.lo.steps} -> {p.steps}),"
                      f" {r['fill_slope_ns']:.5f} ns an instance-iteration at B={b_fill}")
        if "copy_GBps" in r:
            extra += f"; copy rate {r['copy_GBps']:.2f} GB/s at B=1, {r['fill_copy_GBps']:.1f} GB/s at B={b_fill}"
        if p.key in ONE_BLOCK_TIMES:
            old_us, old_fill = ONE_BLOCK_TIMES[p.key]
            extra += f"; one-block design {old_us:.2f} us at B=1, {old_fill:.4f} ms at B_fill"
        batches = ", ".join(f"B={b}" for b in (1, *switches[p.key], b_fill))
        log(f"[phase{phase}] {p.key} ({p.kernel}; reads {p.memory}): kernel == plain bitwise at {batches},"
            f" B=1 == the JAX probe's inputs on the CPU; kernel {r['ms'] * 1e3:.2f} us on the device at B=1 ({p.steps}"
            f" {p.unit}s; launched back to back {_micro.us(r['launch_ms'])}), {r['fill_ms']:.4f} ms at B={b_fill}"
            f" ({r['ns_per_element_step']:.5f} ns an instance-{p.unit}); plain {r['plain_ms']:.3f} ms; library"
            f" {library}; bound {r['bound_ms'] * 1e3:.6g} us at B=1 by {r['bound_by']} ({r['bytes']} B),"
            f" {r['fill_bound_ms']:.6g} ms at B={b_fill}; launches {r['launches']}{extra}")

    kernels = []
    for name in kernel_names:
        ps = [p for p in probes if p.kernel == name]
        by = {kind: sum(recs[p.key]["bound_ms"] for p in ps if recs[p.key]["bound_by"] == kind)
              for kind in ("bytes", "operations")}
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": "; ".join(dict.fromkeys(p.replaces for p in ps)),
            "launches": sum(recs[p.key]["launches"] for p in ps),
            "max_abs_err": max(recs[p.key]["max_abs_err"] for p in ps),
            # one launch of each of its probes at B = 1 (the TPU probes' calls) on the device alone, summed
            "ms": sum(recs[p.key]["ms"] for p in ps),
            "plain_ms": sum(recs[p.key]["plain_ms"] for p in ps),
            "bound_ms": by["bytes"] + by["operations"],
            "bound_by": "bytes" if by["bytes"] >= by["operations"] else "operations",
            # its probes compute different functions, not each with a library call: per probe below
            "library_ms": None,
            "b_fill": b_fill,
            "probes": [{"name": p.key, **{k: recs[p.key][k] for k in PROBE_KEYS if k in recs[p.key]}} for p in ps],
        })
    log(f"[phase{phase}] phase time {time.perf_counter() - t_phase:.1f} s (the {len(modules)} mains {t_main:.1f} s);"
        f" launches {json.dumps(launched)}")
    return launched, kernels


# ---- phase 15: the signed field in float64, bfloat16 and float16 --------------

FIELD_DTYPES = ("float64", "bfloat16", "float16")
FIELD_ROUTES = ("signed_field_from_masks", "signed_field_virtual_border")
FIELD_RUNS = 3  # timed runs of each route after the counted run
# |field - float64 field| <= 4 u |float64 field| on the finite cells, u the
# dtype's unit roundoff: half a rounding of d^2 through the root, then the
# root's, the resolution's and the product's roundings (3.5 u); float32 is
# the fused field (d^2 exact, 3 u)
FIELD_REL_TOL = {"float32": 4 * 2.0**-24, "bfloat16": 4 * 2.0**-8, "float16": 4 * 2.0**-11}
FLOAT16_INF_D2 = 65520  # the least integer that rounds to float16's inf


def same_float_bits(a, b) -> bool:
    """``same_bits`` for a float tensor of any width: one shape and dtype,
    the bit patterns equal (compared on the host)."""
    import torch

    a, b = (torch.as_tensor(x).detach().cpu().contiguous() for x in (a, b))
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    as_int = {8: torch.int64, 4: torch.int32, 2: torch.int16}[a.element_size()]
    return bool(torch.equal(a.view(as_int), b.view(as_int)))


def field_dtypes_phase(dev, mask_np: np.ndarray, smi: str) -> dict:
    """Phase 15 (module docstring): the signed field and the virtual-border
    field of ``make_scene(N)`` in each of FIELD_DTYPES, from the tensor and
    from the numpy mask with ``device=``. Returns the launches of the
    counted run."""
    import torch

    from sdf_tools_tpu_torch import _build
    from sdf_tools_tpu_torch.ops import edt

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    mask = torch.as_tensor(mask_np, device=dev)
    dtypes = {name: getattr(torch, name) for name in FIELD_DTYPES}

    # the counted run: each route in each dtype, from the tensor and from the numpy mask
    torch.cuda.synchronize()
    _build.reset_launches()
    outs = {}
    for name, dt in dtypes.items():
        for route in FIELD_ROUTES:
            fn = getattr(edt, route)
            outs[name, route] = fn(mask, RES, "auto", dt)
            outs[name, route, "numpy"] = fn(mask_np, RES, "auto", dt, device=dev)
    torch.cuda.synchronize()
    launched = {k: c for k, c in _build.LAUNCHES.items() if c}
    # a field is one K1 and two K2; the virtual border two fields; each route twice
    calls = 2 * (1 + 2) * len(dtypes)
    want = {"line_pass_dual": calls, "envelope_dual": 2 * calls}
    log(f"[phase15] {N}^3 routes {list(FIELD_ROUTES)} in {list(FIELD_DTYPES)}, tensor and numpy masks: LAUNCHES"
        f" {json.dumps(launched)}")
    check(launched == want, f"phase 15: launches {launched}, want exactly {want} (K1 and K2, no K3)")

    # numpy mask with device= against the tensor call
    for name in dtypes:
        for route in FIELD_ROUTES:
            got, ref = outs.pop((name, route, "numpy")), outs[name, route]
            check(all(same_float_bits(g, r) for g, r in zip(got, ref)),
                  f"phase 15: {route} {name} from the numpy mask != from the tensor")
            check(got[0].device == mask.device, f"phase 15: {route} {name} from the numpy mask left the card")
            del got

    # the plain path on the host, on the card's own d^2
    free_variant, filled_variant, inner = edt._virtual_border_masks(mask)
    d2_host = {key: tuple(f.cpu() for f in edt.squared_edt_both(m))
               for key, m in (("mask", mask), ("free", free_variant), ("filled", filled_variant))}
    del free_variant, filled_variant
    for name, dt in dtypes.items():
        plain = edt.signed_from_d2(*d2_host["mask"], RES, dt)
        want_f = (plain, plain.max(), plain.min())
        free = edt.signed_from_d2(*d2_host["free"], RES, dt)
        filled = edt.signed_from_d2(*d2_host["filled"], RES, dt)
        want_b = (edt.virtual_border_combine(free, filled, inner), free.max(), filled.min())
        del plain, free, filled
        for route, want_r in zip(FIELD_ROUTES, (want_f, want_b)):
            check(all(same_float_bits(g, w) for g, w in zip(outs[name, route], want_r)),
                  f"phase 15: {route} {name} on the card != the plain path on the card's d^2 on the host")
        del want_f, want_b
    del d2_host
    log(f"[phase15] every field and extremum bitwise equal to the plain path on the card's d^2 on the host, in its"
        f" dtype; the numpy masks' (device={str(dev)!r}) bitwise equal to the tensors'")

    # signs, and each dtype against float64 (float32: the fused field)
    field, field_b = outs["float64", FIELD_ROUTES[0]][0], outs["float64", FIELD_ROUTES[1]][0]
    fused = edt.signed_field_from_masks(mask, RES)[0]
    rel = {}
    for name, got, ref in [("float32", fused, field)] + [
            (f"{name} {route}", outs[name, route][0], outs["float64", route][0])
            for name in FIELD_DTYPES[1:] for route in FIELD_ROUTES]:
        dname = name.split()[0]
        check(bool(((got > 0) == ~mask).all()), f"phase 15: {name}: a free cell not positive or a filled cell"
              f" not negative")
        fin = torch.isfinite(got)
        err = float(((got[fin].double() - ref[fin]).abs() / ref[fin].abs()).max())
        rel[name] = err
        check(err <= FIELD_REL_TOL[dname], f"phase 15: {name}: relative error {err:.3e} against float64")
        if dname == "float16":
            # infinite exactly where d^2 rounds past float16's range (d^2 >= 65520)
            big = (ref / RES).square() > FLOAT16_INF_D2 - 0.5
            check(bool(torch.equal(~fin, big)), f"phase 15: {name}: inf cells not where d^2 passes float16's range")
    check(bool(torch.isfinite(field).all()) and bool(torch.isfinite(field_b).all()), "phase 15: float64 not finite")
    log(f"[phase15] free cells positive and filled cells negative in every dtype; largest relative error against the"
        f" float64 field: " + ", ".join(f"{k} {v:.3e}" for k, v in rel.items()) + f"; float16 inf cells"
        f" {int((~torch.isfinite(outs['float16', FIELD_ROUTES[0]][0])).sum())}")
    del field, field_b, fused, outs

    # timings and peak memory of each route (float32: the fused route)
    times, peaks = {}, {}
    for name in ("float32",) + FIELD_DTYPES:
        dt = getattr(torch, name)
        for route in FIELD_ROUTES:
            fn = getattr(edt, route)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ts = [cuda_ms(lambda: fn(mask, RES, "auto", dt)) for _ in range(FIELD_RUNS)]
            peaks[name, route] = torch.cuda.max_memory_allocated() - held
            times[name, route] = ts
            log(f"[timing] phase 15 {route} {name} {N}^3: {spread(ts)}, peak {peaks[name, route] / 2**30:.3f} GiB"
                f" above the {held / 2**30:.3f} GiB held")
    log(f"[timing] phase 15 card: {smi}; medians (ms) " + ", ".join(
        f"{route.split('_')[-1]} {name} {np.median(ts):.3f}" for (name, route), ts in times.items()))
    log(f"[phase15] phase time {time.perf_counter() - t_phase:.1f} s")
    return launched


def march_phase(dev, smi: str, mask) -> dict:
    """Phase 16: the exact march's kernel (``csrc/render_march.cu``) against
    its plain version ``render._march`` on the card, bitwise in depth, hit
    and steps, on the field of ``mask`` [n, n, n]: bench.py's 1024^2 bundle
    (the training step's) with the coarse skip on and off, random subsets of
    it at the tail resume march's counts (coarse off) and the fallback's
    (coarse on; also with a min step), the bundle over a rotated and shifted
    grid, degenerate rays (non-finite, axis-aligned, starting inside), and
    the plane sweep of the render cell's four views with the kernel against
    the same render with ``_march`` in its place (the tail's and the
    fallback's real rays); the IFT backward's gradients through the kernel's
    forward against those through ``_march``'s (deterministic
    ``index_add_``), bitwise; one launch a ``_trace_depth`` call. Then CUDA
    events: kernel against plain at the bundle and at the fallback's count,
    against the bytes bound; and ``tools/march_first_call.py`` in a fresh
    process, its first call at most ``MARCH_FIRST_CALL_MAX_MS`` over a warm
    one. Returns the numbers for the kernels line."""
    import torch

    from sdf_tools_tpu_torch import _build, profiling
    from sdf_tools_tpu_torch.grid import GridMeta, SdfGrid, make_origin_transform, rotate_points
    from sdf_tools_tpu_torch.ops import edt, render, render_plane

    t_phase = time.perf_counter()
    n = mask.shape[0]
    values = edt.signed_field_from_masks(mask, RES, "auto")[0]
    eye = torch.eye(4, device=dev)
    sdf = SdfGrid.create(values, GridMeta.create(eye, RES, mask.shape, device=dev), 1e3)
    kw = dict(t_max=4 * n * RES, eps=RENDER_EPS, max_steps=MAX_STEPS)
    o, v = _bench_rays(n, dev)
    rays = o.numel() // 3
    launches0 = _build.LAUNCHES["march"]
    calls = 0

    def both(sdf_, o_, v_, where, min_step=None, coarse=True):
        nonlocal calls
        got = render._trace_depth(sdf_, o_, v_, 0.0, kw["t_max"], kw["eps"], MAX_STEPS, min_step, coarse)
        calls += 1
        want = render._march(sdf_, o_, v_, 0.0, kw["t_max"], kw["eps"], MAX_STEPS, min_step, coarse)
        for name, g, w in zip(("depth", "hit", "steps"), got, want):
            check(g.shape == w.shape and g.dtype == w.dtype, f"march {where}: {name} {g.shape}/{g.dtype} vs"
                                                                f" {w.shape}/{w.dtype}")
            check(bool((g == w).all()), f"march {where}: {name} kernel != plain on {int((g != w).sum())} rays")
        return got

    cases = []
    for coarse in (True, False):
        d, h, st = both(sdf, o, v, f"{IMAGE_HW} coarse={coarse}", coarse=coarse)
        cases.append(f"{IMAGE_HW[0]}x{IMAGE_HW[1]} coarse={coarse}: hits {float(h.float().mean()):.4f}, steps"
                     f" {int(st.sum())}")
    of, vf = o.reshape(-1, 3), v.reshape(-1, 3)
    g = torch.Generator(device=dev).manual_seed(16)
    for count, coarse, min_step in [*((c, False, None) for c in MARCH_TAIL_RAYS), (300, True, None),
                                    (MARCH_FALLBACK_RAYS, True, None), (MARCH_FALLBACK_RAYS, True, 0.5 * RES)]:
        pick = torch.randperm(rays, device=dev, generator=g)[:count]
        both(sdf, of[pick], vf[pick], f"{count} rays coarse={coarse} min_step={min_step}", min_step, coarse)
        cases.append(f"{count} rays coarse={coarse} min_step={min_step}")
    rot = torch.tensor([[0.9, -0.4, 0.1], [0.4, 0.9, -0.2], [0.0, 0.2, 1.0]], dtype=torch.float64)
    rot = torch.linalg.qr(rot)[0].to(torch.float32)
    meta_r = GridMeta.create(make_origin_transform([0.3, -1.7, 0.9], rot, device=dev), RES, mask.shape, device=dev)
    sdf_r = SdfGrid.create(values, meta_r, 1e3)
    both(sdf_r, meta_r.grid_to_world(o), rotate_points(meta_r.origin_transform[:3, :3], v), "rotated grid")
    cases.append("the bundle over a rotated, shifted grid")
    odd_o = of[:4096].clone()
    odd_v = vf[:4096].clone()
    odd_o[:8] = float("nan")
    odd_v[8:16] = float("inf")
    odd_v[16:64] = torch.tensor([1.0, 0.0, 0.0], device=dev)
    odd_v[64:96] = torch.tensor([0.0, 0.0, -1.0], device=dev)
    inside = torch.nonzero(mask)[:512].to(torch.float32) * RES + 0.5 * RES
    odd_o[96:96 + inside.shape[0]] = inside
    for coarse in (True, False):
        both(sdf, odd_o, odd_v, f"degenerate rays coarse={coarse}", coarse=coarse)
    cases.append("non-finite, axis-aligned and inside-start rays, coarse on and off")

    # the render cell's plane sweep: its tail and fallback marches with the
    # kernel against the same render with _march in the kernel's place
    c = np.full(3, 0.5 * n * RES)
    views = []
    for k in range(MARCH_VIEWS):
        a = 2 * math.pi * k / MARCH_VIEWS
        cam = c + np.array([-1.2 * math.cos(a), -1.2 * math.sin(a), 0.4]) * n * RES
        views.append(render.camera_rays(cam, c, (0.0, 0.0, 1.0), 50.0, *IMAGE_HW, device=dev))
    o4 = torch.stack([x[0] for x in views])
    v4 = torch.stack([x[1] for x in views])
    profiling.reset_counts()
    l0 = _build.LAUNCHES["march"]
    plane = render_plane.plane_sweep_depth(sdf, o4, v4, 0.0, kw["t_max"], kw["eps"], MAX_STEPS, None)
    torch.cuda.synchronize()
    march_rays, plane_launches = profiling.COUNTS.get("render.march_rays", 0), _build.LAUNCHES["march"] - l0
    on_card = render._march_on_card
    render._march_on_card = render._march
    try:
        plane_plain = render_plane.plane_sweep_depth(sdf, o4, v4, 0.0, kw["t_max"], kw["eps"], MAX_STEPS, None)
    finally:
        render._march_on_card = on_card
    for name, gt, w in zip(("depth", "hit", "steps"), plane, plane_plain):
        check(bool((gt == w).all()), f"plane sweep, {MARCH_VIEWS} views: {name} with the kernel != with _march")
    check(march_rays > 0 and plane_launches >= 1, f"plane sweep, {MARCH_VIEWS} views: {march_rays} rays marched in"
                                                   f" {plane_launches} launches")
    cases.append(f"the plane sweep of {MARCH_VIEWS} views ({march_rays} rays to the march in {plane_launches}"
                 f" launches)")

    # the IFT backward through each forward
    def grads():
        vals = values.clone().requires_grad_(True)
        o_g, v_g = o.clone().requires_grad_(True), v.clone().requires_grad_(True)
        r = render.render_depth(SdfGrid(vals, sdf.meta, sdf.oob_value), o_g, v_g, backend="march", **kw)
        (r.depth ** 2).sum().backward()
        return vals.grad, o_g.grad, v_g.grad

    torch.use_deterministic_algorithms(True)
    try:
        g_kernel = grads()
        calls += 1
        render._march_on_card = render._march
        try:
            g_plain = grads()
        finally:
            render._march_on_card = on_card
    finally:
        torch.use_deterministic_algorithms(False)
    for name, gk, gp in zip(("d values", "d origins", "d directions"), g_kernel, g_plain):
        check(same_bits(gk, gp), f"IFT backward {name}: through the kernel's forward != through _march's")
    check(bool(g_kernel[0].abs().sum() > 0), "IFT backward: d values all zero")
    del g_kernel, g_plain
    cases.append("IFT gradients through both forwards")
    launches = _build.LAUNCHES["march"] - launches0
    check(launches == calls + plane_launches, f"march launches {launches}, want one a call ({calls} + {plane_launches})")

    # timings: the bundle and the fallback's count, in turns with _march
    pick = torch.randperm(rays, device=dev, generator=g)[:MARCH_FALLBACK_RAYS]
    o_fb, v_fb = of[pick].contiguous(), vf[pick].contiguous()
    ms = {}
    for label, (o_, v_) in (("bundle", (o, v)), ("fallback", (o_fb, v_fb))):
        ms[label] = abba(lambda: render._march(sdf, o_, v_, 0.0, kw["t_max"], kw["eps"], MAX_STEPS, None, True),
                         lambda: render._trace_depth(sdf, o_, v_, 0.0, kw["t_max"], kw["eps"], MAX_STEPS, None))
    bound = {label: MARCH_BYTES_PER_RAY * k / HBM_BYTES_PER_S * 1e3 for label, k in (("bundle", rays),
                                                                                      ("fallback", MARCH_FALLBACK_RAYS))}
    first = subprocess.run([sys.executable, str(Path(__file__).resolve().parent / "tools" / "march_first_call.py"),
                            "--n", str(n)], capture_output=True, text=True, timeout=600)
    check(first.returncode == 0, f"tools/march_first_call.py: exit {first.returncode}\n{first.stderr[-2000:]}")
    first = json.loads(first.stdout.strip().splitlines()[-1])
    check(first["launches"] == 1 + len(first["warm_ms"]), f"first call: launches {first['launches']}")
    log(f"[phase16] {smi}: the march kernel equal to _march (depth, hit, steps) on " + "; ".join(cases))
    for label in ms:
        log(f"[phase16] march {label} ({rays if label == 'bundle' else MARCH_FALLBACK_RAYS} rays): kernel"
            f" {ms[label][0]:.4f} ms, plain {ms[label][1]:.3f} ms (median of {2 * TIMING_ROUNDS}); bound"
            f" {bound[label]:.5f} ms by bytes ({MARCH_BYTES_PER_RAY} B a ray), {100 * bound[label] / ms[label][0]:.2f}%")
    log(f"[phase16] a fresh process (tools/march_first_call.py): {json.dumps(first)}")
    check(first["first_minus_warm_ms"] <= MARCH_FIRST_CALL_MAX_MS,
          f"the march's first call costs {first['first_minus_warm_ms']:.1f} ms over a warm one")
    log(f"[phase16] phase time {time.perf_counter() - t_phase:.1f} s; march launches {launches}")
    return {"ms": ms["bundle"], "fallback_ms": ms["fallback"], "bound_ms": bound["bundle"], "launches": launches,
            "first_call": first}


def main() -> None:
    import torch

    # ---- 1. device ------------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this script runs only on a GPU")
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
            check(same_bits(g, w) if bits else bool(same.all()), f"{name} {where}: kernel != plain (max |err| {err})")

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
    check(same_bits(sdf.values, plain_vals),
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

    check(same_bits(values_ft, sdf.values), "FT field != K1-K3 field")
    _, d_occ_plain = ft_field_grad(occ_a, res, "plain")
    check(same_bits(d_occ, d_occ_plain), "FT d occ: kernels != plain")
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
    render_ms_first, render_ms = warm_ms(lambda: engine.render(sdf, cam, center))
    march_ms_first, march_ms = warm_ms(lambda: engine.render(sdf, cam, center, backend="march"))
    split_ms = np.median(warm_ms(lambda: plane_split(sdf, o, v, kw), time_one=lambda fn: fn())[1], axis=0)
    # the tail's resume march alone, on as many rays as the main render resumed
    n_res = max(diag["n_resumed"], 1)
    o_r, v_r = o.reshape(-1, 3)[:n_res].contiguous(), v.reshape(-1, 3)[:n_res].contiguous()
    resume_ms_first, resume_ms = warm_ms(lambda: render._trace_depth(
        sdf, o_r, v_r, 0.0, kw["t_max"], kw["eps"], MAX_STEPS, None, coarse=False))
    tab, ch, vols = main_tables.tab, main_tables.ch, main_tables.vols
    ms["plane_sweep"] = abba(
        lambda: render_plane.plane_sweep_rows_plain(tab, ch, vols, kw["eps"], kw["t_max"]),
        lambda: render_plane.plane_sweep_rows(tab, ch, vols, kw["eps"], kw["t_max"]),
    )
    k8_bound_ms, k8_bound_by, k8_detail = k8_bound(main_tables, main_k8[5][:, 0])
    del tab, ch, vols
    query_ms_first, query_ms = warm_ms(lambda: engine.query(sdf, q))

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
        lib_axis[axis] = float(np.median(warm_ms(lambda: torch.zeros_like(g_rand).scatter_add_(axis, idx, g_rand))[1]))
    del idx
    for name, by_axis in per_axis.items():
        ms[name] = tuple(float(np.mean([t[k] for t in by_axis.values()])) for k in (0, 1))
    library["winner_segment_sum"] = float(np.mean(list(lib_axis.values())))

    # the training path's stages
    occ_r = occ_a.clone().requires_grad_(True)
    ft_fwd_ms_first, ft_fwd_ms = warm_ms(lambda: sdf_from_occupancy_ft(occ_a, res))
    values_r = sdf_from_occupancy_ft(occ_r, res)
    cot = 2.0 * values_r.detach()
    ft_bwd_ms_first, ft_bwd_ms = warm_ms(lambda: torch.autograd.grad(values_r, occ_r, cot, retain_graph=True))
    del values_r, occ_r
    render_vg_ms_first, render_vg_ms = warm_ms(
        lambda: render_value_and_grad(sdf.values, engine.meta, engine.oob_value, o, v, kw))
    step_ms_first, step_ms = warm_ms(lambda: train_step(logits, target, engine.meta, engine.oob_value, o, v, kw))
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
    log(f"[timing] render {IMAGE_HW[0]}x{IMAGE_HW[1]} plane sweep (engine.render): {spread(render_ms, render_ms_first)}")
    log(f"[timing] render {IMAGE_HW[0]}x{IMAGE_HW[1]} march max_steps={MAX_STEPS}: {spread(march_ms, march_ms_first)}")
    log("[timing] plane render split (median of 6): " + ", ".join(
        f"{name} {t:.3f} ms" for name, t in zip(("precompute", "K8", "tail", "fallback"), split_ms)))
    log(f"[timing] K8 bound: {k8_bound_ms:.4f} ms by {k8_bound_by}, {100 * k8_bound_ms / ms['plane_sweep'][0]:.1f}%"
        f" of the kernel's time; {json.dumps(k8_detail)}")
    log(f"[timing] the tail's resume march alone ({n_res} rays, coarse=False): {spread(resume_ms, resume_ms_first)}")
    for name, fn in (("plane", lambda: engine.render(sdf, cam, center)),
                     ("march", lambda: engine.render(sdf, cam, center, backend="march"))):
        n_k, busy, wall = device_profile(fn)
        idle = f"{1 - busy / wall:.3f}" if busy > 0 else "not measured (no device events recorded)"
        log(f"[profile] render {IMAGE_HW[0]}x{IMAGE_HW[1]} {name}: {n_k} kernels, device busy {busy:.3f} ms in a"
            f" {wall:.3f} ms wall under the profiler, idle share {idle}")
    log(f"[timing] query {N_QUERIES} points: {spread(query_ms, query_ms_first)}")
    for name, by_axis in per_axis.items():
        for axis, (k, p) in by_axis.items():
            lib = f", scatter_add_ {lib_axis[axis]:.3f} ms (median of 6)" if name == "winner_segment_sum" else ""
            log(f"[timing] {name} axis {axis} at {N}^3: kernel {k:.3f} ms, plain {p:.3f} ms (median of"
                f" {2 * TIMING_ROUNDS}){lib}")

    log(f"[timing] FT forward {N}^3 (sdf_from_occupancy_ft): {spread(ft_fwd_ms, ft_fwd_ms_first)}")
    log(f"[timing] FT backward {N}^3 (6 winner segment sums): {spread(ft_bwd_ms, ft_bwd_ms_first)}")
    log(f"[timing] render value-and-grad {IMAGE_HW[0]}x{IMAGE_HW[1]}: {spread(render_vg_ms, render_vg_ms_first)}")
    log(f"[timing] training step (sigmoid -> FT field -> render -> loss -> backward): {spread(step_ms, step_ms_first)}")
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

    ref = route("fused", fused, {"line_pass_dual": 1, "envelope_dual": 1, "envelope_dual_combine": 1})
    a5, b5 = route("a", route_a, {"line_pass": 2, "envelope": 4})
    fa5, fb5 = edt.squared_edt_both(mask5)
    check(torch.equal(a5, fa5) and torch.equal(b5, fb5), f"(a) squared_edt != squared_edt_both at {N5}^3")
    del fa5, fb5
    check(same_bits(edt.d2_to_distance(a5, RES).sub_(edt.d2_to_distance(b5, RES)), ref),
          f"(a) combined != the fused K1-K3 field at {N5}^3")
    del a5, b5
    for name, fn, want in (("b", route_b, {"line_pass": 2, "envelope": 4}),
                           ("c", route_c, {"line_pass": 2 * N5_SLABS, "envelope": 4 * N5_SLABS}),
                           ("e", route_e, {"line_pass": 2, "envelope_cht": 4})):
        got = route(name, fn, want)
        check(same_bits(got, ref), f"({name}) != the fused K1-K3 field at {N5}^3")
        del got
    host5 = route("d", route_d, {"line_pass": 2 * N5_SLABS, "envelope": 4 * N5_SLABS}, host_clock=True)
    check(np.array_equal(host5.view(np.uint32), ref.cpu().numpy().view(np.uint32)),
          f"(d) != the fused K1-K3 field at {N5}^3 (on the host)")
    del host5
    config5 = {"minmax": (float(ref.min()), float(ref.max()))}
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
    config5["mean_depth"] = float(r5.depth.mean())
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
    phase9, outs9 = map_topology_phase(dev, engine, mask_np, smi)
    for name in SERVING_KERNELS[:3]:
        check(phase9.get(name, 0) >= 1, f"kernel {name} was not launched in phase 9")

    # ---- 10. config #5's mesh and the last modules -----------------------
    phase10 = mesh_phase(dev, smi, mask_np, outs9)
    del outs9
    for name in MESH_KERNELS:
        check(phase10.get(name, 0) >= 1, f"kernel {name} was not launched in phase 10")

    # ---- 11. the entry points outside the package -------------------------
    phase11 = entry_points_phase(dev, engine, mask_np, smi)
    for name in ENTRY_KERNELS:
        check(phase11.get(name, 0) >= 1, f"kernel {name} was not launched in phase 11")

    # ---- 12. the system's measurement programs ---------------------------
    phase12 = measurement_programs_phase(dev, smi, config5)

    # ---- 13. the envelope-design probes ------------------------------------
    from sdf_tools_tpu_torch.scripts import (_micro, _sampler, bench_micro_gather, bench_micro_gather2,
                                             bench_micro_gather3, bench_micro_render, bench_micro_render2,
                                             bench_micro_render3, bench_micro_render4, bench_micro_render5,
                                             bench_micro_render6, probe_dma_align, probe_smem_block)

    _, probe_kernels = probe_phase(dev, smi, 13, "the envelope-design probes",
                                   (bench_micro_gather, bench_micro_gather2, bench_micro_gather3), _micro.KERNELS,
                                   _micro.SOURCE, extremes=extreme_probes())

    # ---- 14. the render-design probes ---------------------------------------
    _, render_kernels = probe_phase(dev, smi, 14, "the render-design probes",
                                    (probe_smem_block, probe_dma_align, bench_micro_render, bench_micro_render2,
                                     bench_micro_render3, bench_micro_render4, bench_micro_render5,
                                     bench_micro_render6), _sampler.KERNELS, _sampler.SOURCE, RENDER_PAIRS,
                                    RENDER_CHECKED)

    # ---- 15. the signed field in float64, bfloat16 and float16 ------------
    phase15 = field_dtypes_phase(dev, mask_np, smi)

    # ---- 16. the exact march's kernel -------------------------------------
    march = march_phase(dev, smi, torch.as_tensor(mask_np, device=dev))
    ms["march"] = march["ms"]

    # ---- 17. result ------------------------------------------------------
    # ms and plain_ms: one launch (K6: mean of its axis-1 and axis-2 medians,
    # K7: mean of its three axes; K8: on the main render's tables; K4: the
    # squared mode at 1024^3; K5, K9: mean of axes 1 and 2 at 1024^3);
    # launches: the main path's (K1-K3: with phase 8's and 9's runs; K4, K5,
    # K9: the sum over config #5's routes (a)-(e); the main-path runs of
    # phases 10, 11, 12 and 15 added to each); bound_ms: that launch's bytes at
    # peak rate (K8: k8_bound; the march: phase 16's bundle, its bytes a
    # ray, its launches phases 4, 5 and 16's). The five probe kernels (phase 13) and the
    # three of phase 14: ms, plain_ms and bound_ms summed over one B = 1
    # launch of each of their probes (ms: on the device alone), launches
    # from the programs' mains, each probe's numbers under "probes"
    main_launches = {**{k: launches[k] for k in SERVING_KERNELS}, **{k: train_launches[k] for k in TRAINING_KERNELS}}
    main_launches["march"] = launches.get("march", 0) + train_launches.get("march", 0) + march["launches"]
    for name in SERVING_KERNELS[:3]:
        main_launches[name] += phase8[name] + phase9[name]
    for name in CONFIG5_KERNELS:
        main_launches[name] = sum(got.get(name, 0) for got in route_launches.values())
    for phase in (phase10, phase11, phase12, phase15):
        for name, n in phase.items():
            main_launches[name] += n
    bounds = {name: (bytes_bound_ms(name, n), "bytes") for name, (_, _, b, n) in KERNELS.items() if b is not None}
    bounds["plane_sweep"] = (k8_bound_ms, k8_bound_by)
    bounds["march"] = (march["bound_ms"], "bytes")
    kernels = [
        {
            "name": name, "route": "cuda", "source": src, "replaces": tpu,
            "launches": main_launches[name], "max_abs_err": max_err[name],
            "ms": ms[name][0], "plain_ms": ms[name][1],
            "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
            "library_ms": library[name],
        }
        for name, (src, tpu, _, _) in KERNELS.items()
    ] + probe_kernels + render_kernels
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }))


if __name__ == "__main__":
    main()
