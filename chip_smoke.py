"""Smoke run of the PyTorch/CUDA port (``sdf_tools_tpu_torch``) on one GPU.

Run from the repository root on a machine with an NVIDIA Hopper card:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing falls back to the CPU):

1. Device: the card's name and power limit, library versions; TF32 off.
2. Build the CUDA kernels from ``sdf_tools_tpu_torch/csrc`` and time it.
3. Each kernel against its plain PyTorch version on the card, bitwise, at
   small and degenerate shapes, an all-empty and an all-full mask, and at
   ``bench.make_scene(256)``.
4. The serving path at BASELINE config #4 size through ``SdfEngine``:
   512^3 signed field of ``bench.make_scene(512)``, 1M trilinear queries,
   one 1024^2 sphere-traced depth render from ``bench.py``'s camera. Kernel
   launch counts are reset just before and read just after this run; every
   kernel must have run. Then each kernel against its plain version at
   512^3, and the whole field against the plain chain, all bitwise.
   The card's queries and render are held against the port's CPU path on a
   subset. Then CUDA-event timings (median; plain and kernel in turns
   plain, kernel, kernel, plain) and peak device memory.
5. One JSON line with the kernels, then the last line
   ``{"ok": true, "device": {...}}``.

Imports neither JAX nor ``sdf_tools_tpu``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

N = 512
RES = 0.05
IMAGE_HW = (1024, 1024)
MAX_STEPS = 64
N_QUERIES = 1 << 20
SMALL_SHAPES = [(16, 24, 32), (8, 40, 1), (1, 16, 128), (5, 7, 9), (33, 64, 129), (128, 128, 128)]
TIMING_ROUNDS = 3  # ABBA rounds: 6 timed runs of each side
# the tolerance the JAX package's own tests hold two march runs to
# (tests/test_render.py, jit vs eager): hits agree on >= 99.5% of rays,
# common-hit depths within 2e-3
HIT_AGREE_MIN = 0.995
DEPTH_ATOL = 2e-3
QUERY_ATOL = 1e-6

KERNELS = {
    "line_pass_dual": ("sdf_tools_tpu_torch/csrc/edt_line_pass.cu", "sdf_tools_tpu/ops/edt_pallas.py:504"),
    "envelope_dual": ("sdf_tools_tpu_torch/csrc/edt_envelope.cu", "sdf_tools_tpu/ops/edt_pallas.py:331"),
    "envelope_dual_combine": ("sdf_tools_tpu_torch/csrc/edt_envelope.cu", "sdf_tools_tpu/ops/edt_pallas.py:426"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


class Failure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise Failure(what)


def main() -> None:
    import torch

    # ---- 1. device ------------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this script runs only on a GPU")
    from bench import make_scene
    from sdf_tools_tpu_torch import SdfEngine, _build
    from sdf_tools_tpu_torch.ops import edt, edt_cuda, query, render

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

    def compare(name: str, got, want, where: str) -> None:
        for g, w in zip(got, want):
            check(g.shape == w.shape and g.dtype == w.dtype, f"{name} {where}: {g.shape}/{g.dtype} vs {w.shape}/{w.dtype}")
            same = g == w  # inf == inf; no NaN is produced
            err = 0.0 if bool(same.all()) else float((g.double() - w.double())[~same].abs().max())
            max_err[name] = max(max_err[name], err)
            gi = g.view(torch.int32) if g.dtype == torch.float32 else g
            wi = w.view(torch.int32) if w.dtype == torch.float32 else w
            check(torch.equal(gi, wi), f"{name} {where}: kernel != plain (max |err| {err})")

    def kernels_vs_plain(mask, where: str) -> None:
        got = edt_cuda.line_pass_dual(mask)
        fa, fb = edt_cuda.line_pass_dual_plain(mask)
        compare("line_pass_dual", got, (fa, fb), where)
        for axis in (1, 2):
            got = edt_cuda.envelope_dual(fa, fb, axis)
            want = edt_cuda.envelope_dual_plain(fa, fb, axis)
            compare("envelope_dual", got, want, f"{where} axis {axis}")
        ea, eb = edt_cuda.envelope_dual_plain(fa, fb, 1)
        got = edt_cuda.envelope_dual_combine(ea, eb, RES)
        want = edt_cuda.envelope_dual_combine_plain(ea, eb, RES)
        compare("envelope_dual_combine", (got,), (want,), where)
        torch.cuda.synchronize()

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
    kernels_vs_plain(torch.as_tensor(make_scene(256), device=dev), "make_scene(256)")
    log(f"[kernels] bitwise equal to plain at {len(SMALL_SHAPES)} random shapes, empty, full and 256^3"
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
    for name in KERNELS:
        check(launches[name] >= 1, f"kernel {name} was not launched on the main path")

    # each kernel against its plain version at the main path's shape, then
    # the whole field against the plain chain (a check of its own)
    kernels_vs_plain(mask, f"main path {N}^3")
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
    log(f"[main] K1, K2 (axis 1, 2), K3 and the signed field {N}^3 bitwise equal to plain; min {float(sdf.values.min()):.6f}"
        f" max {float(sdf.values.max()):.6f}; query mean {float(dist.mean()):.6f}")
    log(f"[main] render {IMAGE_HW[0]}x{IMAGE_HW[1]}: hit fraction {hit_frac:.6f}, mean depth {mean_depth:.6f}")

    # the card against the port's CPU path on a subset
    sdf_cpu = sdf.to("cpu")
    dq_cpu, _ = query.estimate_distance(sdf_cpu, q[:4096].cpu())
    check(bool(torch.allclose(dist[:4096].cpu(), dq_cpu, rtol=0, atol=QUERY_ATOL)), "query: card vs CPU")
    o, v = render.camera_rays(cam, center, engine.render_up, engine.fov_deg, *IMAGE_HW, device=dev)
    o_s, v_s = o[::32, ::32].contiguous(), v[::32, ::32].contiguous()
    kw = dict(t_max=engine.render_t_max, eps=engine.render_eps, max_steps=MAX_STEPS)
    r_gpu = render.render_depth(sdf, o_s, v_s, **kw)
    r_cpu = render.render_depth(sdf_cpu, o_s.cpu(), v_s.cpu(), **kw)
    h_gpu, h_cpu = r_gpu.hit.cpu(), r_cpu.hit
    agree = float((h_gpu == h_cpu).float().mean())
    both = h_gpu & h_cpu
    ddiff = float((r_gpu.depth.cpu() - r_cpu.depth)[both].abs().max()) if bool(both.any()) else 0.0
    log(f"[main] render card vs CPU on {h_cpu.numel()} rays: hit agreement {agree:.6f}, max common-hit depth diff {ddiff:.3e}")
    check(agree >= HIT_AGREE_MIN and ddiff <= DEPTH_ATOL, "render: card vs CPU")

    # ---- timings ---------------------------------------------------------
    def cuda_ms(fn) -> float:
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop)

    def abba(plain_fn, kernel_fn):
        plain_fn()
        kernel_fn()
        tp, tk = [], []
        for _ in range(TIMING_ROUNDS):
            tp.append(cuda_ms(plain_fn))
            tk.append(cuda_ms(kernel_fn))
            tk.append(cuda_ms(kernel_fn))
            tp.append(cuda_ms(plain_fn))
        return float(np.median(tk)), float(np.median(tp))

    fa, fb = edt_cuda.line_pass_dual(mask)
    ea, eb = edt_cuda.envelope_dual(fa, fb, 1)
    ms = {}
    ms["line_pass_dual"] = abba(lambda: edt_cuda.line_pass_dual_plain(mask), lambda: edt_cuda.line_pass_dual(mask))
    ms["envelope_dual"] = abba(lambda: edt_cuda.envelope_dual_plain(fa, fb, 1), lambda: edt_cuda.envelope_dual(fa, fb, 1))
    ms["envelope_dual_combine"] = abba(
        lambda: edt_cuda.envelope_dual_combine_plain(ea, eb, RES), lambda: edt_cuda.envelope_dual_combine(ea, eb, RES)
    )
    field_ms, field_plain_ms = abba(
        lambda: edt.signed_field_from_masks(mask, res32, "plain"), lambda: engine.sdf_from_occupancy(mask)
    )
    render_ms = [cuda_ms(lambda: engine.render(sdf, cam, center)) for _ in range(6)]
    query_ms = [cuda_ms(lambda: engine.query(sdf, q)) for _ in range(6)]
    peak_all = torch.cuda.max_memory_allocated()

    log(f"[timing] card: {smi}")
    for name, (k, p) in ms.items():
        log(f"[timing] {name} at {N}^3: kernel {k:.3f} ms, plain {p:.3f} ms (median of {2 * TIMING_ROUNDS})")
    log(f"[timing] signed field {N}^3 end to end: kernels {field_ms:.3f} ms, plain {field_plain_ms:.3f} ms")
    log(f"[timing] render {IMAGE_HW[0]}x{IMAGE_HW[1]} march max_steps={MAX_STEPS}: {np.median(render_ms):.3f} ms"
        f" (median of {len(render_ms)}; min {min(render_ms):.3f}, max {max(render_ms):.3f})")
    log(f"[timing] query {N_QUERIES} points: {np.median(query_ms):.3f} ms (median of {len(query_ms)})")
    log(f"[memory] max_memory_allocated: main path {peak_main / 2**30:.3f} GiB, whole run {peak_all / 2**30:.3f} GiB")

    # ---- 5. result -------------------------------------------------------
    kernels = [
        {
            "name": name, "route": "cuda", "source": src, "replaces": tpu,
            "launches": launches[name], "max_abs_err": max_err[name],
            "ms": ms[name][0], "plain_ms": ms[name][1],
        }
        for name, (src, tpu) in KERNELS.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }))


if __name__ == "__main__":
    main()
