"""Measurements of K8, the plane sweep (``csrc/render_plane.cu``), on one GPU.

Run from the repository root on a machine with an NVIDIA Hopper card:

    python3 tools/k8_probe.py [--source LABEL=PATH]... [--vary LABEL:NAME=VALUE,...]... [--variants]

Builds each K8 source given (default: the repository's own) into a library
of its own with nvcc (``-Xptxas -v``: registers, spills), and reads each
kernel's attributes and blocks per SM. On each scene's render tables
(``make_scene(n)`` rasterised on the card, its K1-K3 field, ``chip_smoke.py``'s
camera, 1024^2 rays) it reports the work per row (slot and executed-slab
counts, valid samples and pairs) and the boxes of cells the executed slabs
read (``render_plane.slab_footprints``), holds every source's six outputs
against the plain version, and times the sources in turns (A, B, B, A);
a source whose entry point takes a row order is also timed in table order.

``--variants`` times, on the first source, (i) the corners replaced by a
constant (compute only) and (ii) the loads kept and the arithmetic reduced
to a checksum (memory only), both on tables whose slot counts are the
rows' executed counts, so that every variant executes the same slabs; the
rows launched longest first; extra dynamic shared memory that leaves fewer
blocks on an SM; and a per-block clock (global timer at start and end, SM
id), from which it reports the blocks' durations against their rows' slab
counts and the launch's tail. The first source must read the corners with
``__ldg`` and have one of two slab bodies: the repository's
``sweep_slab(...)`` call, or the earlier inline body from ``bool
has_cand`` to ``++s`` (with no row order).

Every number goes to standard output and, with ``--out PATH``, to a JSON
file. Imports neither JAX nor ``sdf_tools_tpu``. An earlier kernel is
measured from its source:
``git show <commit>:sdf_tools_tpu_torch/csrc/render_plane.cu > k8_old.cu``,
then ``--source old=k8_old.cu``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

ROUNDS = 5  # A, B, B, A rounds per timing

# appended to a source that has no attribute entry of its own
ATTRS_ENTRY = r"""
extern "C" int sdf_plane_sweep_attrs(int tab_w, int* out) {
    cudaFuncAttributes a;
    cudaError_t e = cudaFuncGetAttributes(&a, plane_sweep_kernel);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int smem = tab_w * static_cast<int>(sizeof(int));
    int nb = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, plane_sweep_kernel, 128, smem);
    out[0] = a.numRegs; out[1] = static_cast<int>(a.localSizeBytes); out[2] = static_cast<int>(a.sharedSizeBytes);
    out[3] = a.maxThreadsPerBlock; out[4] = nb; out[5] = smem;
    return static_cast<int>(e);
}
"""
# the sweep's launch with extra dynamic shared memory (fewer blocks per SM);
# ORDER_* are filled in for an entry point with a row order
EXTRA_SMEM_ENTRY = r"""
extern "C" int k8_probe_launch(int extra, const int* tab, int tab_w, const float* ch, const float* vol0,
                               const float* vol1, const float* vol2, float eps, float t_max, int rows, ORDER_PARAM
                               float* depth, int* hit, int* steps, int* model, float* tnear, int* exec,
                               cudaStream_t stream) {
    const int smem = tab_w * static_cast<int>(sizeof(int)) + extra;
    cudaFuncSetAttribute(plane_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    ORDER_LAUNCH
    plane_sweep_kernel<<<rows, LANES, smem, stream>>>(tab, tab_w, ch, vol0, vol1, vol2, eps, t_max, ORDER_ARG depth,
                                                      hit, steps, model, tnear, exec);
    return static_cast<int>(cudaGetLastError());
}
extern "C" int k8_probe_blocks(int extra, int tab_w, int* nb) {
    cudaFuncSetAttribute(plane_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         tab_w * static_cast<int>(sizeof(int)) + extra);
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        nb, plane_sweep_kernel, 128, tab_w * static_cast<int>(sizeof(int)) + extra));
}
"""
CLOCK_DECL = r"""
__device__ unsigned long long* k8_probe_clock = nullptr;
"""
CLOCK_ENTRY = r"""
extern "C" int k8_probe_set_clock(void* p) {
    return static_cast<int>(cudaMemcpyToSymbol(k8_probe_clock, &p, sizeof(p)));
}
"""
CLOCK_START = """
    unsigned long long k8_t0;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(k8_t0));
"""
CLOCK_END = """
    if (threadIdx.x == 0 && k8_probe_clock != nullptr) {
        unsigned long long k8_t1;
        unsigned k8_sm;
        asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(k8_t1));
        asm volatile("mov.u32 %0, %%smid;" : "=r"(k8_sm));
        k8_probe_clock[3 * row] = k8_t0;
        k8_probe_clock[3 * row + 1] = k8_t1;
        k8_probe_clock[3 * row + 2] = k8_sm;
    }
"""
# the earlier inline per-slab body, from the first plane flag to the slab counter
SLAB_BODY = re.compile(r"        bool has_cand = false.*?\n        \+\+s;\n", re.S)
# the repository's per-slab call
SLAB_CALL = "        sweep_slab(r, g, unpack(stab[HDR + s], g), kc, st);\n"
CHECKSUM_CALL = """        {
            const Slab sl = unpack(stab[HDR + s], g);
            float acc = 0.0f;
            int n_valid = 0;
#pragma unroll
            for (int k = 0; k < PB; ++k) {
                const Plane cur = load_plane(r, g, sl, k);
                if (cur.valid) {
                    acc += cur.c00 + cur.c01 + cur.c10 + cur.c11;
                    ++n_valid;
                }
            }
            st.depth += acc;
            st.steps += n_valid;
            const float xbf = static_cast<float>(sl.xb);
            const float t_reach = kc.dirpos ? r.tc0 + r.tc1 * (xbf + (PB - 0.5f)) : r.tc0 + r.tc1 * (xbf + 0.5f);
            st.dead |= (t_reach >= r.t_end ? 1 : 0);
        }
"""
CHECKSUM_BODY = """        float acc = 0.0f;
        int n_valid = 0;
#pragma unroll
        for (int k = 0; k < PB; ++k) {
            const Plane cur = load_plane(r, g, xb, yb, zb, k);
            if (cur.valid) {
                acc += cur.c00 + cur.c01 + cur.c10 + cur.c11;
                ++n_valid;
            }
        }
        depth += acc;
        steps += n_valid;
        const float xbf = static_cast<float>(xb);
        const float t_reach = dirpos ? r.tc0 + r.tc1 * (xbf + (PB - 0.5f)) : r.tc0 + r.tc1 * (xbf + 0.5f);
        dead |= (t_reach >= r.t_end ? 1 : 0);
        ++s;
"""
CONST_FN = "__device__ __forceinline__ float k8_const(const float*) { return 1.0e3f; }\n"


def log(msg: str) -> None:
    print(msg, flush=True)


def variant_sources(text: str, variants: bool) -> dict:
    """label -> source text: the source itself, and with ``variants`` its
    compute-only, memory-only and clocked forms (a direct sweep)."""
    out = {"": text}
    if not variants:
        return out
    anchor_start = "    const int lane = threadIdx.x;\n"
    anchor_end = "    const size_t o = static_cast<size_t>(row) * LANES + lane;\n"
    for needle in (anchor_start, anchor_end, "__ldg(", "__device__ __forceinline__ float corr("):
        if needle not in text:
            raise SystemExit(f"k8_probe --variants: the source has no {needle!r}")
    out["compute"] = text.replace("__ldg(", "k8_const(").replace(
        "__device__ __forceinline__ float corr(", CONST_FN + "__device__ __forceinline__ float corr(", 1)
    if SLAB_CALL in text:
        out["memory"] = text.replace(SLAB_CALL, CHECKSUM_CALL, 1)
    elif SLAB_BODY.search(text):
        out["memory"] = SLAB_BODY.sub(lambda _: CHECKSUM_BODY, text, count=1)
    else:
        raise SystemExit("k8_probe --variants: the source has no slab body this tool knows")
    clocked = text.replace("namespace {\n", "namespace {\n" + CLOCK_DECL, 1)
    clocked = clocked.replace(anchor_start, anchor_start + CLOCK_START, 1).replace(anchor_end, CLOCK_END + anchor_end, 1)
    out["clock"] = clocked + CLOCK_ENTRY
    return out


def build_all(sources: dict, variants: bool) -> dict:
    """Compile every (label, variant) into its own library, all nvcc
    processes started together. Returns name -> (ctypes library, ptxas
    report)."""
    from sdf_tools_tpu_torch import _build

    bdir = _build.BUILD_DIR / "probe"
    bdir.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    jobs = {}
    for i, (label, path) in enumerate(sources.items()):
        text = Path(path).read_text()
        for var, src in variant_sources(text, variants and i == 0).items():
            ordered = "int* order" in src
            if "sdf_plane_sweep_attrs" not in src:
                src += ATTRS_ENTRY
            if var == "":
                src += (EXTRA_SMEM_ENTRY.replace("ORDER_PARAM", "int* order," if ordered else "")
                        .replace("ORDER_ARG", "order," if ordered else "")
                        .replace("ORDER_LAUNCH", "if (order != nullptr) row_order_kernel<<<1, ORDER_THREADS, 0, stream>>>"
                                 "(tab, tab_w, rows, order);" if ordered else ""))
            name = f"{label}-{var}" if var else label
            cu = bdir / f"k8_{name}.cu"
            cu.write_text(src)
            so = bdir / f"libk8_{name}.so"
            cmd = [nvcc, *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-Xptxas", "-v", "-shared", "-o", str(so), str(cu)]
            jobs[name] = (so, cu, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, cu, proc) in jobs.items():
        report = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"k8_probe: nvcc failed for {name}:\n{report}")
        lib = ctypes.CDLL(str(so))
        lib.k8_has_order = "int* order" in cu.read_text()
        sig = list(_build.SIGNATURES["sdf_plane_sweep"])
        lib.sdf_plane_sweep.argtypes = sig if lib.k8_has_order else sig[:9] + sig[10:]
        lib.sdf_plane_sweep.restype = ctypes.c_int
        lib.sdf_plane_sweep_attrs.argtypes = [ctypes.c_int, ctypes.c_void_p]
        lib.sdf_plane_sweep_attrs.restype = ctypes.c_int
        if hasattr(lib, "k8_probe_launch"):
            lib.k8_probe_launch.argtypes = [ctypes.c_int] + lib.sdf_plane_sweep.argtypes
            lib.k8_probe_blocks.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lines = [ln.strip() for ln in report.splitlines() if "ptxas info" in ln and ("Used" in ln or "spill" in ln)]
        libs[name] = (lib, lines)
    return libs


def attrs(lib, tab_w: int) -> dict:
    buf = (ctypes.c_int * 8)()
    rc = lib.sdf_plane_sweep_attrs(tab_w, ctypes.cast(buf, ctypes.c_void_p))
    if rc != 0:
        raise SystemExit(f"k8_probe: sdf_plane_sweep_attrs returned {rc}")
    keys = ("registers", "local_bytes", "static_smem", "max_threads", "blocks_per_sm", "dynamic_smem")
    return dict(zip(keys, list(buf)[:6]))


def launch(lib, tab, ch, vols, eps, t_max, extra=None, order=True):
    """The six outputs of one launch of ``lib``'s kernel on these tables;
    an entry point that takes a row order gets scratch for it (the rows by
    slot count, most first, as the wrapper does) or, with ``order=False``,
    none (the table's order)."""
    import torch

    R, width = tab.shape
    dev = tab.device
    outs = [torch.empty((R, 128), dtype=torch.float32, device=dev)]
    outs += [torch.empty((R, 128), dtype=torch.int32, device=dev) for _ in range(3)]
    outs += [torch.empty((R, 128), dtype=torch.float32, device=dev), torch.empty((R, 128), dtype=torch.int32, device=dev)]
    args = [tab.data_ptr(), width, ch.data_ptr(), *[None if v is None else v.data_ptr() for v in vols],
            ctypes.c_float(eps), ctypes.c_float(t_max), R, *[o.data_ptr() for o in outs],
            torch.cuda.current_stream().cuda_stream]
    if lib.k8_has_order:
        scratch = torch.empty(R, dtype=torch.int32, device=dev) if order else None
        args[9:9] = [None if scratch is None else scratch.data_ptr()]
    rc = lib.sdf_plane_sweep(*args) if extra is None else lib.k8_probe_launch(extra, *args)
    if rc != 0:
        raise SystemExit(f"k8_probe: launch failed with cudaError_t {rc}")
    return outs


def stats(x) -> dict:
    x = x.double()
    return dict(mean=float(x.mean()), p50=float(x.quantile(0.5)), p99=float(x.quantile(0.99)), max=float(x.max()))


def scene_tables(n: int, dev):
    """(label, sdf, tables) of a 1024^2 render over make_scene(n)'s field
    from chip_smoke.py's camera, and the render's eps and t_max."""
    import torch
    from sdf_tools_tpu_torch import GridMeta, SdfGrid
    from sdf_tools_tpu_torch.ops import edt, render

    mask, _, _ = cs.device_scene(n, dev)
    vals = edt.signed_field_from_masks(mask, cs.RES, "auto")[0]
    del mask
    sdf = SdfGrid.create(vals, GridMeta.create(torch.eye(4, device=dev), cs.RES, (n, n, n), device=dev), 1e3)
    c = np.full(3, 0.5 * n * cs.RES)
    o, v = render.camera_rays(c + np.array([-1.2, 0.0, 0.4]) * n * cs.RES, c, (0.0, 0.0, 1.0), 50.0, *cs.IMAGE_HW,
                              device=dev)
    t_max = 4 * n * cs.RES
    _, tables = cs.plane_tables(sdf, o, v, t_max)
    return sdf, tables, cs.RENDER_EPS, t_max


def in_turns(fns: dict, rounds: int = ROUNDS) -> dict:
    """Medians of 2 * rounds CUDA-event timings of each function, in turns
    (forward then backward order each round) after one untimed run each."""
    for fn in fns.values():
        fn()
    times = {k: [] for k in fns}
    order = list(fns)
    for _ in range(rounds):
        for k in order + order[::-1]:
            times[k].append(cs.cuda_ms(fns[k]))
    return {k: float(np.median(t)) for k, t in times.items()}


def clock_report(clk, exec_rows) -> dict:
    """Per-block durations against slab counts, and the launch's tail."""
    t0, t1, sm = clk[:, 0].double(), clk[:, 1].double(), clk[:, 2]
    start, end = float(t0.min()), float(t1.max())
    dur = (t1 - t0) / 1e3  # us
    ex = exec_rows.double()
    A = np.stack([np.ones(len(ex)), ex.cpu().numpy()], 1)
    coef = np.linalg.lstsq(A, dur.cpu().numpy(), rcond=None)[0]
    busy_sm = np.bincount(sm.cpu().numpy().astype(np.int64), weights=dur.cpu().numpy(), minlength=132)
    last_start = float(t0.max())
    return dict(
        makespan_us=(end - start) / 1e3, block_us=stats(dur), block_us_exec0=stats(dur[ex == 0]) if bool((ex == 0).any()) else None,
        fit_us_fixed=float(coef[0]), fit_us_per_slab=float(coef[1]),
        sum_block_us=float(dur.sum()), sm_busy_us=stats(torch_from(busy_sm)),
        tail_after_last_start_us=(end - last_start) / 1e3,
        longest_block=dict(us=float(dur.max()), exec=int(ex[int(dur.argmax())]), start_us=float((t0[int(dur.argmax())] - start) / 1e3)),
    )


def torch_from(a):
    import torch

    return torch.as_tensor(a)


def main() -> None:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--source", action="append", default=[], help="LABEL=PATH of a K8 source (repeatable)")
    ap.add_argument("--vary", action="append", default=[],
                    help="LABEL:NAME=VALUE,...: the repository's source with these int constants (repeatable)")
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--scenes", default="512,1024")
    ap.add_argument("--out", default=None, help="a JSON file for every number")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k8_probe: no CUDA device")
    from sdf_tools_tpu_torch import _build
    from sdf_tools_tpu_torch.ops import render_plane as rp

    sources = dict(s.split("=", 1) for s in args.source)
    if args.vary:
        (_build.BUILD_DIR / "probe").mkdir(parents=True, exist_ok=True)
    for spec in args.vary:
        label, consts = spec.split(":", 1)
        text = (_build.CSRC / "render_plane.cu").read_text()
        for key, val in (kv.split("=") for kv in consts.split(",")):
            text, n = re.subn(rf"constexpr int {key} = \d+;", f"constexpr int {key} = {int(val)};", text)
            if n != 1:
                raise SystemExit(f"k8_probe --vary: no constexpr {key} in the source")
        path = _build.BUILD_DIR / "probe" / f"vary_{label}.cu"
        path.write_text(text)
        sources[label] = str(path)
    sources = sources or {"repo": str(_build.CSRC / "render_plane.cu")}
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    _build.library()
    libs = build_all(sources, args.variants)
    log(f"[build] {len(libs)} libraries in {time.perf_counter() - t0:.1f} s")
    report = dict(card=smi, sources=sources, build={k: v[1] for k, v in libs.items()}, scenes={})
    for name, (_, lines) in libs.items():
        log(f"[ptxas] {name}: " + " | ".join(lines))

    for n in (int(s) for s in args.scenes.split(",")):
        sdf, tables, eps, t_max = scene_tables(n, dev)
        tab, ch, vols = tables.tab, tables.ch, tables.vols
        where = f"{n}^3 {cs.IMAGE_HW[0]}x{cs.IMAGE_HW[1]}"
        rep = dict(rows=tab.shape[0], tab_width=tab.shape[1])
        want = rp.plane_sweep_rows_plain(tab, ch, vols, eps, t_max)
        exec_rows = want[5][:, 0]
        for name, (lib, _) in libs.items():
            rep[f"attrs {name}"] = attrs(lib, tab.shape[1])
            log(f"[attrs] {where} {name}: {json.dumps(rep[f'attrs {name}'])}")
        for label in sources:
            for g, w in zip(launch(libs[label][0], tab, ch, vols, eps, t_max), want):
                if not torch.equal(g, w):
                    raise SystemExit(f"k8_probe: {label} differs from the plain version at {where}")
        log(f"[check] {where}: every source's six outputs equal to the plain version")

        # the work per row and the boxes of cells the executed slabs read
        n_act = tab[:, 0]
        fp = rp.slab_footprints(tab, ch, vols, exec_rows)
        ran = fp["p1"] >= fp["p0"]
        planes, y_rows, z_cells = (fp[b] - fp[a] + 1 for a, b in (("p0", "p1"), ("y0", "y1"), ("z0", "z1")))
        cells = planes * y_rows * z_cells
        rep["work"] = dict(
            n_act=stats(n_act), exec=stats(exec_rows), rows_with_slots=int((n_act > 0).sum()),
            rows_executing=int((exec_rows > 0).sum()), exec_total=int(exec_rows.sum()), n_act_total=int(n_act.sum()),
            exec_of_executing=stats(exec_rows[exec_rows > 0]), samples=int(fp["samples"].sum()),
            pairs=int(fp["pairs"].sum()), lane_planes=int(exec_rows.sum()) * 128 * 17,
        )
        rep["boxes"] = dict(
            slabs=int(fp["row"].numel()), empty=int((~ran).sum()), cells=stats(cells[ran]), planes=stats(planes[ran]),
            y_rows=stats(y_rows[ran]), z_cells=stats(z_cells[ran]),
        )
        log(f"[work] {where}: {json.dumps(rep['work'])}")
        log(f"[boxes] {where}: {json.dumps(rep['boxes'])}")

        # the sources in turns
        fns = {label: (lambda lib=libs[label][0]: launch(lib, tab, ch, vols, eps, t_max)) for label in sources}
        for label in sources:
            lib = libs[label][0]
            if lib.k8_has_order:
                fns[f"{label}, rows in table order"] = lambda lib=lib: launch(lib, tab, ch, vols, eps, t_max,
                                                                             order=False)
        rep["ms"] = in_turns(fns)
        log(f"[timing] {where}, in turns: " + ", ".join(f"{k} {v:.4f} ms" for k, v in rep["ms"].items()))

        if args.variants:
            first = next(iter(sources))
            base = libs[first][0]
            # every variant executes exactly the rows' executed slabs
            tab_e = tab.clone()
            tab_e[:, 0] = exec_rows
            for name in (first, f"{first}-compute", f"{first}-memory"):
                e = launch(libs[name][0], tab_e, ch, vols, eps, t_max)[5][:, 0]
                if not torch.equal(e, exec_rows):
                    raise SystemExit(f"k8_probe: {name} executed other slabs than the kernel")
            order = torch.argsort(exec_rows, descending=True, stable=True)
            tab_l, ch_l = tab[order].contiguous(), ch[order].contiguous()
            fns = {
                "kernel": lambda: launch(base, tab, ch, vols, eps, t_max),
                "kernel, slot counts = executed": lambda: launch(base, tab_e, ch, vols, eps, t_max),
                "(i) compute only": lambda: launch(libs[f"{first}-compute"][0], tab_e, ch, vols, eps, t_max),
                "(ii) memory only": lambda: launch(libs[f"{first}-memory"][0], tab_e, ch, vols, eps, t_max),
                "rows longest first": lambda: launch(base, tab_l, ch_l, vols, eps, t_max, order=False),
            }
            rep["variants_ms"] = in_turns(fns)
            log(f"[variants] {where}, in turns: " + ", ".join(f"{k} {v:.4f} ms" for k, v in rep["variants_ms"].items()))
            # blocks per SM forced down by extra dynamic shared memory
            occ = {}
            nb_free = attrs(base, tab.shape[1])["blocks_per_sm"]
            for k in range(1, nb_free):
                extra = 233472 // k - 1024 - tab.shape[1] * 4 - 64
                nb = ctypes.c_int(0)
                base.k8_probe_blocks(extra, tab.shape[1], ctypes.byref(nb))
                occ[k] = (extra, nb.value)
            occ_fns = {f"{nb} blocks/SM": (lambda x=extra: launch(base, tab, ch, vols, eps, t_max, extra=x))
                       for extra, nb in occ.values()}
            occ_fns[f"{nb_free} blocks/SM (as built)"] = lambda: launch(base, tab, ch, vols, eps, t_max)
            rep["occupancy_ms"] = in_turns(occ_fns, rounds=2)
            log(f"[occupancy] {where}: " + ", ".join(f"{k} {v:.4f} ms" for k, v in rep["occupancy_ms"].items()))
            # the per-block clock
            clock_lib = libs[f"{first}-clock"][0]
            clk = torch.zeros((tab.shape[0], 3), dtype=torch.int64, device=dev)
            clock_lib.k8_probe_set_clock.argtypes = [ctypes.c_void_p]
            clock_lib.k8_probe_set_clock(clk.data_ptr())
            for _ in range(3):
                launch(clock_lib, tab, ch, vols, eps, t_max)
            torch.cuda.synchronize()
            rep["clock"] = clock_report(clk, exec_rows)
            log(f"[clock] {where}: {json.dumps(rep['clock'])}")
        report["scenes"][str(n)] = rep
        del sdf, tables, tab, ch, vols, want
        torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    log(json.dumps({"ok": True}))


if __name__ == "__main__":
    main()
