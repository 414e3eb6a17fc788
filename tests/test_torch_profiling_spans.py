"""The port's spans and host-side counters (``sdf_tools_tpu_torch/profiling.py``) on the CPU.

* Under ``profiling.trace`` each stage opens its ``sdf.*`` span, nested as
  the port's layers nest: the field's route and grid copy inside
  ``sdf.field``; the plane sweep's tables, sweep, tail and fallback inside
  ``sdf.render``, the exact march inside the fallback; the FT's seeds and
  argmin passes inside ``sdf.ft.forward``; the two backwards on their own.
* With spans off (the default, and a profiler that is not
  ``profiling.trace``) the trace holds no ``sdf.*`` event.
* Every path's outputs are bitwise the same with spans on and off.
* Each path adds to ``profiling.COUNTS`` the host syncs the code makes on a
  CUDA device (``sync.*``) and the rays the
  plane sweep hands to the exact march (``render.march_rays``), as the
  code gives them; ``reset_counts`` clears them.

Sizes: a 20^3 scene, 12 x 16 rays for the training step's march (12 steps), and the plane sweep on two
of ``plane_scenes.k8_edge_case``'s grids (its plain version; the fallback
on the ``"shifted"`` grid, the tail's resume march on demoted model hits).
"""
import json

import numpy as np
import pytest
import torch

from plane_scenes import K8_EDGE_T_MAX, k8_edge_case
from sdf_tools_tpu_torch import profiling
from sdf_tools_tpu_torch.grid import GridMeta, SdfGrid, make_origin_transform
from sdf_tools_tpu_torch.ops import render_plane as rp
from sdf_tools_tpu_torch.ops.diff import sdf_from_occupancy_ft
from sdf_tools_tpu_torch.ops.edt import extract_signed_distance_field
from sdf_tools_tpu_torch.ops.query import estimate_distance, gradient
from sdf_tools_tpu_torch.ops.render import camera_rays, render_depth
from sdf_tools_tpu_torch.ops.voxelize import voxelize_points

N = 20
RES = 0.05
EPS = 1e-3
STEPS = 12  # the march's steps in the profiled paths: each is a few dozen profiler events


def _meta(shape, res):
    return GridMeta.create(make_origin_transform([0.0, 0.0, 0.0], device="cpu"), res, shape, device="cpu")


@pytest.fixture(scope="module")
def scene():
    g = (torch.arange(N, dtype=torch.float32) + 0.5) * RES
    x, y, z = torch.meshgrid(g, g, g, indexing="ij")
    c = 0.5 * N * RES
    mask = (x - c) ** 2 + (y - c) ** 2 + (z - 0.4 * N * RES) ** 2 < (0.3 * N * RES) ** 2
    meta = _meta((N,) * 3, RES)
    pts = torch.rand((300, 3), generator=torch.Generator().manual_seed(3)) * (1.2 * N * RES) - 0.1 * N * RES
    o, v = camera_rays([c, c, 3.0 * N * RES], [c, c, 0.0], [0.0, 1.0, 0.0], 50.0, 12, 16, device="cpu")
    return mask, meta, pts, o, v


def _plane(case):
    values, res, o, v = k8_edge_case(case)
    sdf = SdfGrid.create(torch.from_numpy(values), _meta(values.shape, res), 1e3)
    return sdf, torch.from_numpy(o), torch.from_numpy(v)


def run_paths(scene):
    """name -> the path's output tensors, each path run once."""
    mask, meta, pts, o, v = scene
    out = {}
    sdf, (mx, mn) = extract_signed_distance_field(mask, meta, oob_value=1e3)
    out["field"] = (sdf.values, sdf.oob_value, mx, mn)
    out["voxelize"] = (voxelize_points(pts, meta),)
    out["query"] = (*estimate_distance(sdf, pts), *gradient(sdf, meta.location_to_index(pts), True))
    for case in ("forward", "shifted"):
        psdf, po, pv = _plane(case)
        out[f"plane_{case}"] = tuple(render_depth(psdf, po, pv, t_max=K8_EDGE_T_MAX, eps=EPS, max_steps=STEPS,
                                                  backend="plane"))
    logits = torch.where(mask, 2.0, -2.0).requires_grad_(True)
    values = sdf_from_occupancy_ft(torch.sigmoid(logits), RES)
    rr = render_depth(SdfGrid.create(values, meta, 1e3), o, v, t_max=4.0 * N * RES, max_steps=STEPS, backend="march")
    loss = (rr.depth**2).mean()
    loss.backward()
    out["train"] = (values.detach(), *(x.detach() for x in rr), loss.detach(), logits.grad)  # the march's outputs too
    return out


def _spans(events):
    return [e for e in events if e.get("ph") == "X" and str(e.get("name", "")).startswith(profiling.SPAN_PREFIX)]


def _inside(child, parent):
    return (child["tid"] == parent["tid"] and parent["ts"] <= child["ts"]
            and child["ts"] + child["dur"] <= parent["ts"] + parent["dur"])


# span -> the span it must lie in (None: the spans it may lie in are not fixed)
PARENT = {
    "sdf.field": None, "sdf.field.edt": "sdf.field", "sdf.field.grid": None,
    "sdf.voxelize": None, "sdf.query.distance": None, "sdf.query.gradient": None,
    "sdf.render": None, "sdf.render.plane.tables": "sdf.render", "sdf.render.plane.sweep": "sdf.render",
    "sdf.render.plane.tail": "sdf.render", "sdf.render.plane.fallback": "sdf.render", "sdf.render.march": "sdf.render",
    "sdf.render.ift_backward": None,
    "sdf.ft.forward": None, "sdf.ft.seed": "sdf.ft.forward", "sdf.ft.argmin": "sdf.ft.forward",
    "sdf.ft.backward": None,
}


def test_spans_nest_as_the_layers(scene, tmp_path):
    with profiling.trace(str(tmp_path)):
        run_paths(scene)
    assert profiling.span("x") is profiling.span("y")  # off again after the trace
    spans = _spans(json.loads((tmp_path / "trace.json").read_text())["traceEvents"])
    by_name = {}
    for e in spans:
        by_name.setdefault(e["name"], []).append(e)
    assert set(by_name) == set(PARENT)
    for name, parent in PARENT.items():
        if parent is not None:
            for e in by_name[name]:
                assert any(_inside(e, p) for p in by_name[parent]), name
    # the field's grid copy inside the field once, and on its own in the training step
    assert sum(any(_inside(e, p) for p in by_name["sdf.field"]) for e in by_name["sdf.field.grid"]) == 1
    # the fallback marches the shifted grid's unresolved rows
    assert any(any(_inside(m, f) for f in by_name["sdf.render.plane.fallback"]) for m in by_name["sdf.render.march"])
    # stages of the render lie in no query span; the backwards in no forward span
    for e in by_name["sdf.query.distance"]:
        assert not any(_inside(e, r) for r in by_name["sdf.render"])
    for name in ("sdf.ft.backward", "sdf.render.ift_backward"):
        assert not any(_inside(e, f) for e in by_name[name] for f in by_name["sdf.ft.forward"] + by_name["sdf.render"])
    assert len(by_name["sdf.render"]) == 3 and len(by_name["sdf.render.plane.sweep"]) == 2


def _profiled_names(fn, path):
    """(fn's result, the names of the events of a profiler around it)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    prof.export_chrome_trace(str(path))
    return out, {str(e.get("name")) for e in json.loads(path.read_text())["traceEvents"]}


def test_no_span_with_spans_off(scene, tmp_path):
    assert profiling.set_spans(False) is False
    assert profiling.span("field") is profiling.span("render")
    _, names = _profiled_names(lambda: run_paths(scene), tmp_path / "off.json")
    assert not any(n.startswith(profiling.SPAN_PREFIX) for n in names)
    assert any(n.startswith("aten::") for n in names)


def test_outputs_bitwise_equal_with_spans_on_and_off(scene, tmp_path):
    off = run_paths(scene)
    prev = profiling.set_spans(True)
    try:
        on, names = _profiled_names(lambda: run_paths(scene), tmp_path / "on.json")
    finally:
        profiling.set_spans(prev)
    assert "sdf.render.plane.tail" in names
    assert set(on) == set(off)
    for name in off:
        assert len(on[name]) == len(off[name])
        for a, b in zip(on[name], off[name]):
            assert a.dtype == b.dtype and a.shape == b.shape, name
            if a.is_floating_point():
                assert torch.equal(a.view(torch.int32) if a.dtype == torch.float32 else a, b.view(torch.int32)
                                   if b.dtype == torch.float32 else b), name
            else:
                assert torch.equal(a, b), name


def _counts(fn):
    profiling.reset_counts()
    out = fn()
    got = dict(profiling.COUNTS)
    profiling.reset_counts()
    return got, out


def test_counts_of_the_field_voxelize_query_and_march(scene):
    mask, meta, pts, o, v = scene
    got, (sdf, _) = _counts(lambda: extract_signed_distance_field(mask, meta, oob_value=1e3))
    assert got == {"sync.field.grid_oob": 1}
    got, _ = _counts(lambda: SdfGrid.create(sdf.values.numpy(), meta, sdf.oob_value))
    assert got == {"sync.field.grid_values": 1}
    got, _ = _counts(lambda: voxelize_points(pts, meta))
    assert got == {"sync.voxelize.gather": 2}
    got, _ = _counts(lambda: (estimate_distance(sdf, pts), gradient(sdf, meta.location_to_index(pts), True)))
    assert got == {}
    got, _ = _counts(lambda: render_depth(sdf, o, v, t_max=1.0, backend="march"))
    assert got == {"sync.render.march_sizes": 1}
    got, _ = _counts(lambda: render_depth(sdf, o, v, t_max=1.0, min_step=0.01, backend="march"))
    assert got == {"sync.render.march_sizes": 1, "sync.render.march_min_step": 1}


def test_counts_of_the_training_step(scene):
    mask, meta, _, o, v = scene
    logits = torch.where(mask, 2.0, -2.0).requires_grad_(True)
    got, values = _counts(lambda: sdf_from_occupancy_ft(torch.sigmoid(logits), RES))
    assert got == {"sync.ft.resolution": 1}
    got, _ = _counts(lambda: sdf_from_occupancy_ft(torch.sigmoid(logits), torch.tensor(RES)))
    assert got == {}  # a tensor on the field's device copies nothing
    r = render_depth(SdfGrid.create(values, meta, 1e3), o, v, t_max=1.0, backend="march")
    got, _ = _counts(lambda: r.depth.sum().backward())
    assert got == {}  # the IFT and FT backwards copy nothing and read nothing back


def _plane_expected(supported_axes, n_resumed, n_unresolved, pad=False):
    """The plane sweep's counts by the code: the tables' two shape copies and
    a read a supported axis, the tail's three constants, three gathers and
    a host scalar written through an index in each of its three
    compactions, four gathers in pass 1, five in pass 2, the resume check
    (and its gather), the fallback's check (and its nonzero), a shape copy
    a march."""
    want = {
        "sync.render.tables_shape": 2, "sync.render.tables_axis_any": supported_axes,
        "sync.render.tail_consts": 3, "sync.render.compact_gather": 9, "sync.render.compact_fill": 3,
        "sync.render.tail_gather": 9 + (n_resumed > 0), "sync.render.tail_resume_any": 1,
        "sync.render.fallback_any": 1,
    }
    marches = (n_resumed > 0) + (n_unresolved > 0)
    if n_unresolved:
        want["sync.render.fallback_nonzero"] = 1
    if marches:
        want["sync.render.march_sizes"] = marches
        want["render.march_rays"] = min(n_resumed, rp.KD) + n_unresolved
    if pad:
        want["sync.render.pad"] = 2
    return want


@pytest.mark.parametrize("case", ["forward", "shifted"])
def test_counts_of_the_plane_sweep(case):
    sdf, o, v = _plane(case)
    got, out = _counts(lambda: rp.plane_sweep_depth(sdf, o, v, 0.0, K8_EDGE_T_MAX, EPS, 96, None, diag=True))
    diag = out[3]
    supported = sum(rp._axis_supported(tuple(sdf.values.shape[i] for i in rp._perm(a))) for a in range(3))
    assert got == _plane_expected(supported, int(diag["n_resumed"]), int(diag["unresolved"]))
    assert (case == "shifted") == ("render.march_rays" in got)
    # a flat bundle of rays that is no multiple of 128 is padded with two host rows
    got, _ = _counts(lambda: rp.plane_sweep_depth(sdf, o.reshape(-1, 3)[:200], v.reshape(-1, 3)[:200], 0.0,
                                                  K8_EDGE_T_MAX, EPS, 96, None))
    assert got["sync.render.pad"] == 2 and got["sync.render.tail_consts"] == 3


def test_counts_of_the_tail_resume_march():
    """Model hits placed where no surface is are demoted by pass 1 and
    traced again by the exact march (pass 3), one gather and a shape copy
    more, each ray counted."""
    sdf, o, v = _plane("forward")
    rays = rp.prepare_rays(o, v)
    tables = rp.plane_sweep_tables(sdf.values, sdf.meta, rays.origins, rays.directions, 0.0, K8_EDGE_T_MAX)
    depth, hit, steps, model, tnear, ex = rp.plane_sweep_rows_plain(tables.tab, tables.ch, tables.vols, EPS,
                                                                    K8_EDGE_T_MAX)
    fake = torch.zeros_like(hit)
    fake.view(-1)[:40] = 1
    fake &= hit == 0
    n_fake = int(fake.sum())
    assert n_fake > 0
    hit, model = torch.where(fake > 0, 1, hit), torch.where(fake > 0, 1, model)
    depth = torch.where(fake > 0, 0.5, depth)  # behind the camera's first sample: nothing below eps there
    unresolved = tables.unresolved_row[:, None].expand(-1, rp.LANES).reshape(-1)
    got, tail = _counts(lambda: rp.verify_tail(sdf.values, sdf.meta, rays.origins, rays.directions,
                                               tables.info["tc1"], unresolved, (depth, hit, steps, model, tnear, ex),
                                               0.0, K8_EDGE_T_MAX, EPS, 96, None))
    n_resumed = int(tail.n_resumed)
    assert n_resumed >= 1
    assert got == {"sync.render.tail_consts": 3, "sync.render.compact_gather": 9, "sync.render.compact_fill": 3,
                   "sync.render.tail_gather": 10,
                   "sync.render.tail_resume_any": 1, "sync.render.march_sizes": 1,
                   "render.march_rays": min(n_resumed, rp.KD)}


def test_reset_counts_and_host_copies():
    profiling.count("a")
    profiling.count("a", 4)
    for x, device in ((1.0, "cpu"), (np.float32(1.0), "cpu"), ([1, 2], "cuda"), (torch.tensor(1.0), "cuda:0")):
        profiling.count_host_copy("x", x, device)
    profiling.count_host_copy("y", torch.tensor(1.0), "cpu")
    assert profiling.COUNTS == {"a": 5, "sync.x": 4}
    profiling.reset_counts()
    assert profiling.COUNTS == {}


def _x(name, cat, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": tid, "pid": 0}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_span_device_times_inclusive_and_by_thread():
    """A synthetic trace: ``sdf.render`` holding ``sdf.render.plane.tail``
    holding ``sdf.render.march`` on thread 1, ``sdf.ft.backward`` on
    thread 2, a benchmark span around them; kernels launched at each
    level, one on thread 2 while thread 1's spans are open, one launched
    outside every span and one whose launch the trace lost."""
    ev = [
        _x("render", "user_annotation", 0, 100),
        _x("sdf.render", "user_annotation", 1, 90),
        _x("sdf.render.plane.tail", "user_annotation", 10, 40),
        _x("sdf.render.march", "user_annotation", 20, 10),
        _x("sdf.ft.backward", "user_annotation", 5, 60, tid=2),
        _x("cudaLaunchKernel", "cuda_runtime", 2, 1, corr=1),  # in sdf.render
        _x("cudaLaunchKernel", "cuda_runtime", 12, 1, corr=2),  # in the tail
        _x("cudaLaunchKernel", "cuda_runtime", 25, 1, corr=3),  # in the march
        _x("cudaLaunchKernel", "cuda_runtime", 26, 1, tid=2, corr=4),  # thread 2: the backward only
        _x("cudaMemcpyAsync", "cuda_runtime", 95, 1, corr=5),  # outside every sdf span
        _x("k1", "kernel", 200, 3, tid=7, corr=1),
        _x("k2", "kernel", 210, 5, tid=7, corr=2),
        _x("k3", "kernel", 220, 7, tid=7, corr=3),
        _x("k4", "kernel", 230, 11, tid=7, corr=4),
        _x("copy", "gpu_memcpy", 240, 13, tid=7, corr=5),
        _x("lost", "kernel", 250, 17, tid=7, corr=99),
    ]
    got = profiling.span_device_times(ev)
    us = 1e-6
    assert set(got) == {"sdf.render", "sdf.render.plane.tail", "sdf.render.march", "sdf.ft.backward"}
    assert got["sdf.render"] == {"device_s": pytest.approx(15 * us), "launches": 3}
    assert got["sdf.render.plane.tail"] == {"device_s": pytest.approx(12 * us), "launches": 2}
    assert got["sdf.render.march"] == {"device_s": pytest.approx(7 * us), "launches": 1}
    assert got["sdf.ft.backward"] == {"device_s": pytest.approx(11 * us), "launches": 1}
    tree = profiling.span_trees(ev)[1]
    assert tree.holding(25) == ["sdf.render.march", "sdf.render.plane.tail", "sdf.render"]
    assert tree.holding(35) == ["sdf.render.plane.tail", "sdf.render"] and tree.holding(95) == []
    assert profiling.span_device_times([e for e in ev if not e["name"].startswith("sdf.")]) == {}


def test_program_spans_tool_labels_idle_gaps_by_port_span():
    """``tools/program_spans.py`` labels each idle gap of the device with the
    benchmark's span, the innermost port span open at the gap's start on the
    thread that launched the operation ending it, and the host's op."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "tools" / "program_spans.py"
    spec = importlib.util.spec_from_file_location("program_spans_tool", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    ev = [
        _x("bench.window", "user_annotation", 0, 200),
        _x("render", "user_annotation", 0, 200),
        _x("sdf.render", "user_annotation", 5, 190),
        _x("sdf.render.march", "user_annotation", 100, 80),
        _x("cudaLaunchKernel", "cuda_runtime", 10, 2, corr=1),
        _x("cudaLaunchKernel", "cuda_runtime", 105, 7, corr=2),
        _x("aten::mul", "cpu_op", 108, 3),
        _x("k1", "kernel", 50, 60, tid=7, corr=1),
        _x("k2", "kernel", 150, 10, tid=7, corr=2),
    ]
    got = tool.idle_gaps(ev)
    assert [name for name, _ in got] == ["render/-/python", "render/sdf.render.march/aten::mul"]
    assert [s for _, s in got] == pytest.approx([90e-6, 40e-6])
