"""A planner's map update in a closed loop with one caller.

Each update takes the next occupancy from a pool made at set-up (a sphere
scene's mask, or a point cloud that it voxelizes first), builds the signed
field (``extract_signed_distance_field``), queries distance and gradient at
the next set of query points, and ends with one scalar read to the host:
the least in-bounds distance of the queries.

Traffic parameters (``benchmark/traffic/<name>.json``): ``rate_metric``
(the name the cell's updates a second are reported under), ``pool`` (sphere
scenes: ``make_scene`` seeds 0 to pool - 1, the same masks for every run,
in an order drawn from its seed; point clouds: drawn from the run's seed),
``query_sets`` of ``queries`` (``count`` points uniform in the grid's
extent widened by ``margin_m`` on every side, as config #3's source draws
them), ``warmup_steps``, ``check_sampled`` updates drawn from the first
``check_from_first`` (the window's last update is checked too),
``limits`` and, optionally, ``field_metric``: the name under which the
cell reports the time to a fresh field, the mean over all the window's
updates of the card's milliseconds from the update's start to the signed
field's last kernel (CUDA events recorded before the field's call and
after it; the host's clock on the CPU).
"""
from __future__ import annotations

from types import SimpleNamespace

import time

import numpy as np
import torch

from benchmark import scenes
from benchmark.reference import edt as ref_edt
from benchmark.reference import query as ref_query
from sdf_tools_tpu_torch import _build
from sdf_tools_tpu_torch.grid import GridMeta, make_origin_transform
from sdf_tools_tpu_torch.ops.edt import extract_signed_distance_field
from sdf_tools_tpu_torch.ops.query import estimate_distance, gradient
from sdf_tools_tpu_torch.ops.voxelize import voxelize_points


def _field(mask, meta, oob):
    return extract_signed_distance_field(mask, meta, oob_value=oob)[0]


def setup(ctx):
    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    if dev.type == "cuda":
        _build.library()
    n, res = cfg["grid"], cfg["resolution_m"]
    st = SimpleNamespace(n=n, res=res, oob=float(cfg["oob_value"]),
                         meta=GridMeta.create(make_origin_transform([0.0, 0.0, 0.0], device=dev), res, (n,) * 3,
                                              device=dev),
                         field_fn=_field, kept={}, last=None, keep=(),
                         field_metric=tr.get("field_metric"), field_marks=[])
    scene = cfg["scene"]
    if scene["kind"] == "spheres":
        # every seed updates from the same scenes, in its own order
        st.masks = [scenes.device_scene(n, dev, seed=s) for s in range(tr["pool"])]
        st.clouds = None
    elif scene["kind"] == "box_cloud":
        st.clouds = [scenes.box_cloud(scene["boxes"], scene["points_per_box"], n * res, ctx.sub_seed(1, k), dev)
                     for k in range(tr["pool"])]
        st.masks = None
    else:
        raise ValueError(f"unknown scene kind {scene['kind']!r}")
    q = tr["queries"]
    lo, hi = -q["margin_m"], n * res + q["margin_m"]
    st.queries = [scenes.uniform_points(q["count"], lo, hi, ctx.sub_seed(2, k), dev) for k in range(tr["query_sets"])]
    rng = np.random.default_rng(ctx.sub_seed(3))
    st.order = rng.permutation(len(st.masks if st.clouds is None else st.clouds))
    for i in range(max(tr["warmup_steps"], len(st.queries), len(st.order))):
        step(ctx, st, i)
    st.keep = frozenset(int(x) for x in rng.choice(tr["check_from_first"], tr["check_sampled"], replace=False))
    st.kept, st.last, st.field_marks = {}, None, []
    return st


def _mark(dev):
    if dev.type != "cuda":
        return time.perf_counter()
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def _elapsed_ms(a, b):
    return (b - a) * 1e3 if isinstance(a, float) else a.elapsed_time(b)


def step(ctx, st, i):
    span = ctx.tracer.span
    k = int(st.order[i % len(st.order)])
    if st.clouds is not None:
        with span("voxelize"):
            mask = voxelize_points(st.clouds[k], st.meta) > 0.5
    else:
        mask = st.masks[k]
    with span("field"):
        a = _mark(ctx.device) if st.field_metric else None
        sdf = st.field_fn(mask, st.meta, st.oob)
        if a is not None:
            st.field_marks.append((a, _mark(ctx.device)))
    j = i % len(st.queries)
    pts = st.queries[j]
    with span("query"):
        dist, ok = estimate_distance(sdf, pts)
        grad, valid = gradient(sdf, st.meta.location_to_index(pts), enable_edge_gradients=True)
    least = float(torch.where(ok, dist, torch.inf).min())
    st.last = (k, j, sdf.values, dist, ok, grad, valid, least)
    if i in st.keep:
        st.kept[i] = st.last


def end_to_end(ctx, st, lat, window_s):
    out = {ctx.traffic["rate_metric"]: len(lat) / window_s,
           "map_update_ms_p95": float(np.percentile(np.asarray(lat), 95)) * 1e3}
    if st.field_metric:
        # every update of the window; the last one's scalar read has waited for all of them
        out[st.field_metric] = sum(_elapsed_ms(a, b) for a, b in st.field_marks) / len(st.field_marks)
    return out


def reference_mask(st, k):
    """The occupancy of pool entry ``k``, worked out again from the input: a
    sphere mask as made, or the cloud's cells (``floor(p / res)`` in float32,
    in the grid) set."""
    if st.clouds is None:
        return st.masks[k]
    cells = ref_query.cell_index(st.clouds[k], st.res)
    inside = ((cells >= 0) & (cells < st.n)).all(dim=-1)
    mask = torch.zeros((st.n,) * 3, dtype=torch.bool, device=cells.device)
    c = cells[inside]
    mask[c[:, 0], c[:, 1], c[:, 2]] = True
    return mask


def compare(st, entry) -> dict:
    """The compared numbers of one update against the reference."""
    k, j, values, dist, ok, grad, valid, _ = entry
    ref = ref_edt.signed_field(reference_mask(st, k), st.res)
    field_err = float(((values - ref).abs() / ref.abs().clamp(min=st.res)).max())
    if not bool(torch.isfinite(values).all()):
        field_err = float("inf")
    pts = st.queries[j]
    rd, rok = ref_query.estimate_distance(ref, st.res, st.oob, pts)
    # out-of-bounds queries read the oob value on both sides; a query in
    # bounds on one side only is a wrong answer
    dist_err = (dist.to(torch.float64) - rd).abs() / rd.abs().clamp(min=st.res)
    dist_err = torch.where(ok == rok, dist_err, torch.inf)
    rg, rvalid = ref_query.gradient(ref, st.res, ref_query.cell_index(pts, st.res))
    grad_err = (grad.to(torch.float64) - rg).abs().amax(dim=-1)
    grad_err = torch.where(valid == rvalid, grad_err, torch.inf)
    return {
        "field_max_rel_err": field_err,
        "query_dist_max_rel_err": float(dist_err.max()),
        "query_grad_max_abs_err": float(grad_err.max()),
    }


def check(ctx, st):
    limits = ctx.traffic["limits"]
    entries = [st.kept[i] for i in sorted(st.kept)] + [st.last]
    worst = {name: 0.0 for name in limits}
    failed = 0
    for entry in entries:
        got = compare(st, entry)
        failed += any(not (got[name] <= limits[name]) for name in limits)
        for name in limits:
            worst[name] = max(worst[name], got[name]) if got[name] == got[name] else float("inf")
    return [{"name": name, "value": worst[name], "limit": limits[name]} for name in limits], failed


def control(ctx, st):
    """Switch the timed path to the control: the program's own bfloat16
    field (``signed_field_from_masks(..., dtype=torch.bfloat16)``), the step
    below the configuration's float32, queried as the program queries."""
    from sdf_tools_tpu_torch.grid import SdfGrid
    from sdf_tools_tpu_torch.ops.edt import signed_field_from_masks

    def bf16_field(mask, meta, oob):
        return SdfGrid.create(signed_field_from_masks(mask, st.res, dtype=torch.bfloat16)[0], meta, oob)

    st.field_fn = bf16_field
