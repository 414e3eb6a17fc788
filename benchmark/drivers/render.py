"""Forward depth renders of a fixed field in a closed loop with one caller.

Set-up builds the signed field of the sphere scene drawn with
``scene_seed`` (0: BASELINE config #4's own scene) and a pool of ray
bundles: ``azimuths`` evenly spaced views around the grid, ``views_per_call``
to a bundle, interleaved so that each bundle looks from every side (bundle
b holds azimuths b, b + B, b + 2B, ... of the B bundles). Every seed renders
the same bundles, in an order drawn from it. Each call renders the next
bundle with ``render_depth`` and reads the count of hits back to the host.

Traffic parameters: ``scene_seed``, ``azimuths``, ``views_per_call``, ``warmup_steps``,
``check_sampled`` calls drawn from the first ``check_from_first`` (the
window's last call is checked too), ``ray_block`` (rays a reference block)
and ``limits``. The configuration's ``camera`` gives the image size, field
of view, ``t_max_m``, ``max_steps`` and ``eps_m``.
"""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from benchmark import scenes
from benchmark.reference import edt as ref_edt
from benchmark.reference import march as ref_march
from sdf_tools_tpu_torch import _build
from sdf_tools_tpu_torch.grid import GridMeta, make_origin_transform
from sdf_tools_tpu_torch.ops.edt import extract_signed_distance_field
from sdf_tools_tpu_torch.ops.render import render_depth


def _render(st, o, v):
    r = render_depth(st.sdf, o, v, **st.kw)
    return r.depth, r.hit


def setup(ctx):
    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    if dev.type == "cuda":
        _build.library()
    n, res = cfg["grid"], cfg["resolution_m"]
    meta = GridMeta.create(make_origin_transform([0.0, 0.0, 0.0], device=dev), res, (n,) * 3, device=dev)
    mask = scenes.device_scene(n, dev, seed=tr["scene_seed"])
    sdf, _ = extract_signed_distance_field(mask, meta, oob_value=float(cfg["oob_value"]))
    cam = cfg["camera"]
    n_bundles = tr["azimuths"] // tr["views_per_call"]
    az = (360.0 / tr["azimuths"]) * np.arange(tr["azimuths"])
    order = np.random.default_rng(ctx.sub_seed(4)).permutation(n_bundles)
    bundles = [scenes.orbit_rays(n, res, cam["hw"], az[b::n_bundles], cam["fov_deg"], dev) for b in order]
    st = SimpleNamespace(n=n, res=res, oob=float(cfg["oob_value"]), mask=mask, sdf=sdf, bundles=bundles,
                         azimuths=az, kw=scenes.render_kw(cfg), kept={}, last=None, keep=frozenset(),
                         rays_per_call=bundles[0][0].numel() // 3, render_fn=_render)
    for i in range(max(tr["warmup_steps"], len(bundles))):
        step(ctx, st, i)
    rng = np.random.default_rng(ctx.sub_seed(3))
    st.keep = frozenset(int(x) for x in rng.choice(tr["check_from_first"], tr["check_sampled"], replace=False))
    st.kept, st.last = {}, None
    return st


def step(ctx, st, i):
    b = i % len(st.bundles)
    o, v = st.bundles[b]
    with ctx.tracer.span("render"):
        depth, hit = st.render_fn(st, o, v)
    hits = int(hit.sum())
    st.last = (b, depth, hit, hits)
    if i in st.keep:
        st.kept[i] = st.last


def end_to_end(ctx, st, lat, window_s):
    return {"render_rays_per_s": len(lat) * st.rays_per_call / window_s}


def compare(st, entry, ref_values, dtype=torch.float32, block=1 << 20) -> dict:
    """The compared numbers of one call against the reference march."""
    b, depth, hit, _ = entry
    o, v = st.bundles[b]
    rd, rh = ref_march.march_blocks(ref_values, st.res, st.oob, o, v, st.kw | {"t_min": 0.0}, block, dtype)
    both = hit & rh
    err = ((depth - rd).abs() / st.res)[both]
    finite = bool(torch.isfinite(depth).all())
    q = torch.quantile(err.float()[: 1 << 24], torch.tensor([0.5, 0.95, 0.99], device=err.device)) if err.numel() else None
    return {
        "hit_mismatch_share": float((hit != rh).float().mean()) if finite else float("inf"),
        "depth_p95_err_cells": float(q[1]) if q is not None else 0.0,
        "_depth_p50_err_cells": float(q[0]) if q is not None else 0.0,
        "_depth_p99_err_cells": float(q[2]) if q is not None else 0.0,
        "_depth_max_err_cells": float(err.max()) if err.numel() else 0.0,
        "_hits": float(hit.sum()), "_ref_hits": float(rh.sum()),
    }


def check(ctx, st, dtype=torch.float32):
    limits = ctx.traffic["limits"]
    ref_values = ref_edt.signed_field(st.mask, st.res)
    st.sdf = None
    entries = [st.kept[i] for i in sorted(st.kept)] + [st.last]
    worst = {name: 0.0 for name in limits}
    failed, notes = 0, []
    for entry in entries:
        got = compare(st, entry, ref_values, dtype, ctx.traffic["ray_block"])
        notes.append({k: round(x, 6) for k, x in got.items()})
        failed += any(not (got[name] <= limits[name]) for name in limits)
        for name in limits:
            worst[name] = max(worst[name], got[name]) if got[name] == got[name] else float("inf")
    ctx.info["render"] = notes
    return [{"name": name, "value": worst[name], "limit": limits[name]} for name in limits], failed


def control(ctx, st):
    """Switch the timed path to the control: the reference put in the
    program's place, its field and its march in bfloat16, the step below
    the configuration's float32."""
    values = ref_edt.signed_field(st.mask, st.res)

    def bf16_render(st_, o, v):
        return ref_march.march_blocks(values, st_.res, st_.oob, o, v, st_.kw | {"t_min": 0.0},
                                      ctx.traffic["ray_block"], torch.bfloat16)

    st.render_fn = bf16_render
