"""BASELINE config #4's training step in a closed loop: pixel gradients
with respect to occupancy, through the feature-transform field and the
render's implicit-function backward, and SGD on the logits.

Set-up takes the target scene drawn with ``scene_seed`` (0: BASELINE
config #4's own scene) and ``views`` evenly spaced camera azimuths in an
order drawn from the seed, renders
each view's target depth with the reference march (an input the benchmark
makes; its seconds, ``reference_s``, are left out of ``setup_s``), and starts the logits at +-``logit`` on the target's mask shifted
``shift_cells`` along x (``chip_smoke.py``'s pattern). One object, the
logits with the step, is then driven through its first ``first_steps``
steps by the window's own call, each on the next view, and handed to the
window. Each step: sigmoid -> ``sdf_from_occupancy_ft`` -> ``render_depth``
(``backend`` as the traffic's ``render_backend`` names it) -> mean squared
depth error -> backward -> SGD, ending with the loss read to the host.

The check follows the first steps with the reference (``reference/train.py``)
from the same initial logits: each step's loss, the first gradient's norm
(worked out from the logits after one step) and the norm of the change
after the first steps.
"""
from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch

from benchmark import scenes
from benchmark.reference import edt as ref_edt
from benchmark.reference import march as ref_march
from benchmark.reference import train as ref_train
from sdf_tools_tpu_torch import _build
from sdf_tools_tpu_torch.grid import GridMeta, SdfGrid, make_origin_transform
from sdf_tools_tpu_torch.ops.diff import sdf_from_occupancy_ft
from sdf_tools_tpu_torch.ops.render import render_depth


def _program_step(ctx, st, logits, view):
    """The program's step from ``logits`` on view ``view``: (loss, new logits)."""
    span = ctx.tracer.span
    o, v = st.rays[view]
    lg = logits.detach().requires_grad_(True)
    with span("ft_field"):
        values = sdf_from_occupancy_ft(torch.sigmoid(lg), st.res)
    with span("render"):
        r = render_depth(SdfGrid.create(values, st.meta, st.oob), o, v, backend=st.backend, **st.kw)
    with span("backward"):
        loss = ((r.depth - st.targets[view]) ** 2).mean()
        loss.backward()
        with torch.no_grad():
            new = logits - st.lr * lg.grad
    return loss.detach(), new


def setup(ctx):
    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    if dev.type == "cuda":
        _build.library()
    n, res, oob = cfg["grid"], cfg["resolution_m"], float(cfg["oob_value"])
    meta = GridMeta.create(make_origin_transform([0.0, 0.0, 0.0], device=dev), res, (n,) * 3, device=dev)
    cam, trn = cfg["camera"], cfg["train"]
    st = SimpleNamespace(n=n, res=res, oob=oob, meta=meta, kw=scenes.render_kw(cfg), lr=float(trn["lr"]),
                         step_fn=_program_step, losses=[], backend=tr["render_backend"])
    mask = scenes.device_scene(n, dev, seed=tr["scene_seed"])
    az = scenes.view_azimuths(tr["views"], ctx.sub_seed(4))
    st.rays = [tuple(x[0] for x in scenes.orbit_rays(n, res, cam["hw"], [a], cam["fov_deg"], dev)) for a in az]
    ctx.sync()
    t_ref = time.perf_counter()
    values = ref_edt.signed_field(mask, res)
    st.targets = [ref_march.march_blocks(values, res, oob, o, v, st.kw | {"t_min": 0.0}, tr["ray_block"])[0]
                  for o, v in st.rays]
    del values
    ctx.sync()
    st.reference_s = time.perf_counter() - t_ref
    shifted = torch.zeros_like(mask)
    s = int(trn["shift_cells"])
    shifted[s:] = mask[:-s]
    del mask
    st.logits0 = torch.where(shifted, float(trn["logit"]), -float(trn["logit"]))
    del shifted
    first_steps(ctx, st)
    return st


def first_steps(ctx, st):
    """Drive the state from the initial logits through the first steps,
    keeping what the check compares."""
    first = ctx.traffic["first_steps"]
    st.logits, st.losses, st.after = st.logits0, [], {}
    for i in range(first):
        loss, st.logits = st.step_fn(ctx, st, st.logits, i % len(st.rays))
        st.losses.append(float(loss))
        if i + 1 in (1, first):
            st.after[i + 1] = st.logits
    st.next = first


def step(ctx, st, i):
    loss, st.logits = st.step_fn(ctx, st, st.logits, st.next % len(st.rays))
    st.next += 1
    float(loss)


def end_to_end(ctx, st, lat, window_s):
    return {"train_step_ms": 1e3 * window_s / len(lat)}


def readings(st, first: int, dtype=torch.float32, block_elems=ref_edt.BLOCK_ELEMS, ray_block: int = 1 << 20) -> dict:
    """The reference's first steps from the same logits, and the gaps."""
    lg = st.logits0
    ref_losses, ref_after, ref_g1 = [], {}, None
    for i in range(first):
        view = i % len(st.rays)
        o, v = st.rays[view]
        loss, grad, lg = ref_train.step(lg, st.targets[view], o, v, st.res, st.oob, st.kw, st.lr, dtype,
                                        block_elems, ray_block)
        ref_losses.append(float(loss))
        if i == 0:
            ref_g1 = grad.to(torch.float32)
        if i + 1 == first:
            ref_after[first] = lg.to(torch.float32)
        del grad
    g1 = (st.logits0 - st.after[1]) / st.lr
    d_prog = st.after[first] - st.logits0
    d_ref = ref_after[first] - st.logits0

    def gap(a, b):
        na, nb = float(a.double().norm()), float(b.double().norm())
        return abs(na - nb) / nb if nb > 0 else float("inf")

    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(st.losses, ref_losses))
    return {"loss_max_rel_gap": loss_gap, "grad1_norm_rel_gap": gap(g1, ref_g1),
            "change_norm_rel_gap": gap(d_prog, d_ref),
            "_losses": st.losses, "_ref_losses": ref_losses,
            "_grad1_norm": float(g1.double().norm()), "_ref_grad1_norm": float(ref_g1.double().norm())}


def check(ctx, st):
    limits = ctx.traffic["limits"]
    st.logits = None
    got = readings(st, ctx.traffic["first_steps"], block_elems=ctx.traffic.get("block_elems", ref_edt.BLOCK_ELEMS),
                   ray_block=ctx.traffic["ray_block"])
    ctx.info["train"] = {k: x for k, x in got.items()}
    failed = int(any(not (got[name] <= limits[name]) for name in limits))
    return [{"name": name, "value": got[name] if got[name] == got[name] else float("inf"), "limit": limits[name]}
            for name in limits], failed


def control(ctx, st):
    """Put the reference, in bfloat16, in the program's place and drive the
    first steps again from the initial logits."""

    def bf16_step(ctx_, st_, logits, view):
        o, v = st_.rays[view]
        loss, _, new = ref_train.step(logits, st_.targets[view], o, v, st_.res, st_.oob, st_.kw, st_.lr,
                                      torch.bfloat16, ray_block=ctx_.traffic["ray_block"])
        return loss.float(), new.float()

    st.step_fn = bf16_step
    first_steps(ctx, st)


def fault(ctx, st, name: str):
    """Plant one of the faults a training step can have and drive the first
    steps again: ``half_batch`` (the loss's mean over the first half of the
    image rows, the rest left out) or ``unchanged`` (the step returns its
    state as it was)."""

    def half_batch(ctx_, st_, logits, view):
        o, v = st_.rays[view]
        h = o.shape[0] // 2
        lg = logits.detach().requires_grad_(True)
        values = sdf_from_occupancy_ft(torch.sigmoid(lg), st_.res)
        r = render_depth(SdfGrid.create(values, st_.meta, st_.oob), o[:h], v[:h], backend=st_.backend, **st_.kw)
        loss = ((r.depth - st_.targets[view][:h]) ** 2).mean()
        loss.backward()
        return loss.detach(), (logits - st_.lr * lg.grad).detach()

    def unchanged(ctx_, st_, logits, view):
        loss, _ = _program_step(ctx_, st_, logits, view)
        return loss, logits

    st.step_fn = {"half_batch": half_batch, "unchanged": unchanged}[name]
    first_steps(ctx, st)
