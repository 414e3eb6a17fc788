"""``correct`` fails where it should: the control (the precision below the
configuration's) and the faults the cells can have, each planted under a
whole run of a fixture cell on the CPU (the harness's look for a card
skipped)."""
from __future__ import annotations

import pytest
import torch

from benchmark import control, run, spec


def _not_correct(checks: dict) -> bool:
    return any(not (c["value"] <= c["limit"]) for c in checks.values())


@pytest.mark.parametrize("cell", ["scene32.map_small", "cloud32.map_small", "scene96.render_small",
                                  "scene32.train_small"])
@pytest.mark.parametrize("seed", [3, 2**33 + 5, 77])
def test_the_control_is_not_correct(small_root, cell, seed):
    r = control.readings(small_root, cell, seed, True, "cpu")
    assert _not_correct(r["checks"]), r


@pytest.mark.parametrize("cell", ["scene32.map_small", "scene96.render_small", "scene32.train_small"])
def test_sound_readings_pass(small_root, cell):
    r = control.readings(small_root, cell, 41, False, "cpu")
    assert not _not_correct(r["checks"]), r


def _driver(root, cell):
    sp = spec.Spec(root)
    return sp.driver(sp.traffic(sp.cell(cell))["driver"])


def _run(root, cell):
    return run.run_cell(root, cell, 9, 0.2, False, "cpu")


def test_map_answer_altered(small_root, monkeypatch):
    drv = _driver(small_root, "scene32.map_small")
    real = drv.estimate_distance

    def altered(sdf, pts):
        d, ok = real(sdf, pts)
        return d * torch.where(torch.arange(d.numel()) == 7, 1.001, 1.0), ok

    monkeypatch.setattr(drv, "estimate_distance", altered)
    assert _run(small_root, "scene32.map_small")["correct"] is False


@pytest.mark.parametrize("cell", ["scene32.map_small", "cloud32.map_small"])
def test_map_half_the_batch_left_out(small_root, monkeypatch, cell):
    drv = _driver(small_root, cell)
    real_d, real_g = drv.estimate_distance, drv.gradient

    def half_d(sdf, pts):
        h = pts.shape[0] // 2
        d, ok = real_d(sdf, pts[:h])
        return torch.cat([d, d])[: pts.shape[0]], torch.cat([ok, ok])[: pts.shape[0]]

    def half_g(sdf, idx, **kw):
        h = idx.shape[0] // 2
        g, v = real_g(sdf, idx[:h], **kw)
        return torch.cat([g, g])[: idx.shape[0]], torch.cat([v, v])[: idx.shape[0]]

    monkeypatch.setattr(drv, "estimate_distance", half_d)
    monkeypatch.setattr(drv, "gradient", half_g)
    assert _run(small_root, cell)["correct"] is False


def test_field_answer_altered(small_root, monkeypatch):
    drv = _driver(small_root, "cloud32.map_small")
    real = drv.extract_signed_distance_field

    def altered(mask, meta, oob_value):
        sdf, ext = real(mask, meta, oob_value=oob_value)
        sdf.values.view(-1)[11] += 0.01
        return sdf, ext

    monkeypatch.setattr(drv, "extract_signed_distance_field", altered)
    assert _run(small_root, "cloud32.map_small")["correct"] is False


def test_render_answer_altered(small_root, monkeypatch):
    drv = _driver(small_root, "scene96.render_small")
    real = drv.render_depth

    def altered(sdf, o, v, **kw):
        r = real(sdf, o, v, **kw)
        depth = r.depth.clone()
        depth[0] = torch.where(r.hit[0], depth[0] * 1.01, depth[0])
        return r._replace(depth=depth)

    monkeypatch.setattr(drv, "render_depth", altered)
    assert _run(small_root, "scene96.render_small")["correct"] is False


def test_render_half_the_batch_left_out(small_root, monkeypatch):
    drv = _driver(small_root, "scene96.render_small")
    real = drv.render_depth

    def half(sdf, o, v, **kw):
        h = o.shape[0] // 2
        r = real(sdf, o[:h], v[:h], **kw)
        miss_d = torch.full_like(r.depth, kw["t_max"])
        return r._replace(depth=torch.cat([r.depth, miss_d]), hit=torch.cat([r.hit, torch.zeros_like(r.hit)]))

    monkeypatch.setattr(drv, "render_depth", half)
    assert _run(small_root, "scene96.render_small")["correct"] is False


def test_train_state_unchanged(small_root, monkeypatch):
    drv = _driver(small_root, "scene32.train_small")
    real = drv._program_step

    def unchanged(ctx, st, logits, view):
        loss, _ = real(ctx, st, logits, view)
        return loss, logits

    monkeypatch.setattr(drv, "_program_step", unchanged)
    assert _run(small_root, "scene32.train_small")["correct"] is False


def test_train_half_the_batch_left_out(small_root, monkeypatch):
    drv = _driver(small_root, "scene32.train_small")

    def half(ctx, st, logits, view):
        o, v = st.rays[view]
        h = o.shape[0] // 2
        lg = logits.detach().requires_grad_(True)
        values = drv.sdf_from_occupancy_ft(torch.sigmoid(lg), st.res)
        r = drv.render_depth(drv.SdfGrid.create(values, st.meta, st.oob), o[:h], v[:h], **st.kw)
        loss = ((r.depth - st.targets[view][:h]) ** 2).mean()
        loss.backward()
        return loss.detach(), (logits - st.lr * lg.grad).detach()

    monkeypatch.setattr(drv, "_program_step", half)
    assert _run(small_root, "scene32.train_small")["correct"] is False


def test_train_gradient_altered(small_root, monkeypatch):
    drv = _driver(small_root, "scene32.train_small")
    real = drv._program_step

    def altered(ctx, st, logits, view):
        loss, new = real(ctx, st, logits, view)
        return loss, logits + (new - logits) * 1.2

    monkeypatch.setattr(drv, "_program_step", altered)
    assert _run(small_root, "scene32.train_small")["correct"] is False
