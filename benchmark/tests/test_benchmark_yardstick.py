"""The yardstick: the frozen generators, the byte counts, the trace's
reduction and the plain references on hand cases."""
from __future__ import annotations

import ast
import itertools
import math
import subprocess
import sys

import numpy as np
import pytest
import torch
from conftest import BENCH, ROOT

from benchmark import scenes, trace, work
from benchmark.reference import edt as ref_edt
from benchmark.reference import march as ref_march
from benchmark.reference import query as ref_query
from benchmark.reference import train as ref_train


# ---- generators -------------------------------------------------------------


@pytest.mark.parametrize("n,seed", [(8, 0), (24, 3), (33, 2**40 + 1)])
def test_scene_is_bitwise_the_ports_make_scene(n, seed):
    from sdf_tools_tpu_torch.scripts import _scenes

    want = _scenes.make_scene(n, seed)
    assert np.array_equal(scenes.device_scene(n, "cpu", seed=seed).numpy(), want)
    assert np.array_equal(scenes.device_scene(n, "cpu", seed=seed, chunk=5).numpy(), want)


def test_sub_seeds_are_fixed_and_distinct():
    big = 2**33 + 12345
    assert scenes.sub_seed(big, 1, 0) == scenes.sub_seed(big, 1, 0)
    seeds = {scenes.sub_seed(s, p, k) for s in (0, 1, big) for p in (1, 2) for k in range(4)}
    assert len(seeds) == 24 and all(0 <= s < 2**63 for s in seeds)


def test_generators_repeat_from_their_seed():
    a = scenes.uniform_points(60, -0.1, 5.22, 9, "cpu")
    assert a.shape == (60, 3) and torch.equal(a, scenes.uniform_points(60, -0.1, 5.22, 9, "cpu"))
    assert bool(((a >= -0.1) & (a < 5.22)).all()) and not torch.equal(a, scenes.uniform_points(60, -0.1, 5.22, 8, "cpu"))
    cloud = scenes.box_cloud([[0.2, 0.5], [0.6, 0.9]], 100, 5.12, 4, "cpu")
    assert cloud.shape == (200, 3)
    assert bool(((cloud[:100] >= 0.2 * 5.12) & (cloud[:100] <= 0.5 * 5.12)).all())
    az = scenes.view_azimuths(8, 3)
    assert sorted(az.tolist()) == [45.0 * k for k in range(8)]


def test_orbit_rays_are_the_ports_camera_at_azimuth_zero():
    from sdf_tools_tpu_torch.ops.render import camera_rays
    from sdf_tools_tpu_torch.scripts.validate_baseline import bench_camera

    o, v = scenes.orbit_rays(64, 0.05, 16, [0.0], 50.0, "cpu")
    wo, wv = camera_rays(**bench_camera(64, 0.05, 16), device="cpu")
    assert torch.allclose(o[0], wo, atol=1e-6) and torch.allclose(v[0], wv, atol=1e-6)


# ---- byte counts and traces -------------------------------------------------


def test_field_bytes_count_the_work():
    assert work.field_bytes((512, 512, 512)) == 5 * 512**3
    assert work.field_bound_s((256, 256, 256)) == pytest.approx(5 * 256**3 / 3.35e12)


def _ev(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": 1, "args": args}


def test_trace_reduction_attributes_by_launch_and_merges_busy_time():
    events = [
        _ev("user_annotation", trace.WINDOW, 0, 1000),
        _ev("user_annotation", "field", 10, 100),
        _ev("user_annotation", "query", 200, 100),
        _ev("cuda_runtime", "cudaLaunchKernel", 20, 5, correlation=1),
        _ev("cuda_runtime", "cudaLaunchKernel", 30, 5, correlation=2),
        _ev("cuda_runtime", "cudaLaunchKernel", 250, 5, correlation=3),
        _ev("cpu_op", "aten::item", 400, 300),
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 100, "dur": 100, "tid": 7, "args": {"correlation": 1}},
        {"ph": "X", "cat": "kernel", "name": "k2", "ts": 150, "dur": 100, "tid": 7, "args": {"correlation": 2}},
        {"ph": "X", "cat": "kernel", "name": "k3", "ts": 300, "dur": 50, "tid": 7, "args": {"correlation": 3}},
        {"ph": "X", "cat": "kernel", "name": "k4", "ts": 500, "dur": 10, "tid": 7, "args": {"correlation": 99}},
    ]
    s = trace.reduce_events(events)
    assert s.span_s == pytest.approx({"field": 200e-6, "query": 50e-6})
    assert s.busy_s == pytest.approx((150 + 50 + 10) * 1e-6)
    assert s.window_s == pytest.approx(1e-3)
    assert s.unmatched_s == pytest.approx(10e-6)
    assert dict(s.device_ops) == pytest.approx({"k1": 100e-6, "k2": 100e-6, "k3": 50e-6, "k4": 10e-6})
    # gaps [0, 100], [350, 500] with no host op, [250, 300] in a launch, [510, 1000] in a host read
    assert dict(s.idle_gaps) == pytest.approx({"no span/python": 250e-6, "query/cudaLaunchKernel": 50e-6,
                                               "no span/aten::item": 490e-6})


# ---- references -------------------------------------------------------------


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = [a.name for a in node.names] if isinstance(node, ast.Import) else \
                [node.module or ""] if isinstance(node, ast.ImportFrom) and node.level == 0 else []
            for name in names:
                assert name.split(".")[0] not in ("sdf_tools_tpu_torch", "sdf_tools_tpu", "jax", "benchmark"), path
    code = ("import sys; import benchmark.reference.edt, benchmark.reference.query, benchmark.reference.march, "
            "benchmark.reference.train; print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('sdf_tools_tpu_torch', 'sdf_tools_tpu', 'jax')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "[]", out.stderr


def _brute_d2(seeds: np.ndarray) -> np.ndarray:
    pts = np.argwhere(seeds)
    grid = np.stack(np.meshgrid(*[np.arange(s) for s in seeds.shape], indexing="ij"), -1)
    d2 = ((grid[..., None, :] - pts[None, None, None]) ** 2).sum(-1)
    return d2.min(-1)


def test_squared_edt_by_hand():
    seeds = torch.zeros((5, 6, 7), dtype=torch.bool)
    seeds[1, 2, 3] = True
    d2 = ref_edt.squared_edt(seeds, block_elems=64)
    i, j, k = np.meshgrid(np.arange(5), np.arange(6), np.arange(7), indexing="ij")
    assert np.array_equal(d2.numpy(), ((i - 1) ** 2 + (j - 2) ** 2 + (k - 3) ** 2).astype(np.float32))
    assert bool(torch.isinf(ref_edt.squared_edt(torch.zeros((3, 3, 3), dtype=torch.bool))).all())
    rng = np.random.default_rng(0)
    for _ in range(3):
        m = rng.random((6, 7, 5)) < 0.1
        m[0, 0, 0] = True
        assert np.array_equal(ref_edt.squared_edt(torch.as_tensor(m)).numpy(), _brute_d2(m).astype(np.float32))


def test_signed_field_and_feature_transform_by_hand():
    m = torch.zeros((6, 6, 6), dtype=torch.bool)
    m[2:4, 2:4, 2:4] = True
    f = ref_edt.signed_field(m, 0.5)
    assert float(f[0, 2, 2]) == 1.0 and float(f[2, 2, 2]) == -0.5 and float(f[0, 0, 0]) == pytest.approx(
        0.5 * math.sqrt(12), rel=1e-7)
    d2, feat = ref_edt.feature_transform(m)
    assert torch.equal(d2, ref_edt.squared_edt(m))
    nx, ny, nz = m.shape
    fx, fy, fz = feat // (ny * nz), (feat // nz) % ny, feat % nz
    idx = torch.stack(torch.meshgrid(*[torch.arange(s) for s in m.shape], indexing="ij"), -1)
    back = ((idx - torch.stack([fx, fy, fz], -1)) ** 2).sum(-1).float()
    assert torch.equal(back, d2) and bool(m.reshape(-1)[feat.reshape(-1)].all())


def test_queries_by_hand():
    values = torch.arange(4 * 4 * 4, dtype=torch.float32).reshape(4, 4, 4) * 0.1 + 1.0  # all free
    res = 0.5
    centre = torch.tensor([[1.25, 0.75, 1.75]])  # the centre of cell (2, 1, 3)
    d, ok = ref_query.estimate_distance(values, res, -7.0, centre)
    assert bool(ok[0]) and float(d[0]) == pytest.approx(float(values[2, 1, 3]) - 0.25, abs=1e-6)
    d, ok = ref_query.estimate_distance(values, res, -7.0, torch.tensor([[2.1, 0.1, 0.1], [float("nan"), 0, 0]]))
    assert not bool(ok.any()) and d.tolist() == [-7.0, -7.0]
    g, valid = ref_query.gradient(values, res, torch.tensor([[1, 1, 1], [0, 3, 2], [4, 0, 0]]))
    assert valid.tolist() == [True, True, False]
    # the field rises by 1.6 a cell along x, 0.4 along y, 0.1 along z
    assert torch.allclose(g[:2], torch.tensor([[3.2, 0.8, 0.2]] * 2, dtype=torch.float64), atol=1e-5)


def test_march_hits_a_sphere_where_geometry_says():
    n, res = 48, 0.1
    idx = torch.stack(torch.meshgrid(*[torch.arange(n)] * 3, indexing="ij"), -1).double()
    mask = ((idx + 0.5 - n / 2) ** 2).sum(-1) <= 10.0**2
    values = ref_edt.signed_field(mask, res)
    o = torch.tensor([[-3.0, 2.4, 2.4], [-3.0, 0.2, 0.2]])
    v = torch.tensor([[1.0, 0.0, 0.0], [1.0, 0.0, 0.0]])
    depth, hit = ref_march.march(values, res, 1e3, o, v, 0.0, 20.0, 1e-3, 64)
    assert hit.tolist() == [True, False]
    assert float(depth[0]) == pytest.approx(3.0 + 2.4 - 1.0, abs=0.75 * res)


def test_training_step_gradient_routes_every_pixel_once():
    n, res = 32, 0.1
    mask = scenes.device_scene(n, "cpu", seed=1)
    logits = torch.where(mask, 3.0, -3.0)
    o, v = scenes.orbit_rays(n, res, 16, [30.0], 50.0, "cpu")
    kw = dict(t_max=4 * n * res, max_steps=64, eps=1e-3)
    target = ref_march.march_blocks(ref_edt.signed_field(mask, res), res, 1e3, o[0], v[0], kw | {"t_min": 0.0})[0]
    loss, grad, new = ref_train.step(logits, target + 0.05, o[0], v[0], res, 1e3, kw, 1.0)
    assert float(loss) == pytest.approx(0.05**2, rel=1e-3)
    assert float(grad.abs().sum()) > 0 and torch.equal(new, logits - grad)
    field = ref_train.Field(mask, res, torch.float32)
    g = torch.zeros((n, n, n))
    cells = list(itertools.islice(zip(*torch.nonzero(~mask, as_tuple=True)), 3))
    for c in cells:
        g[c] = 1.0
    d_occ = field.backward(g, res)
    assert float(d_occ.sum()) == pytest.approx(-2 * res * len(cells), rel=1e-6)
    assert bool(mask.reshape(-1)[torch.nonzero(d_occ.reshape(-1)).reshape(-1)].all())


def test_idle_share_sets_device_busy_against_the_untraced_wall_time():
    from benchmark.run import ReadContext

    summary = trace.TraceSummary({}, busy_s=0.3, window_s=2.0, device_ops=[], idle_gaps=[], unmatched_s=0.0,
                                 n_device_ops=1)
    # 10 traced steps of 30 ms busy each; untraced, 40 steps in 2 s: 50 ms a step
    rc = ReadContext(summary, 10, {}, untraced_steps=40, untraced_s=2.0)
    assert trace.idle_share(rc) == pytest.approx(1 - 0.03 / 0.05)
    assert trace.idle_share(ReadContext(summary, 10, {})) is None



def test_host_readers_take_the_steps_before_the_profiler():
    from benchmark import spec
    from benchmark.run import ReadContext

    rate = spec.load_module(BENCH / "metrics" / "host_updates_per_s.map.py", "_t_host_rate")
    p95 = spec.load_module(BENCH / "metrics" / "host_update_ms_p95.map.py", "_t_host_p95")
    # 100 untraced updates over 2 s, 95 of 10 ms and 5 of 200 ms
    lat = [0.01] * 95 + [0.2] * 5
    rc = ReadContext(None, 10, {}, untraced_steps=100, untraced_s=2.0, untraced_lat=lat)
    assert rate.read(rc) == pytest.approx(50.0)
    assert p95.read(rc) == pytest.approx(float(np.percentile(lat, 95)) * 1e3)
    # a window traced from its start has nothing to read
    assert rate.read(ReadContext(None, 10, {})) is None and p95.read(ReadContext(None, 10, {})) is None

def test_host_note_reads_the_drift_inside_a_window():
    from benchmark import host

    note = host.window_note([0.01] * 6 + [0.02] * 6, 1.5)
    assert note["step_ms_median_by_sixth"] == [10.0, 10.0, 10.0, 20.0, 20.0, 20.0]
    assert note["reference_s_left_out_of_setup"] == 1.5 and host.window_note([], 0.0)["steps"] == 0
