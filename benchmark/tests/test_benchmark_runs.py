"""Whole runs of the fixture cells on the CPU (the harness's look for a
card skipped), the result's last line, and what a run may hold."""
from __future__ import annotations

import json
import subprocess
import sys
import textwrap

import pytest
from conftest import CELLS, FIXTURE_METRIC, ROOT, make_root

from benchmark import run

KEYS = ["correct", "attempted", "failed", "metrics", "device"]
DEVICE_KEYS = {"platform", "kind", "count", "memory_peak_bytes"}


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_untraced_run_reports_its_end_to_end_metrics(small_root, cell):
    r = run.run_cell(small_root, cell, 2**33 + 11, 0.3, False, "cpu")
    assert list(r)[: len(KEYS)] == KEYS and list(r)[-1] == "checks"
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    assert DEVICE_KEYS <= set(r["device"])
    bench = json.loads((small_root / "BENCHMARK.json").read_text())
    want = {m["name"] for m in bench["end_to_end"] if cell in m.get("workloads", [cell])}
    assert set(r["metrics"]) == want and "setup_s" in want
    for m in r["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    for c in r["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]


def test_traced_run_has_the_window_and_a_breakdown(small_root):
    r = run.run_cell(small_root, "scene32.map_small", 7, 0.3, True, "cpu")
    assert {"busy_s", "window_s"} <= set(r["device"]) and r["device"]["window_s"] > 0
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert all(len(v) <= 10 for v in r["breakdown"].values())
    # the CPU has no device trace, so no device metric reads anything; the
    # fixture's own metric, added as a file and an entry, is found and read
    assert list(r["metrics"]) == [FIXTURE_METRIC] and r["metrics"][FIXTURE_METRIC]["value"] >= 1
    assert list(r)[-1] == "checks"


def test_same_seed_same_inputs(small_root):
    a = run.run_cell(small_root, "scene32.render_small", 123, 0.2, False, "cpu")["checks"]
    b = run.run_cell(small_root, "scene32.render_small", 123, 0.2, False, "cpu")["checks"]
    assert a == b


def test_without_a_card_the_command_prints_no_result(capsys, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "scene512.map", "--seed", "1", "--seconds", "1", "--trace", "0"]) == 2
    assert capsys.readouterr().out == ""


def test_forbidden_modules_compare_whole_top_level_names():
    assert run.forbidden_modules(["sdf_tools_tpu_torch", "sdf_tools_tpu_torch.ops.edt", "jaxtyping", "numpy"]) == []
    assert run.forbidden_modules(["sdf_tools_tpu.ops.edt", "jaxlib.xla_client", "flax", "jax"]) == [
        "flax", "jax", "jaxlib", "sdf_tools_tpu"]


def test_a_run_loads_no_jax_and_no_jax_package(tmp_path):
    root = make_root(tmp_path)
    code = textwrap.dedent(f"""
        import sys
        from pathlib import Path
        from benchmark import run
        for cell in {sorted(CELLS)!r}:
            run.run_cell(Path({str(root)!r}), cell, 5, 0.2, cell.endswith("map_small"), "cpu")
        print(sorted({{m.split(".")[0] for m in sys.modules}} & {{"jax", "jaxlib", "flax", "sdf_tools_tpu"}}))
        print("sdf_tools_tpu_torch" in sys.modules)
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert lines[-2:] == ["[]", "True"]


def test_a_checkout_of_the_benchmark_alone_gives_no_result(tmp_path):
    root = make_root(tmp_path)
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "scene512.map", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=root, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.card
def test_a_cell_on_the_card(card):
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "scene512.map", "--seed", "3",
                          "--seconds", "2", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] is True and r["device"]["platform"] == "gpu"


def test_traced_run_profiles_the_end_of_the_window(small_root, monkeypatch, capsys):
    from benchmark import trace

    monkeypatch.setattr(trace, "TRACE_SECONDS", 0.2)
    r = run.run_cell(small_root, "scene32.map_small", 8, 0.6, True, "cpu")
    line = next(x for x in capsys.readouterr().err.splitlines() if x.startswith("trace:"))
    before, under = line.split("host ms a step ")[1].split(" before the profiler, ")
    assert float(before) > 0 and float(under.split(" under it")[0]) > 0
    assert 0.2 <= r["device"]["window_s"] < 0.6
