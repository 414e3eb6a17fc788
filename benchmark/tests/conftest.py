"""Fixtures of the benchmark's CPU tests: a copy of the benchmark's files
beside fixture cells at small sizes, found by name like any other cell.

Tests that need a CUDA card take the ``card`` fixture, which skips them
where there is none (decided when the test runs, never at import)."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

# fixture cells: (name, config, traffic, base cell), each config and traffic a new file
SMALL = {
    "scene32": ("scene512", {"grid": 32, "camera": {"hw": 32, "fov_deg": 50.0, "t_max_m": 6.4, "max_steps": 64,
                                                    "eps_m": 0.001},
                             "train": {"logit": 3.0, "shift_cells": 2, "lr": 1000.0}}),
    "scene96": ("scene512", {"grid": 96, "camera": {"hw": 32, "fov_deg": 50.0, "t_max_m": 19.2, "max_steps": 64,
                                                    "eps_m": 0.001}}),
    "cloud32": ("cloud256", {"grid": 32, "resolution_m": 0.05, "scene": {"kind": "box_cloud",
                                                                       "boxes": [[0.2, 0.5], [0.6, 0.9]],
                                                                       "points_per_box": 300}}),
}
TRAFFIC = {
    "map_small": ("map", {"pool": 2, "query_sets": 2, "warmup_steps": 2, "check_from_first": 2}),
    "cloud_map_small": ("cloud_map", {"pool": 2, "query_sets": 2, "warmup_steps": 2, "check_from_first": 2}),
    "render_small": ("render", {"azimuths": 4, "views_per_call": 2, "warmup_steps": 1, "check_from_first": 2}),
    "train_small": ("train", {"views": 2}),
}
FIXTURE_METRIC = "traced_steps.fixture"
CELLS = {
    "scene32.map_small": ("scene32", "map_small", "scene512.map"),
    "cloud32.map_small": ("cloud32", "cloud_map_small", "cloud256.map"),
    "scene32.render_small": ("scene32", "render_small", "scene512.render"),
    "scene96.render_small": ("scene96", "render_small", "scene512.render"),
    "scene32.train_small": ("scene32", "train_small", "scene512.train"),
}


def make_root(dest: Path) -> Path:
    """A checkout at ``dest``: ``BENCHMARK.json`` and the benchmark's files,
    plus the fixture cells as new files and new entries only."""
    shutil.copytree(BENCH, dest / "benchmark", ignore=shutil.ignore_patterns("tests", "__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for name, (base, changes) in SMALL.items():
        entry = next(c for c in bench["configs"] if c["name"] == base)
        cfg = json.loads((ROOT / entry["file"]).read_text())
        cfg.update(changes, name=name)
        path = f"benchmark/configs/{name}.json"
        (dest / path).write_text(json.dumps(cfg))
        bench["configs"].append(dict(entry, name=name, file=path))
    for name, (base, changes) in TRAFFIC.items():
        tr = json.loads((BENCH / "traffic" / f"{base}.json").read_text())
        tr.update(changes)
        (dest / "benchmark" / "traffic" / f"{name}.json").write_text(json.dumps(tr))
    for name, (cfg, traffic, base) in CELLS.items():
        bench["workloads"].append(dict(next(w for w in bench["workloads"] if w["name"] == base),
                                       name=name, config=cfg, traffic=traffic))
        for m in bench["end_to_end"] + bench["per_layer"]:
            if base in m.get("workloads", []):
                m["workloads"].append(name)
    # a per-layer metric added as its reader and an entry: the traced steps
    (dest / "benchmark" / "metrics" / f"{FIXTURE_METRIC}.py").write_text(
        "def read(rc):\n    return float(rc.steps)\n")
    bench["per_layer"].append({"name": FIXTURE_METRIC, "unit": "steps", "better": "higher",
                               "source": "program_counter", "layer": "device", "moves": "map_field_ms",
                               "workloads": ["scene32.map_small"]})
    (dest / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return dest


@pytest.fixture(scope="session")
def small_root(tmp_path_factory) -> Path:
    return make_root(tmp_path_factory.mktemp("checkout"))


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skipped without one)")
