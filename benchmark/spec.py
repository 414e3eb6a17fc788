"""Finding a cell's parts by name.

``BENCHMARK.json`` at the checkout's root lists the cells, configurations
and metrics. Everything that belongs to one of them is a file of its own,
found by its name:

* a configuration: the JSON file its entry names under ``file``;
* a traffic mix: ``benchmark/traffic/<traffic>.json``, whose ``driver``
  names the general driver that reads it, ``benchmark/drivers/<driver>.py``;
* a per-layer metric: its reader, ``benchmark/metrics/<name>.py``.

So a later cell, configuration or metric is new files plus new entries in
``BENCHMARK.json``, and no edit to a file that is already there.
"""
from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = "benchmark"


class Spec:
    """``BENCHMARK.json`` of the checkout at ``root``, and lookups by name."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.bench = json.loads((self.root / "BENCHMARK.json").read_text())
        self.dir = self.root / PACKAGE

    def cell(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, cell: dict) -> dict:
        for c in self.bench["configs"]:
            if c["name"] == cell["config"]:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no config {cell['config']!r} in BENCHMARK.json")

    def traffic(self, cell: dict) -> dict:
        return json.loads((self.dir / "traffic" / f"{cell['traffic']}.json").read_text())

    def end_to_end(self, cell_name: str) -> list:
        """The end-to-end metrics a cell reports (``setup_s`` in every one)."""
        return [m for m in self.bench["end_to_end"] if cell_name in m.get("workloads", [cell_name])]

    def per_layer(self, cell_name: str) -> list:
        """The per-layer metrics read in a cell's traced run: those that list
        it, and those without a list whose moved metric the cell reports."""
        e2e = {m["name"] for m in self.end_to_end(cell_name)}
        out = []
        for m in self.bench["per_layer"]:
            if "workloads" in m:
                if cell_name in m["workloads"]:
                    out.append(m)
            elif m["moves"] in e2e:
                out.append(m)
        return out

    def driver(self, name: str):
        return load_module(self.dir / "drivers" / f"{name}.py", f"_bench_driver_{name}")

    def reader(self, name: str):
        return load_module(self.dir / "metrics" / f"{name}.py", f"_bench_metric_{name}")


def load_module(path: Path, module_name: str):
    """Import the Python file ``path`` (a name may hold dots, as
    ``idle_share.map`` does, so it is loaded by path)."""
    if module_name in sys.modules and getattr(sys.modules[module_name], "__file__", None) == str(path):
        return sys.modules[module_name]
    spec = importlib.util.spec_from_file_location(module_name, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[module_name] = mod
    spec.loader.exec_module(mod)
    return mod
