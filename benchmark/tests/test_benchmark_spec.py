"""BENCHMARK.json against the benchmark's contract, and every cell's parts
found by name from files."""
from __future__ import annotations

import json
import re

import pytest
from conftest import BENCH, ROOT

from benchmark import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT_MAX = 200
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
WIDTHS = ("hidden", "intermediate", "latent", "state", "projection", "head", "expansion", "experts_per_token")


@pytest.fixture(scope="module")
def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _text(s):
    return isinstance(s, str) and 1 <= len(s) <= TEXT_MAX and "\n" not in s and "\t" not in s


def test_top_level_keys_and_limits(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p) and not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch") and (ROOT / p).is_dir()
    assert 1 <= len(bench["command"]) <= 32 and all(_text(w) for w in bench["command"])
    for word in bench["command"]:
        assert not word.startswith("/") and ".." not in word


def test_entries_have_just_the_contract_keys(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _text(c["source"]) and _text(c["why"]) and len(c["reduced"]) <= 16
        assert c["file"].startswith(tuple(p + "/" for p in bench["paths"]))
        for key in c["reduced"]:
            assert NAME.match(key) and not key.endswith(("_dim", "_rank")) and not any(w in key for w in WIDTHS)
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _text(w["why"]) and NAME.match(w["traffic"])
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in SOURCES and _text(m["layer"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_names_unique_and_well_formed(bench):
    for group in ("configs", "workloads"):
        names = [x["name"] for x in bench[group]]
        assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    metrics = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(metrics) == len(set(metrics)) and all(NAME.match(n) for n in metrics)
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert len({c["file"] for c in bench["configs"]}) == len(bench["configs"])


def test_every_cell_reports_setup_another_end_to_end_and_a_layer(bench):
    sp = spec.Spec(ROOT)
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in bench["end_to_end"])
    for w in bench["workloads"]:
        e2e = {m["name"] for m in sp.end_to_end(w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = sp.per_layer(w["name"])
        assert layer and all(m["moves"] in e2e for m in layer)
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert four <= max(1, len(bench["workloads"]) // 4)


def test_each_part_is_found_by_name(bench):
    sp = spec.Spec(ROOT)
    for w in bench["workloads"]:
        cfg, tr = sp.config(w), sp.traffic(w)
        assert cfg["name"] == w["config"]
        drv = sp.driver(tr["driver"])
        for fn in ("setup", "step", "end_to_end", "check", "control"):
            assert callable(getattr(drv, fn))
    for m in bench["per_layer"]:
        assert callable(sp.reader(m["name"]).read)
        assert (BENCH / "metrics" / f"{m['name']}.py").exists()


def test_configs_state_their_cut(bench):
    for c in bench["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
        assert cfg["precision"] == "float32" and "guarantees" in cfg


def test_full_check_fits_the_driver_budget(bench):
    runs = 2 + 14 * 24
    total = runs * (bench["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200

