"""The port's measurement programs (``sdf_tools_tpu_torch/scripts/bench_*.py``
and ``measure_reference_deviation.py``) on the CPU, at toy sizes: each runs
and prints its line; the deviation table equals the JAX script's at n = 32,
and the scaling's collective bytes equal the JAX script's analytic volume
at P = 2 and 4.
"""
import json
from pathlib import Path

import torch

from sdf_tools_tpu_torch.ops import edt
from sdf_tools_tpu_torch.scripts import (
    bench_1024, bench_ft_bwd, bench_render_1024, bench_scaling, bench_shard_overhead, measure_reference_deviation,
)
from sdf_tools_tpu_torch.scripts._scenes import device_scene

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


def _field(mask):
    return edt.signed_field_from_masks(mask, bench_1024.RES)[0]


def test_bench_1024_at_a_toy_size(capsys):
    rec = bench_1024.run(32, 4, CPU)
    out = capsys.readouterr().out
    for part in ("mask upload", "signed_field_slabbed", "without the drain", "TOTAL"):
        assert part in out
    assert json.loads(out.strip().splitlines()[-1]) == rec
    mask = device_scene(32, CPU)[0]
    field = _field(mask)
    assert (rec["min"], rec["max"]) == (float(field.min()), float(field.max()))


def test_bench_render_1024_at_a_toy_size(capsys):
    rec = bench_render_1024.run(32, 16, 24, CPU)
    out = capsys.readouterr().out
    assert "first frame" in out and "render 16x24 over 32^3 (march)" in out
    assert json.loads(out.strip().splitlines()[-1]) == rec
    mask = device_scene(32, CPU)[0]
    field = _field(mask)
    assert torch.equal(bench_render_1024.slab_field(mask).view(torch.int32), field.view(torch.int32))
    assert 0 < rec["hit_fraction"] < 1 and len(rec["render_seconds_runs"]) == bench_render_1024.RUNS


def test_bench_ft_bwd_at_a_toy_size(capsys):
    rec = bench_ft_bwd.run(24, "auto", CPU)
    out = capsys.readouterr().out
    for part in ("full fwd+bwd", "forward alone", "feature_transform x1", "argmin passes only", "plain squared_edt",
                 "winner segment sums", "scatter_add_"):
        assert part in out
    assert json.loads(out.strip().splitlines()[-1]) == rec
    assert all(rec[f"{k}_seconds"] > 0 for k in rec["first_call_seconds"])


def test_bench_shard_overhead_at_a_toy_size(capsys):
    recs = bench_shard_overhead.run(16, 32, CPU)
    lines = [json.loads(x) for x in capsys.readouterr().out.strip().splitlines() if x.startswith("{")]
    assert lines == recs
    assert [r["metric"] for r in recs] == ["edt_shard_overhead_mesh1", "render_shard_overhead_mesh1"]
    assert recs[0]["process_group"] == "gloo" and recs[0]["collectives"] == {"all_gather": 1}
    assert recs[1]["rays"] == 32 * 32 and 0.9 <= recs[1]["hit_agreement"] <= 1.0


def test_bench_scaling_bytes_match_the_model():
    rep = bench_scaling.run(16, (2, 4))
    assert rep["ok"] and set(rep["devices"]) == {"2", "4"}
    for p, d in rep["devices"].items():
        assert d["field_equal"] and d["bytes_agree"]
        assert d["bytes"] == {"all_gather": 2 * 2 * int(p) * 16 * 16 * 4}


def test_reference_deviation_table_equals_the_jax_script(capsys):
    """The JAX script's own code with its sizes cut to (32,), run through
    the JAX package's native library, against the port's table."""
    src = (REPO / "scripts" / "measure_reference_deviation.py").read_text()
    assert "for n in (64, 256, 512):" in src
    exec(compile(src.replace("for n in (64, 256, 512):", "for n in (32,):"), "measure_reference_deviation", "exec"),
         {"__name__": "jax_script"})
    want = [line.split("  <!--")[0] for line in capsys.readouterr().out.strip().splitlines()]
    recs = measure_reference_deviation.main(["32"])
    out = capsys.readouterr().out.strip().splitlines()
    assert [line.split("  <!--")[0] for line in out[:-1]] == want == measure_reference_deviation.table(recs)
    assert json.loads(out[-1]) == recs
    assert [r["field"] for r in recs] == ["filled", "free"] and all(r["deviating"] > 0 for r in recs)
