"""Time the design probes of several checkouts in turns on one card.

    python3 tools/micro_turns.py DIR=LABEL [DIR=LABEL ...] [--family gather|render] [--order A,B,B,A] [--out FILE]

Each DIR is a checkout of this repository (the working tree ``.``, or an
earlier commit unpacked with ``git archive``). For each label of
``--order`` (default: every label once, then again in reverse), a fresh
process in that checkout runs the family's probe programs' ``main`` (each
building that checkout's kernels) and reports every probe's device time at
B = 1 and at B_fill: ``gather`` (the default), the envelope-design probes
``python -m sdf_tools_tpu_torch.scripts.bench_micro_gather{,2,3}``;
``render``, the render-design probes ``bench_micro_render{,2,...,6}`` (R5
and R6 at their higher iteration count). Prints one table (µs at B = 1, ms
at B_fill, a column a run) and the card's name and power limit, and writes
the runs as JSON to ``--out``. Two versions are compared only inside one
call: parent, change, change, parent.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

FAMILIES = {
    "gather": ("bench_micro_gather", "bench_micro_gather2", "bench_micro_gather3"),
    "render": ("bench_micro_render", "bench_micro_render2", "bench_micro_render3", "bench_micro_render4",
               "bench_micro_render5", "bench_micro_render6"),
}
PROGRAM = """
import importlib, json
out = {{}}
for name in {modules!r}:
    r = importlib.import_module("sdf_tools_tpu_torch.scripts." + name).main([])
    out.update({{k: [v["ms"], v["fill_ms"]] for k, v in r["probes"].items()}})
print("TIMES " + json.dumps(out))
"""


def run(tree: Path, family: str) -> dict:
    program = PROGRAM.format(modules=FAMILIES[family])
    done = subprocess.run([sys.executable, "-c", program], cwd=tree, capture_output=True, text=True, timeout=900)
    lines = [x for x in done.stdout.splitlines() if x.startswith("TIMES ")]
    if done.returncode != 0 or not lines:
        raise SystemExit(f"{tree}: exit {done.returncode}\n{done.stdout[-3000:]}\n{done.stderr[-3000:]}")
    return json.loads(lines[-1][len("TIMES "):])


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+", help="DIR=LABEL")
    ap.add_argument("--family", choices=sorted(FAMILIES), default="gather", help="the probe programs to run")
    ap.add_argument("--order", help="labels in the order to run them, comma-separated")
    ap.add_argument("--out", help="write the runs here as JSON")
    args = ap.parse_args(argv)
    trees = dict(reversed(t.split("=", 1)) for t in args.trees)
    order = args.order.split(",") if args.order else [*trees, *reversed(trees)]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    runs = [(label, run(Path(trees[label]), args.family)) for label in order]
    print(f"card: {smi}; device time at B = 1 (us) and B_fill (ms), runs in order")
    width = max(5, *(len(key) for key in runs[0][1]))
    print(f"{'probe':{width}} " + " ".join(f"{label:>10}" for label, _ in runs) + "  | "
          + " ".join(f"{label:>10}" for label, _ in runs))
    for key in runs[0][1]:
        print(f"{key:{width}} " + " ".join(f"{r[key][0] * 1e3:10.2f}" for _, r in runs) + "  | "
              + " ".join(f"{r[key][1]:10.4f}" for _, r in runs))
    if args.out:
        Path(args.out).write_text(json.dumps({"card": smi, "runs": [{"label": lb, "probes": r} for lb, r in runs]}))


if __name__ == "__main__":
    main()
