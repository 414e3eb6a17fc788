"""The spread of a set of runs, as the bounds are set from it.

    python3 -m benchmark.spread run1.out run2.out ...

reads the last line of each file (a run's result) and prints, for each
metric, the median, the first and third quartiles (Python's
``statistics.quantiles(values, n=4)``), the spread (the distance between
the quartiles over the median) and five times it: the bound a set of runs
supports, before the rule's floor of 1%.
"""
from __future__ import annotations

import json
import statistics
import sys


def spread(values) -> float:
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def last_result(path: str) -> dict:
    with open(path) as f:
        lines = [line for line in f.read().splitlines() if line.startswith("{")]
    return json.loads(lines[-1])


def main(paths) -> int:
    runs = [last_result(p) for p in paths]
    names = sorted({k for r in runs for k in r["metrics"]})
    for name in names:
        vals = [r["metrics"][name]["value"] for r in runs if name in r["metrics"]]
        if len(vals) < 2:
            print(f"{name}: {vals}")
            continue
        q1, med, q3 = statistics.quantiles(vals, n=4)
        s = spread(vals)
        print(f"{name}: n {len(vals)} median {statistics.median(vals)!r} q1 {q1!r} q3 {q3!r} "
              f"spread {s:.6f} five_times {5 * s:.6f} min {min(vals)!r} max {max(vals)!r}")
    print("correct", [r["correct"] for r in runs])
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
