"""How far the square root of an integer lies from float32's rounding
midpoints, and how often PyTorch's CPU square root misrounds.

    python3 tools/sqrt_midpoints.py                  # every n in [1, 2^31): about 9 minutes on one core
    python3 tools/sqrt_midpoints.py --hi 3145729     # the d^2 of a 1024^3 field
    python3 tools/sqrt_midpoints.py --torch-hi 36865 # PyTorch's CPU roots of 0 ... 36864 against numpy's

``sdf_tools_tpu_torch.ops.edt.d2_to_distance`` takes the float32 root of an
integer d^2 in float64 and rounds it once to float32. That is the correctly
rounded float32 root whenever the float64 root is at most one ulp off,
because sqrt(n) lies more than 4 float64 ulps from every float32 rounding
midpoint (the function's docstring has the proof). This program measures
the margin exactly: for sqrt(n) in [2^e, 2^(e+1)) a midpoint is M 2^(e-24)
with M odd, and n 2^(48-2e) - M^2 is an exact int64 (below 2^50). It prints
the least margin in float64 ulps and the n that has it. With
``--torch-hi`` it also counts the integers whose ``torch.sqrt`` on the CPU
differs from numpy's in float64 and in float32.
"""
from __future__ import annotations

import argparse

import numpy as np


def midpoint_ulps(n: np.ndarray) -> np.ndarray:
    """For each integer n >= 1 (int64, below 2^31): the distance from
    sqrt(n) to the nearest float32 rounding midpoint, in float64 ulps of
    sqrt(n). The numerator |n 2^(48-2e) - M^2| is exact; only the division
    by sqrt(n) + M rounds."""
    n = np.asarray(n, dtype=np.int64)
    e = (np.frexp(n.astype(np.float64))[1] - 1) // 2  # sqrt(n) in [2^e, 2^(e+1))
    big = n << (48 - 2 * e)  # n in units of 2^(2e-48), where M^2 is an integer
    root = np.sqrt(big.astype(np.float64))
    q = np.floor(root).astype(np.int64)
    best = None
    for c in (-1, 0, 1, 2):  # the odd M in [q - 1, q + 3]: the nearest one is among them
        m = q + c
        m = np.where(m % 2 == 1, m, m + 1)
        # |sqrt(big) - M| = |big - M^2| / (sqrt(big) + M), in units of 2^(e-24);
        # a float64 ulp of sqrt(n) is 2^(e-52), so times 2^28
        d = np.abs(big - m * m).astype(np.float64) / (root + m) * 2.0**28
        best = d if best is None else np.minimum(best, d)
    return best


def least_margin(lo: int, hi: int, step: int = 1 << 24):
    """(least margin in float64 ulps, the n that has it) over n in [lo, hi)."""
    least, at = np.inf, None
    for a in range(max(lo, 1), hi, step):
        n = np.arange(a, min(a + step, hi), dtype=np.int64)
        d = midpoint_ulps(n)
        i = int(np.argmin(d))
        if d[i] < least:
            least, at = float(d[i]), int(n[i])
    return least, at


def torch_misrounded(hi: int) -> dict:
    """The integers 0 ... hi - 1 whose CPU ``torch.sqrt`` differs from
    numpy's, counted in float64 and float32."""
    import torch

    n = np.arange(hi)
    out = {}
    for dt, tdt in ((np.float64, torch.float64), (np.float32, torch.float32)):
        x = n.astype(dt)
        out[np.dtype(dt).name] = int((torch.sqrt(torch.as_tensor(x)).numpy() != np.sqrt(x)).sum())
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lo", type=int, default=1)
    ap.add_argument("--hi", type=int, default=1 << 31)
    ap.add_argument("--torch-hi", type=int, default=0, help="count PyTorch's misrounded roots of 0 ... N - 1")
    args = ap.parse_args()
    least, at = least_margin(args.lo, args.hi)
    print(f"n in [{args.lo}, {args.hi}): least distance of sqrt(n) from a float32 rounding midpoint"
          f" {least!r} float64 ulps, at n = {at}")
    if args.torch_hi:
        import torch

        print(f"torch {torch.__version__} CPU ({torch.backends.cpu.get_cpu_capability()}): sqrt of 0 ... "
              f"{args.torch_hi - 1} misrounded against numpy's: {torch_misrounded(args.torch_hi)}")


if __name__ == "__main__":
    main()
