"""The exact march's first call in a fresh process against its warm calls.

    python3 tools/march_first_call.py [--n 512] [--hw 1024] [--warm 5] [--out FILE]

Run on a machine with a CUDA card, from the repository root, in a process of
its own: it imports the port, loads the kernel library as every benchmark
cell's set-up does (``_build.library()``, building it first if it is not
built), makes BASELINE's sphere scene's signed field at ``--n``^3 and
bench.py's camera's ``--hw``^2 rays, then times ``render._trace_depth`` (the
coarse skip on, as the training step and the plane sweep's fallback call it)
on the host's clock, each call ended by a synchronize: the process's first
call, then ``--warm`` calls. Prints one JSON line: the card, the seconds to
import torch and the port, to initialise CUDA and to load the library, the
first call's and the warm calls' ms, and the kernel's launches.
"""
from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from sdf_tools_tpu_torch import _build  # noqa: E402
from sdf_tools_tpu_torch.grid import GridMeta, SdfGrid  # noqa: E402
from sdf_tools_tpu_torch.ops import edt, render  # noqa: E402
from sdf_tools_tpu_torch.scripts._scenes import device_scene  # noqa: E402

_T_IMPORT = time.perf_counter()
RES = 0.05


def _synced_ms(fn) -> float:
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--hw", type=int, default=1024)
    ap.add_argument("--warm", type=int, default=5)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    torch.cuda.init()
    torch.empty(1, device=dev)
    t_cuda = time.perf_counter() - t0
    t0 = time.perf_counter()
    _build.library()
    t_lib = time.perf_counter() - t0

    n = args.n
    mask = device_scene(n, dev)[0]
    meta = GridMeta.create(torch.eye(4, device=dev), RES, mask.shape, device=dev)
    sdf = SdfGrid.create(edt.signed_field_from_masks(mask, RES, "auto")[0], meta, 1e3)
    c = np.full(3, 0.5 * n * RES)
    o, v = render.camera_rays(c + np.array([-1.2, 0.0, 0.4]) * n * RES, c, (0.0, 0.0, 1.0), 50.0, args.hw, args.hw,
                              device=dev)
    torch.cuda.synchronize()
    launches0 = _build.LAUNCHES["march"]

    def call():
        return render._trace_depth(sdf, o, v, 0.0, 4 * n * RES, 1e-3, 64, None)

    first = _synced_ms(call)
    warm = [_synced_ms(call) for _ in range(args.warm)]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    out = {"card": smi, "torch": torch.__version__, "import_s": _T_IMPORT - _T0, "cuda_init_s": t_cuda,
           "library_s": t_lib, "rays": o.numel() // 3, "first_ms": first, "warm_ms": warm,
           "first_minus_warm_ms": first - float(np.median(warm)), "launches": _build.LAUNCHES["march"] - launches0}
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
