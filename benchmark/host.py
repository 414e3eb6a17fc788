"""What the host and the card did beside the window, for standard error.

The host-paced cells move with the host's speed, so each run notes:

* the window's host milliseconds a step in six equal runs of steps, which
  shows a drift inside the run;
* one reading of the card's clocks, power and temperature after the window
  (``nvidia-smi``, read only).
"""
from __future__ import annotations

import statistics
import subprocess

CARD_FIELDS = ("name", "power.limit", "power.draw", "clocks.sm", "clocks.mem", "temperature.gpu")


def ms_per_step(lat):
    return round(1e3 * sum(lat) / len(lat), 3) if lat else None


def window_note(lat, reference_s: float) -> dict:
    note = {"steps": len(lat), "reference_s_left_out_of_setup": round(reference_s, 3)}
    if len(lat) >= 6:
        k = len(lat) // 6
        note["step_ms_median_by_sixth"] = [round(1e3 * statistics.median(lat[i * k:(i + 1) * k]), 3)
                                           for i in range(6)]
    return note


def card_sample() -> dict:
    """``nvidia-smi``'s reading of the card now, as field -> text."""
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={','.join(CARD_FIELDS)}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        values = [v.strip() for v in out.stdout.strip().splitlines()[0].split(",")]
        return dict(zip(CARD_FIELDS, values))
    except (OSError, subprocess.SubprocessError, IndexError):
        return {}
