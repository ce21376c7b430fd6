"""The quality protocols of the JAX package's `examples/`, run through the
port: `bound_avatar_recovery` (a FLAME-bound avatar recovered from renders
of a known one) and `synthetic_recovery` (an unbound scene recovered from a
noisy point cloud). Run each with `python -m
gaussianavatars_torch.examples.<name> [--device cuda]`."""

from __future__ import annotations

import shutil
import subprocess
from typing import Optional


def nvidia_smi_line() -> Optional[str]:
    """The card's name and power limit as `nvidia-smi` gives them, or None
    where the tool is not installed."""
    if shutil.which("nvidia-smi") is None:
        return None
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return res.stdout.strip().splitlines()[0] if res.returncode == 0 else None


def steady_rate(timeline: list) -> Optional[float]:
    """Iterations per second over the second half of the loop's timeline
    [(iteration, wall time)], or None with fewer than 4 points."""
    if len(timeline) < 4:
        return None
    (i0, t0), (i1, t1) = timeline[len(timeline) // 2], timeline[-1]
    return round((i1 - i0) / max(t1 - t0, 1e-9), 2)
