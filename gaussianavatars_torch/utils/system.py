"""System utilities (port of `gaussianavatars_tpu/utils/system.py`;
reference utils/general_utils.py:112-133 and utils/system_utils.py).

Only the seeding half of `safe_state` is ported: the port prints plain
lines and does not replace `sys.stdout` with a timestamping writer.
`profile_trace` takes the place of the JAX package's `jax.profiler` scope
with a `torch.profiler` one."""

from __future__ import annotations

import contextlib
import os
import random
import time

import numpy as np
import torch


def safe_state(seed: int = 0):
    """Seed the process RNGs: `random` (the camera shuffles), numpy's
    global generator and torch's."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def mkdir_p(path: str):
    os.makedirs(path, exist_ok=True)


def search_for_max_iteration(folder: str) -> int:
    """The largest N of the `iteration_N` entries of `folder`
    (reference utils/system_utils.py:26-28)."""
    return max(int(f.split("_")[-1]) for f in os.listdir(folder))


@contextlib.contextmanager
def profile_trace(log_dir: str | None):
    """A `torch.profiler` scope over the block, with CPU and (where a GPU
    is present) CUDA activities, written on exit as a Chrome trace
    `<log_dir>/trace_<time>.json` (chrome://tracing or Perfetto read it).
    Does nothing when `log_dir` is None or empty, so a CLI flag passes
    straight through. Every operation of the block is recorded: meant for
    short runs. The tracer of `utils/trace.py` runs over the block too, so
    the trace names the program's spans (`ga:<span>`) and `training` logs
    their times."""
    if not log_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    from gaussianavatars_torch.utils import trace

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    started = trace.active() is None
    trace.start()
    try:
        with profile(activities=activities) as prof:
            yield prof
    finally:
        if started:
            trace.stop()
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace_{int(time.time())}.json"))
