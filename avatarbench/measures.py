"""The bodies that a metric's `.train` and `.render` readers share
(`layers/<metric>.<train|render>.py`). Which cells report a metric is
decided by its `workloads` in `BENCHMARK.json`; a body returns None only
where its source is not there."""

from __future__ import annotations

import numpy as np

from avatarbench.work import counts


def span_ms(a: str, b: str):
    """A reader of the host milliseconds from mark `a` to mark `b`, the
    mean over the traced window's iterations."""
    def read(d):
        return d.spans.mean_ms(a, b)
    return read


def flame_binding_ms(d):
    """From the call to the binding mark: FLAME at the timestep, the face
    frames and the binding chain. None where no FLAME mark was made (an
    unbound model)."""
    if not d.spans.has("flame_frames"):
        return None
    return d.spans.mean_ms("start", "binding")


def roofline(fn, match):
    """A reader of a kernel's share of its roofline: the least time the
    iterations' work needs (`fn`, from `work/counts.py`) over the device
    time of what was launched inside the profiler ranges `match` accepts."""
    def read(d):
        t = d.profiled.device_s_launched_in(match)
        if not t:
            return None
        return 100.0 * d.mean_bound_s(fn) / t
    return read


blend_fwd_roofline = roofline(counts.blend_fwd,
                              lambda name: name == "stage:pack_gather")
blend_bwd_roofline = roofline(counts.blend_bwd,
                              lambda name: "BlendImageBackward" in name)


def device_idle(d):
    """1 - the device-busy seconds of the profiled iterations over the wall
    seconds of the same iterations run without the profiler."""
    return 100.0 * (1.0 - d.profiled.busy_s / d.timed_s)


def mfu(flops_fn):
    """A reader of the share of the FP32 peak: the frozen FP32 operations
    of the timed iterations over the peak times their wall seconds."""
    def read(d):
        flops = float(np.sum([flops_fn(w) for w in d.work]))
        return 100.0 * flops / (d.peaks["fp32_flops_per_s"] * d.timed_s)
    return read
