"""Spans and device times of a traced run.

`Spans` is the `mark` hook the program's train step and render call as
each stage is issued (`flame_frames`, `binding`, `projection`, `binning`,
`pack_gather`, `blend`, `composite`, then `forward`, `backward`, `adam`,
`stats` in a step, or the benchmark's own `delivered` after a frame
reached the host). It keeps the host clock at every mark of every
iteration in memory.

`Profiled` runs a few iterations under `torch.profiler` with every stage
inside a named range (`stage:<mark>`, from that mark to the next), so a
kernel is attributed to the stage whose range holds its launch, and reads
the device timeline: the busy union, the kernels by name, and the idle
gaps with the stage the host was in.

`device_busy_s` runs a fixed block of iterations under the profiler with
the device's activity alone and returns the busy union of its kernels,
copies and sets, read from the profiler's events without a trace file.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from collections import defaultdict

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Spans:
    """Host timestamps of the marks, one dict per iteration."""

    def __init__(self):
        self.iterations: list[dict] = []

    def begin(self):
        self.iterations.append({"start": time.perf_counter()})

    def __call__(self, name: str):
        self.iterations[-1][name] = time.perf_counter()

    def mean_ms(self, a: str, b: str):
        """Mean of t(b) - t(a) over the iterations that have both marks;
        None if none has."""
        d = [it[b] - it[a] for it in self.iterations if a in it and b in it]
        return 1e3 * sum(d) / len(d) if d else None

    def has(self, name: str) -> bool:
        return any(name in it for it in self.iterations)


class StageRanges:
    """A `mark` hook that keeps one profiler range open per stage."""

    def __init__(self):
        self.current = None

    def _open(self, name):
        self.close()
        self.current = torch.profiler.record_function(f"stage:{name}")
        self.current.__enter__()

    def begin(self):
        self._open("start")

    def __call__(self, name: str):
        self._open(name)

    def close(self):
        if self.current is not None:
            self.current.__exit__(None, None, None)
            self.current = None


def _union(intervals):
    total, end = 0.0, None
    merged = []
    for a, b in sorted(intervals):
        if end is None or a > end:
            merged.append([a, b])
            end = b
        elif b > end:
            merged[-1][1] = b
            end = b
    for a, b in merged:
        total += b - a
    return total, merged


class Profiled:
    """The device timeline of a profiled sub-window (times in seconds)."""

    def __init__(self, events: list, iterations: int):
        self.iterations = iterations
        win = [e for e in events if e.get("name") == "bench:window"
               and e.get("cat") == "user_annotation"]
        if not win:
            raise RuntimeError("the profiler trace has no window range")
        w0 = win[0]["ts"]
        w1 = w0 + win[0]["dur"]
        self.window_s = (w1 - w0) * 1e-6
        dev = [e for e in events if e.get("cat") in DEVICE_CATS
               and "dur" in e and w0 <= e["ts"] < w1]
        self.busy_s, merged = _union(
            [(e["ts"], min(e["ts"] + e["dur"], w1)) for e in dev])
        self.busy_s *= 1e-6
        by_corr = defaultdict(list)
        for e in dev:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                by_corr[corr].append(e)
        self.launches = sorted(
            (e["ts"], e.get("tid"), e.get("args", {}).get("correlation"))
            for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver")
            and w0 <= e.get("ts", -1) < w1)
        self.launch_ts = [ln[0] for ln in self.launches]
        self.ranges = [e for e in events if "dur" in e and (
            e.get("cat") in ("user_annotation", "cpu_op"))
            and w0 <= e["ts"] < w1]
        self.by_corr = by_corr
        names = defaultdict(float)
        for e in dev:
            names[e["name"]] += e["dur"] * 1e-6
        self.device_ops = sorted(names.items(), key=lambda kv: -kv[1])
        gaps = defaultdict(float)
        stages = sorted((r["ts"], r["ts"] + r["dur"], r["name"][6:])
                        for r in self.ranges
                        if r["name"].startswith("stage:"))
        edges = [w0] + [x for a, b in merged for x in (a, b)] + [w1]
        for a, b in zip(edges[0::2], edges[1::2]):
            if b > a:
                gaps[_stage_at(stages, a)] += (b - a) * 1e-6
        self.idle_gaps = sorted(gaps.items(), key=lambda kv: -kv[1])

    def device_s_launched_in(self, match) -> float | None:
        """Device seconds per iteration of the work launched inside the
        ranges whose name `match` accepts (on the range's thread); None
        when no such range launched anything."""
        total, found = 0.0, False
        for r in self.ranges:
            if not match(r["name"]):
                continue
            a, b, tid = r["ts"], r["ts"] + r["dur"], r.get("tid")
            lo = bisect.bisect_left(self.launch_ts, a)
            hi = bisect.bisect_left(self.launch_ts, b)
            for _, ltid, corr in self.launches[lo:hi]:
                if ltid != tid:
                    continue
                for e in self.by_corr.get(corr, ()):
                    total += e["dur"] * 1e-6
                    found = True
        return total / self.iterations if found else None


def _stage_at(stages, ts):
    name = "other"
    for a, b, stage in stages:
        if a <= ts < b:
            name = stage
        elif a > ts:
            break
    return name


def profile(run_iteration, iterations: int, device) -> Profiled:
    """Run `run_iteration(i, mark)` for i < iterations under the profiler,
    the stage ranges open, and read the trace. The trace file lives in a
    temporary directory only while it is read."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    ranges = StageRanges()
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function("bench:window"):
            for i in range(iterations):
                ranges.begin()
                run_iteration(i, ranges)
                ranges.close()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    with tempfile.TemporaryDirectory(prefix="avatarbench_trace_") as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    return Profiled(events, iterations)


def device_busy_s(run_iteration, iterations: int, device) -> float | None:
    """Device-busy seconds of `run_iteration()` called `iterations` times
    under the profiler (device activity only); None off a CUDA device."""
    if device.type != "cuda":
        return None
    torch.cuda.synchronize(device)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iterations):
            run_iteration()
        torch.cuda.synchronize(device)
    spans = [_interval_ns(e) for e in prof.profiler.kineto_results.events()
             if _on_device(e)]
    spans = [(a, b) for a, b in spans if b > a]
    if not spans:
        return None
    return _union(spans)[0] * 1e-9


def _on_device(e) -> bool:
    """A kernel, copy or set (the profiler's activity kind where its event
    has one, else the device it ran on)."""
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        return kind() in DEVICE_CATS
    return e.device_type() == torch.autograd.DeviceType.CUDA


def _interval_ns(e) -> tuple:
    if hasattr(e, "start_ns"):
        return e.start_ns(), e.start_ns() + e.duration_ns()
    return 1000 * e.start_us(), 1000 * (e.start_us() + e.duration_us())
