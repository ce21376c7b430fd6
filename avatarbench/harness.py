"""One run of one cell: find the cell's files by the names in
`BENCHMARK.json`, set up, warm up, measure the window, read the trace,
and decide `correct` against the reference.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by name:

- `BENCHMARK.json` cell -> `configs/<config>.json` (through the
  configuration's `file`), `traffic/<traffic>.json` (whose `kind` names
  the loop's code, `loops/<kind>.py`), `limits/<cell>.json`;
- each end-to-end metric -> `end_to_end/<name>.py`, each per-layer metric
  -> `layers/<name>.py`, a module with `read(data)` that returns a number
  or None when its source is not there (the metric is then left out).
"""

from __future__ import annotations

import importlib.util
import json
import os
import time

import numpy as np
import torch

from avatarbench import check, traffic
from avatarbench import trace as tracing
from avatarbench.work import counts

PACKAGE = "avatarbench"
TOP = 10                    # entries of each breakdown list


def load_json(path):
    with open(path) as fh:
        return json.load(fh)


def find_cell(root: str, workload: str):
    """(benchmark, cell, configuration, traffic, limits) of a cell."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; cells: "
                         f"{sorted(cells)}")
    cell = cells[workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = load_json(os.path.join(root, cfg_entry["file"]))
    data = os.path.join(root, PACKAGE)
    tr = load_json(os.path.join(data, "traffic", f"{cell['traffic']}.json"))
    limits = load_json(os.path.join(data, "limits", f"{workload}.json"))
    return bench, cell, cfg, tr, limits


def cell_metrics(bench: dict, workload: str):
    """The end-to-end and per-layer metric entries this cell reports."""
    def listed(m):
        return "workloads" not in m or workload in m["workloads"]

    e2e = [m for m in bench["end_to_end"] if listed(m)]
    names = {m["name"] for m in e2e}
    layers = [m for m in bench["per_layer"]
              if workload in m.get("workloads", [])
              or ("workloads" not in m and m["moves"] in names)]
    return e2e, layers


def _load(root: str, folder: str, name: str):
    """The module of the file `avatarbench/<folder>/<name>.py`."""
    path = os.path.join(root, PACKAGE, folder, f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"avatarbench.{folder}.{name.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(root: str, folder: str, name: str):
    """`read` of the metric's own file, `<folder>/<name>.py`."""
    return _load(root, folder, name).read


def loop_class(root: str, kind: str):
    """`LOOP` of the loop kind's own file, `loops/<kind>.py`."""
    return _load(root, "loops", kind).LOOP


def make_loop(root: str, cfg: dict, tr: dict, limits: dict, seed: int,
              device) -> traffic.Loop:
    return loop_class(root, tr["kind"])(cfg, tr, limits, seed, device)


class Window:
    """What an end-to-end reader sees: the set-up seconds, the window's
    iterations, seconds and latencies, and the device-busy milliseconds
    an iteration of the traffic's fixed device block (None where the
    traffic has none or the device is not a GPU)."""

    def __init__(self, setup_s, res, device_ms=None):
        self.setup_s = setup_s
        self.n, self.seconds = res["n"], res["seconds"]
        self.latencies = res["latencies"]
        self.device_ms = device_ms


class LayerData:
    """What a per-layer reader sees: the traced window (`window`, as an
    end-to-end reader sees it) and its host spans, and `n` iterations run
    three times from one point: timed without tracing (`timed_s`), under
    the profiler (`profiled`), and again for the work each needs (`work`),
    with the peaks."""

    def __init__(self, window, spans, profiled, work, timed_s):
        self.window = window
        self.spans, self.profiled, self.work = spans, profiled, work
        self.timed_s = timed_s
        self.iteration_s = timed_s / len(work)
        self.peaks = counts.peaks()

    def mean_bound_s(self, fn) -> float:
        """Mean over the iterations of the roofline bound of `fn`
        (counts.blend_fwd or counts.blend_bwd)."""
        return float(np.mean([counts.bound_seconds(*fn(w), self.peaks)
                              for w in self.work]))


def device_block_ms(loop, tr, device):
    """Device-busy milliseconds an iteration of the traffic's fixed block,
    `device_iterations` from the restored start (iteration 0), run after
    the window: the same views for every run of a seed, whatever the
    window reached. None where the traffic names no block or off a GPU."""
    n = tr.get("device_iterations")
    if not n or device.type != "cuda":
        return None
    loop.seek(0)
    busy = tracing.device_busy_s(loop.iteration, n, device)
    return None if busy is None else 1e3 * busy / n


def _number(x):
    return {"value": float(x)}


def run_cell(root, workload, seed, seconds, trace, device, t0, log):
    """One run; returns the result line's dict (without the JAX check)."""
    bench, _, cfg, tr, limits = find_cell(root, workload)
    return run_parts(root, bench, workload, cfg, tr, limits, seed, seconds,
                     trace, device, t0, log)


def run_parts(root, bench, workload, cfg, tr, limits, seed, seconds, trace,
              device, t0, log):
    """`run_cell` on a loaded configuration, traffic and limits."""
    e2e, layers = cell_metrics(bench, workload)
    loop = make_loop(root, cfg, tr, limits, seed, device)
    try:
        loop.warm_up()
        setup_s = time.perf_counter() - t0
        spans = tracing.Spans() if trace else None
        res = loop.window(seconds, mark=spans)
        peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)
        metrics, dev_extra, breakdown = {}, {}, None
        if not trace:
            win = Window(setup_s, res, device_block_ms(loop, tr, device))
            for m in e2e:
                value = reader(root, "end_to_end", m["name"])(win)
                if value is not None:
                    metrics[m["name"]] = dict(_number(value), unit=m["unit"])
        else:
            k0 = loop.profile_start()
            n_prof = tr["profile_iterations"]
            timed_s = loop.timed(k0, n_prof)
            log(json.dumps(dict(what="timed", k0=k0, iterations=n_prof,
                                seconds=timed_s)))
            loop.seek(k0)
            prof = tracing.profile(lambda i, mark: loop.iteration(mark),
                                   n_prof, device)
            data = LayerData(Window(setup_s, res), spans, prof,
                             loop.work(k0, n_prof), timed_s)
            for m in layers:
                value = reader(root, "layers", m["name"])(data)
                if value is not None:
                    metrics[m["name"]] = dict(_number(value), unit=m["unit"])
            dev_extra = dict(busy_s=prof.busy_s, window_s=prof.window_s)
            breakdown = dict(
                device_ops=[[n, s] for n, s in prof.device_ops[:TOP]],
                idle_gaps=[[n, s] for n, s in prof.idle_gaps[:TOP]])
            if loop.stream_log:
                log(json.dumps(dict(what="stream", slots=loop.stream_log)))
        prog_readings = loop.program_readings()
        loop.free_program()
        ref = loop.reference_readings()
        numbers = loop.compare(prog_readings, ref)
        log(json.dumps(dict(what="check_detail", **numbers["_detail"])))
        correct, checked = check.judge(numbers, limits)
    finally:
        loop.close()
    device_info = dict(
        platform="gpu" if device.type == "cuda" else device.type,
        kind=(torch.cuda.get_device_name(device) if device.type == "cuda"
              else "cpu"),
        count=1, memory_peak_bytes=int(peak), **dev_extra)
    out = dict(correct=bool(correct), attempted=res["n"], failed=0,
               metrics=metrics, device=device_info)
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["check"] = checked
    return out
