"""The readers of the program's spans (`program_trace.py`, the layers
`host_syncs`, `sync_wait_ms`, `sync_idle_ms`, `launches`, `flame_reg_ms`):
on the tiny CPU runs, where the spans read and the device-trace readers
return None; on a made-up device trace; and on a program without the
spans, where every reader returns None."""

import types

import pytest

from avatarbench import harness, idle_by_span, program_trace
from avatarbench import trace as tracing
from avatarbench.tests import tiny

SPAN_METRICS = ("host_syncs", "sync_wait_ms")
DEVICE_METRICS = ("sync_idle_ms", "launches")


# FLAME's copy from the host (bound only), the binning's slot count and
# compaction, and in a frame `to_wire`'s copy
@pytest.mark.parametrize("workload,syncs", [
    ("avatar-train", 3), ("cloud-train", 2), ("avatar-replay", 4)])
def test_tiny_traced_run_reads_the_spans(workload, syncs):
    out = tiny.run(workload, trace=True)
    sfx = "render" if "replay" in workload else "train"
    m = out["metrics"]
    assert m[f"host_syncs.{sfx}"]["value"] == syncs
    assert m[f"host_syncs.{sfx}"]["unit"] == "syncs"
    assert m[f"sync_wait_ms.{sfx}"]["value"] > 0
    # no device on the CPU: the device-trace readers find nothing
    for name in DEVICE_METRICS:
        assert f"{name}.{sfx}" not in m
    if workload == "avatar-train":
        assert m["flame_reg_ms.train"]["value"] > 0
    else:
        assert "flame_reg_ms.train" not in m


def _event(name, ts, dur, cat="user_annotation", tid=1, corr=None):
    e = {"name": name, "ts": ts, "dur": dur, "cat": cat, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _profiled(with_spans=True):
    """Two made-up iterations (microseconds): in each, a step with a
    binning whose sync waits from 40 to 60 while a kernel runs 30-50, the
    next kernel at 70; a kernel launched inside the step, one outside."""
    ev = [_event("bench:window", 0, 200)]
    corr = 0
    for base in (0, 100):
        if with_spans:
            ev += [_event("ga:train_step", base + 10, 80),
                   _event("ga:binning", base + 20, 50),
                   _event("ga:sync.slots", base + 40, 20)]
        for launch, start, dur in ((25, 30, 20), (65, 70, 10),
                                   (95, 96, 2)):
            corr += 1
            ev.append(_event("cudaLaunchKernel", base + launch, 1,
                             cat="cuda_runtime", corr=corr))
            ev.append(_event("k", base + start, dur, cat="kernel", tid=7,
                             corr=corr))
        ev.append(_event("cudaStreamSynchronize", base + 41, 18,
                         cat="cuda_runtime", corr=10_000 + base))
    return tracing.Profiled(ev, 2)


def _data(prof):
    return types.SimpleNamespace(profiled=prof)


def test_readers_on_a_device_trace():
    d = _data(_profiled())
    assert program_trace.host_syncs(d) == 1
    assert program_trace.sync_wait_ms(d) == pytest.approx(0.020)
    # idle from the sync's start (40) to the next kernel (70), less the
    # kernel that ran 40-50: 20 us
    assert program_trace.sync_idle_ms(d) == pytest.approx(0.020)
    # two kernels launched inside the step; the stream sync launches no
    # device work and the third kernel is launched outside
    assert program_trace.sync_sites(d.profiled) == {"sync.slots": {
        "n": 1, "wait_ms": pytest.approx(0.020),
        "idle_ms": pytest.approx(0.020)}}
    assert program_trace.launches("train_step")(d) == 2
    assert program_trace.launches("render")(d) is None
    assert program_trace.span_ms("binning")(d) == pytest.approx(0.050)
    assert program_trace.span_ms("flame_reg")(d) is None
    gaps = dict(program_trace.idle_by_span(d.profiled))
    # busy 30-50, 70-80, 96-98 an iteration; each gap named at its start:
    # 0-30 and 98-130 outside the steps, 50-70 in the sync (opened at
    # 40), 80-96 in the step after the binning closed, 198-200 outside
    assert gaps == pytest.approx({"other": 64e-6, "sync.slots": 40e-6,
                                  "train_step": 32e-6})


def test_readers_on_a_program_without_spans():
    d = _data(_profiled(with_spans=False))
    for read in (program_trace.host_syncs, program_trace.sync_wait_ms,
                 program_trace.sync_idle_ms,
                 program_trace.launches("train_step"),
                 program_trace.span_ms("flame_reg")):
        assert read(d) is None
    assert {n for n, _ in program_trace.idle_by_span(d.profiled)} == {
        "other"}


def test_idle_by_span_line_on_the_cpu():
    _, _, cfg, tr, limits = harness.find_cell(tiny.ROOT, "avatar-train")
    cfg, tr = tiny.shrink(cfg, tr)
    import torch
    out = idle_by_span.line(tiny.ROOT, "avatar-train", cfg, tr, limits,
                            3_000_000_019, 0.2, torch.device("cpu"))
    assert out["what"] == "idle_by_span" and out["idle_by_span"] == []
    assert out["host_syncs"] == 3 and out["launches"] is None
