"""The port's tracer (`gaussianavatars_torch/utils/trace.py`) on the CPU.

With the tracer off, the `mark` hook of the train step (bound and
unbound) and the render is called with the stage names in the order the
benchmark and the chip smoke test read, no record is kept and no profiler
range is entered. With it on, the spans of a step and a render nest under
their roots with one iteration id a call, self time is the duration less
the children's, FLAME's skinning counts 1 host sync, each binning 2 and
`to_wire` 1, every
span has its `ga:` range under a CPU `torch.profiler` within 2 ms of the
record put on the trace's clock, and `training` under `profile_trace`
writes `iter_time` and the span timings to tensorboard.
"""

import glob
import json
import os

import numpy as np
import pytest
import torch

from gaussianavatars_torch import benchmark as tbench
from gaussianavatars_torch.config import (
    ModelConfig,
    OptimizationConfig,
    PipelineConfig,
)
from gaussianavatars_torch.ops import rasterize_tiles
from gaussianavatars_torch.ops.projection import project_gaussians
from gaussianavatars_torch.train.loop import (
    camera_arrays,
    initial_state,
    lr_pytree,
    make_render_fn,
    make_train_step,
    training,
)
from gaussianavatars_torch.utils import tensorboard as ttb
from gaussianavatars_torch.utils import trace
from gaussianavatars_torch.utils.system import profile_trace
from gaussianavatars_torch.viewer.network_gui import to_wire

from .test_torch_blend import one_torch_thread  # noqa: F401

W, H, TILE = 64, 48, 16
RASTER = ["projection", "binning", "pack_gather", "blend", "composite"]
GOLDEN = {
    "bound_step": ["flame_frames", "binding", *RASTER, "forward",
                   "backward", "adam", "stats"],
    "unbound_step": ["binding", *RASTER, "forward", "backward", "adam",
                     "stats"],
    "render": ["flame_frames", "binding", *RASTER],
}
PARENT = {"flame_frames": "train_step", "sync.lbs_row": "flame_frames",
          "binding": "train_step",
          "rasterize": "train_step", "projection": "rasterize",
          "binning": "rasterize", "sync.slots": "binning",
          "sync.keep": "binning", "pack_gather": "rasterize",
          "blend": "rasterize", "composite": "rasterize",
          "forward": "train_step", "flame_reg": "forward",
          "backward": "train_step", "blend_bwd": "backward",
          "adam": "train_step", "stats": "train_step", "train_step": None}


@pytest.fixture(autouse=True)
def no_tracer():
    """Every test starts and ends with no tracer running."""
    trace.stop()
    yield
    trace.stop()


@pytest.fixture(scope="module")
def models():
    """The 1-per-face bound bench avatar and an unbound cloud, seen through
    a narrow field of view at 64x48 (few Gaussians on screen, so the plain
    CPU blend stays quick)."""
    bound = tbench.make_bound_bench_model(sh_degree=1, n_per_face=1,
                                          device="cpu")
    cloud = tbench.scene_to_model(tbench.make_bench_scene(
        n=2000, device="cpu"))
    cam = camera_arrays(tbench.make_camera(W, H, fovx=0.08, dist=1.0,
                                           device="cpu"))
    return {"bound": bound, "unbound": cloud, "cam": cam}


def _step(models, kind):
    m = models[kind]
    opt = OptimizationConfig()
    st = initial_state(m)
    fixed = ({k: v for k, v in m.flame_param.items() if k not in st.flame_tr}
             if kind == "bound" else {})
    lrs = lr_pytree(opt, 1e-3, st.flame_tr, 1.0)
    step = make_train_step(m, opt, PipelineConfig(tile_size=TILE), W, H,
                           m.active_sh_degree, m.num_timesteps)
    gt = torch.as_tensor(np.random.default_rng(2).random((3, H, W)).astype(
        np.float32))

    def run(mark=None):
        step(st, fixed, m.binding, models["cam"], gt, torch.zeros(3), 0,
             lrs, mark)
    return run


def _render(models):
    m = models["bound"]
    render = make_render_fn(m, PipelineConfig(tile_size=TILE), W, H,
                            m.active_sh_degree)

    def run(mark=None):
        return render(m.params, m.flame_param, m.binding, models["cam"],
                      torch.ones(3), 1, mark)
    return run


def _call(models, what):
    if what == "render":
        return _render(models)
    return _step(models, what.split("_")[0])


@pytest.mark.parametrize("what", sorted(GOLDEN))
def test_marks_in_order_with_the_tracer_off(models, what, monkeypatch):
    entered = []
    monkeypatch.setattr(trace, "record_function",
                        lambda name: entered.append(name))
    marks = []
    _call(models, what)(marks.append)
    assert marks == GOLDEN[what]
    assert trace.active() is None and trace.drain() == []
    assert entered == []
    assert trace.span("binning") is trace.span("blend") is trace.sync("s")


def test_spans_nest_under_their_roots(models):
    step, render = _step(models, "bound"), _render(models)
    trace.start()
    step()
    render()
    records = trace.drain()
    assert trace.drain() == []
    steps = [r for r in records if r.iteration == records[0].iteration]
    assert sorted(r.name for r in steps) == sorted(PARENT)
    for r in steps:
        assert (r.parent.name if r.parent else None) == PARENT[r.name]
        assert r.parent is None or r.parent.start_ns <= r.start_ns \
            <= r.end_ns <= r.parent.end_ns
    rendered = [r for r in records if r not in steps]
    assert {r.iteration for r in rendered} == {records[0].iteration + 1}
    assert rendered[0].name == "render" and rendered[0].parent is None
    assert [r.name for r in rendered if r.parent is rendered[0]] == [
        "flame_frames", "binding", "rasterize"]
    assert all(r.kind == (trace.SYNC if r.name.startswith("sync.")
                          else trace.STAGE) for r in records)


def test_self_time_is_duration_less_children(models):
    trace.start()
    _step(models, "bound")()
    records = trace.drain()
    own = trace.self_ns(records)
    for r, s in zip(records, own):
        kids = [c for c in records if c.parent is r]
        assert s == r.duration_ns - sum(c.duration_ns for c in kids)
        assert 0 <= s <= r.duration_ns
    totals = trace.totals(records)
    assert totals["train_step"]["n"] == 1
    assert totals["rasterize"]["self_ms"] == pytest.approx(
        own[[r.name for r in records].index("rasterize")] * 1e-6)
    # FLAME's copy from the host and the binning's two
    assert sum(t.get(trace.HOST_SYNCS, 0) for t in totals.values()) == 3


@pytest.mark.parametrize("binning", ["dense", "sort"])
def test_host_syncs_of_a_binning(binning):
    scene = tbench.make_bench_scene(n=500, seed=1, device="cpu")
    cam = tbench.make_camera(W, H, fovx=0.5, dist=1.0, device="cpu")
    proj = project_gaussians(scene["means3d"], scene["scales"],
                             scene["quats"], scene["opacities"],
                             scene["shs"], 3, cam)
    trace.start()
    with trace.span("root"):
        bins = rasterize_tiles.bin_projected(proj, W, H, TILE,
                                             binning=binning)
    records = trace.drain()
    assert bins.total > 0
    syncs = [r for r in records if r.kind == trace.SYNC]
    assert [r.name for r in syncs] == ["sync.slots", "sync.keep"]
    assert [r.counters for r in syncs] == [{trace.HOST_SYNCS: 1}] * 2
    assert trace.totals(records)["root"] == pytest.approx(
        {"n": 1, "ms": records[0].duration_ns * 1e-6,
         "self_ms": trace.self_ns(records)[0] * 1e-6})


def test_host_sync_of_to_wire():
    trace.start()
    wire = to_wire(torch.rand(3, 4, 5))
    records = trace.drain()
    assert wire.shape == (4, 5, 3) and wire.dtype == np.uint8
    assert [(r.name, r.kind, r.parent.name if r.parent else None)
            for r in records] == [("to_wire", trace.STAGE, None),
                                  ("sync.to_host", trace.SYNC, "to_wire")]
    assert records[1].counters == {trace.HOST_SYNCS: 1}
    # an array is converted on the host: no span
    to_wire(np.zeros((3, 2, 2), np.float32))
    assert trace.drain() == []


def test_profiler_ranges_on_the_trace_clock(models, tmp_path):
    step, render = _step(models, "bound"), _render(models)
    tracer = trace.start()
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        step()
        to_wire(render().image)
    records = trace.drain()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as fh:
        doc = json.load(fh)
    base = doc.get("baseTimeNanoseconds", 0)
    ranges = {}
    for e in doc["traceEvents"]:
        if e.get("name", "").startswith(trace.RANGE_PREFIX):
            ranges.setdefault(e["name"], []).append(e["ts"])
    assert len(records) == sum(len(v) for v in ranges.values())
    seen = {}
    for r in records:
        k = seen.get(r.name, 0)
        seen[r.name] = k + 1
        ts = sorted(ranges[trace.RANGE_PREFIX + r.name])[k]
        gap_ms = abs(tracer.wall_ns(r.start_ns) - (base + 1e3 * ts)) * 1e-6
        assert gap_ms < 2.0, (r.name, gap_ms)


def test_training_logs_iter_time_and_span_timings(tmp_path):
    """`training` on the small COLMAP scene of `test_torch_colmap.py`,
    under `profile_trace` (what `train --profile_dir` runs)."""
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator,
    )

    from .test_torch_colmap import _write_scene

    data = _write_scene(str(tmp_path / "scene"), "bin")
    out, prof = str(tmp_path / "out"), str(tmp_path / "prof")
    writer = ttb.SummaryWriter(out)
    with profile_trace(prof):
        training(ModelConfig(source_path=data, model_path=out, sh_degree=1),
                 OptimizationConfig(iterations=2, densify_from_iter=100,
                                    position_lr_max_steps=2),
                 PipelineConfig(tile_size=16), log_every=1,
                 tb_writer=writer, device="cpu")
    writer.close()
    assert trace.active() is None
    acc = EventAccumulator(out)
    acc.Reload()
    tags = acc.Tags()["scalars"]
    for tag in ("iter_time", "timing/train_step_ms", "timing/binning_ms",
                "timing/host_syncs"):
        assert [e.step for e in acc.Scalars(tag)] == [1, 2], tag
    assert all(e.value > 0 for e in acc.Scalars("iter_time"))
    assert [e.value for e in acc.Scalars("timing/host_syncs")] == [2, 2]
    assert "timing/blend_bwd_ms" in tags
    (path,) = glob.glob(os.path.join(prof, "trace_*.json"))
    with open(path) as fh:
        names = {e.get("name") for e in json.load(fh)["traceEvents"]}
    assert {"ga:train_step", "ga:sync.slots", "ga:blend_bwd"} <= names
