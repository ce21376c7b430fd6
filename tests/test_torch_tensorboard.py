"""The port's tensorboard logging against the JAX package's, on the CPU.

The port loop with its own event writer (`utils/tensorboard.py`) and the
JAX loop with tensorboardX's `SummaryWriter` run the same 3 iterations
(losses read every iteration) with one evaluation at the end. Both event
files are read back with tensorboard's `EventAccumulator`:

  * the tag sets and the steps of every tag are equal, but for the port's
    `iter_time` (the reference's tag), logged at every log point;
  * scalars agree within rtol 1e-3 (the three-step tolerance of
    `test_torch_train_step.py`);
  * images have the same size; the val and test renders decode to pixels
    within 1 level (1/255); the error maps too, except where the two
    renders' difference of ~1e-6 moves a pixel's normalised error into
    the colour map's next bin (one of its 256 entries, at most 4 levels
    apart), on at most 1% of the pixels (measured: 13 of 6912);
  * the opacity histograms have equal bucket limits and `num`, and min,
    max and sum within rtol 1e-4; at most 0.1% of the values sit in
    another bucket. The opacities themselves differ after three Adam steps
    (measured: min 1.4e-5 relative, sum 1.5e-6, 3 values over a bucket
    edge); `test_records_equal_tensorboardx` holds the histogram of one
    set of values equal to tensorboardX's.

The writer itself: its records' CRCs, and its scalar, image and histogram
records equal tensorboardX's on the same inputs.

The profiler: `python -m gaussianavatars_torch.train --device cpu
--profile_dir <d>` for 2 iterations writes a Chrome trace that parses as
JSON and holds the train step's operations, beside the run's event file.
"""

import glob
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

from gaussianavatars_tpu.config import ModelConfig as JaxModelConfig
from gaussianavatars_tpu.config import OptimizationConfig as JaxOpt
from gaussianavatars_tpu.config import PipelineConfig as JaxPipeline
from gaussianavatars_tpu.train.loop import training as jax_training
from gaussianavatars_torch.config import (
    ModelConfig,
    OptimizationConfig,
    PipelineConfig,
)
from gaussianavatars_torch.train.loop import training
from gaussianavatars_torch.utils import tensorboard as ttb

from .test_torch_blend import one_torch_thread  # noqa: F401
from .torch_fixtures import make_port_avatar_dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCHEDULE = dict(iterations=3, densify_from_iter=100,
                opacity_reset_interval=1000, position_lr_max_steps=3)
ITERATIONS = SCHEDULE["iterations"]


def _accumulate(logdir):
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator,
    )

    acc = EventAccumulator(logdir, size_guidance={
        "scalars": 0, "images": 0, "histograms": 0})
    acc.Reload()
    return acc


@pytest.fixture(scope="module")
def logs(tmp_path_factory):
    from tensorboardX import SummaryWriter as JaxWriter

    root = tmp_path_factory.mktemp("tb")
    data, assets = make_port_avatar_dataset(root)
    mp = pytest.MonkeyPatch()
    mp.setenv("FLAME_ASSET_DIR", assets)
    cfg = dict(source_path=data, bind_to_mesh=True, eval=True, sh_degree=1)
    try:
        jdir, tdir = str(root / "jax"), str(root / "port")
        writer = JaxWriter(jdir)
        jax_training(JaxModelConfig(model_path=jdir, **cfg),
                     JaxOpt(**SCHEDULE),
                     JaxPipeline(backend="jnp", capacity=1 << 18, chunk=16,
                                 tile_size=16),
                     testing_iterations={ITERATIONS}, log_every=1,
                     tb_writer=writer)
        writer.close()
        writer = ttb.SummaryWriter(tdir)
        training(ModelConfig(model_path=tdir, **cfg),
                 OptimizationConfig(**SCHEDULE), PipelineConfig(tile_size=16),
                 testing_iterations={ITERATIONS}, log_every=1,
                 tb_writer=writer, device="cpu")
        writer.close()
        yield {"port": _accumulate(tdir), "jax": _accumulate(jdir),
               "port_dir": tdir, "data": data, "assets": assets}
    finally:
        mp.undo()


def test_tags_and_steps_match_jax(logs):
    t, j = logs["port"].Tags(), logs["jax"].Tags()
    # the port also logs the reference's `iter_time`, which the JAX loop
    # does not
    assert sorted(t["scalars"]) == sorted(j["scalars"] + ["iter_time"])
    for kind in ("images", "histograms"):
        assert sorted(t[kind]) == sorted(j[kind]), kind
    assert "total_points" in t["scalars"]
    assert "train_loss_patches/total_loss" in t["scalars"]
    assert "val/loss_viewpoint_-_psnr" in t["scalars"]
    # one val and one test camera at each of the 2 timesteps
    assert sorted(t["images"]) == [f"{s}_{k}/{n}" for s in ("test", "val")
                                   for k in (0, 1)
                                   for n in ("error", "render")]
    for tag in j["scalars"]:
        steps = [e.step for e in logs["port"].Scalars(tag)]
        assert steps == [e.step for e in logs["jax"].Scalars(tag)], tag
    for tag in ("total_points", "iter_time"):
        assert [e.step for e in logs["port"].Scalars(tag)] == \
            list(range(1, ITERATIONS + 1)), tag


def test_scalars_match_jax(logs):
    for tag in logs["jax"].Tags()["scalars"]:
        a = [e.value for e in logs["port"].Scalars(tag)]
        b = [e.value for e in logs["jax"].Scalars(tag)]
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-7, err_msg=tag)


def _pixels(event):
    return np.asarray(Image.open(io.BytesIO(event.encoded_image_string)))


def test_images_match_jax(logs):
    from gaussianavatars_torch.utils.image import _SEISMIC_LUT

    lut = np.round(_SEISMIC_LUT * 255.0)
    one_bin = np.abs(np.diff(lut, axis=0)).max() + 1    # + the truncation
    for tag in logs["jax"].Tags()["images"]:
        (a,), (b,) = logs["port"].Images(tag), logs["jax"].Images(tag)
        assert a.step == b.step == ITERATIONS
        assert (a.width, a.height) == (b.width, b.height) == (96, 72), tag
        pa, pb = _pixels(a), _pixels(b)
        assert pa.shape == pb.shape == (72, 96, 3), tag
        diff = np.abs(pa.astype(int) - pb.astype(int)).max(axis=-1)
        if tag.endswith("/render"):
            assert diff.max() <= 1, tag
        else:
            assert diff.max() <= one_bin, tag
            assert (diff > 1).mean() <= 0.01, tag


def test_histogram_matches_jax(logs):
    (a,), (b,) = (acc.Histograms("scene/opacity_histogram")
                  for acc in (logs["port"], logs["jax"]))
    assert a.step == b.step == ITERATIONS
    ha, hb = a.histogram_value, b.histogram_value
    assert ha.num == hb.num == 10144
    assert list(ha.bucket_limit) == list(hb.bucket_limit)
    for k in ("min", "max", "sum"):
        assert getattr(ha, k) == pytest.approx(getattr(hb, k), rel=1e-4), k
    moved = np.abs(np.subtract(ha.bucket, hb.bucket)).sum() / 2
    assert moved <= 0.001 * ha.num


def test_event_file_records(logs):
    """One `events.out.tfevents.<time>.<host>` file whose records all
    carry valid CRCs, the first the version record."""
    (path,) = glob.glob(os.path.join(logs["port_dir"],
                                     "events.out.tfevents.*"))
    records = ttb.read_tfrecords(path)
    assert ttb.FILE_VERSION.encode() in records[0]
    assert len(records) > 3 * ITERATIONS
    raw = open(path, "rb").read()
    bad = raw[:20] + bytes([raw[20] ^ 1]) + raw[21:]
    with open(path + ".bad", "wb") as f:
        f.write(bad)
    with pytest.raises(ValueError, match="CRC"):
        ttb.read_tfrecords(path + ".bad")


def test_crc32c_known_values():
    assert ttb.crc32c(b"") == 0
    assert ttb.crc32c(b"123456789") == 0xE3069283
    assert ttb.crc32c(bytes(32)) == 0x8A9136AA


@pytest.mark.parametrize("kind", ["scalar", "images", "histogram"])
def test_records_equal_tensorboardx(kind, tmp_path):
    """Each summary the port writes is, as a protobuf, tensorboardX's:
    the records differ only in their wall time."""
    from tensorboardX import SummaryWriter as XWriter
    from tensorboard.compat.proto import event_pb2

    rng = np.random.default_rng(3)
    img = rng.random((1, 3, 9, 13)).astype(np.float32)
    vals = np.concatenate([rng.random(500), -rng.random(20), [0.0, 5e3]])

    def log(w):
        if kind == "scalar":
            w.add_scalar("a/b - c", 0.125, 7)
        elif kind == "images":
            w.add_images("x/render", img, global_step=7)
        else:
            w.add_histogram("scene/opacity_histogram", vals, 7)

    events = {}
    for name, cls in (("port", ttb.SummaryWriter), ("x", XWriter)):
        w = cls(str(tmp_path / name))
        log(w)
        w.close()
        (path,) = glob.glob(str(tmp_path / name / "events.out.tfevents.*"))
        events[name] = []
        for rec in ttb.read_tfrecords(path):
            ev = event_pb2.Event.FromString(rec)
            ev.wall_time = 0.0
            events[name].append(ev)
    assert len(events["port"]) == len(events["x"]) == 2
    assert events["port"][0] == events["x"][0]            # the version
    a, b = events["port"][1], events["x"][1]
    if kind == "images":
        pa = _pixels(a.summary.value[0].image)
        pb = _pixels(b.summary.value[0].image)
        np.testing.assert_array_equal(pa, pb)
        for ev in (a, b):
            ev.summary.value[0].image.encoded_image_string = b""
    assert a == b


def test_train_cli_profile_dir_writes_a_trace(tmp_path):
    """On the small COLMAP scene of `test_torch_colmap.py` (300 points,
    48x40), whose plain CPU blend keeps the trace small."""
    from .test_torch_colmap import _write_scene

    data = _write_scene(str(tmp_path / "scene"), "bin")
    out, prof = str(tmp_path / "out"), str(tmp_path / "prof")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "gaussianavatars_torch.train", "-s", data,
         "-m", out, "--sh_degree", "1", "--iterations", "2", "--tile_size",
         "16", "--device", "cpu", "--no_gui", "--quiet", "--profile_dir",
         prof], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    (trace,) = glob.glob(os.path.join(prof, "trace_*.json"))
    assert os.path.getsize(trace) < 100 << 20
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any("index_add" in n for n in names)        # the step ran in it
    assert len(events) > 1000
    (events_file,) = glob.glob(os.path.join(out, "events.out.tfevents.*"))
    assert len(ttb.read_tfrecords(events_file)) > 2
