"""The port's training loop against the JAX package's `training`.

  * 20 iterations of both on the same DynamicNerf dataset, densification
    off, the loss read every iteration: the EMA loss histories agree
    within rtol 1e-3 (one train step agrees within 1e-5,
    `test_torch_train_step.py`; Adam's first steps divide each gradient by
    its own magnitude, which amplifies float32 differences), and the run
    writes the JAX package's artifacts;
  * resuming from a checkpoint of either package runs on;
  * `python -m gaussianavatars_torch.train --device cpu` trains 5
    iterations in a subprocess and writes its PLY; without `--device` it
    needs a GPU.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from gaussianavatars_tpu.config import ModelConfig as JaxModelConfig
from gaussianavatars_tpu.config import OptimizationConfig as JaxOpt
from gaussianavatars_tpu.config import PipelineConfig as JaxPipeline
from gaussianavatars_tpu.train.loop import training as jax_training
from gaussianavatars_torch.config import (
    ModelConfig,
    OptimizationConfig,
    PipelineConfig,
)
from gaussianavatars_torch.train import __main__ as train_cli
from gaussianavatars_torch.train.loop import training

from .test_torch_blend import one_torch_thread  # noqa: F401
from .torch_fixtures import make_port_avatar_dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCHEDULE = dict(iterations=20, densify_from_iter=100,
                opacity_reset_interval=1000, position_lr_max_steps=20)


def _cfg(data, out):
    return dict(source_path=data, model_path=out, bind_to_mesh=True,
                eval=True, sh_degree=1)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """20 iterations of each package (checkpoints at 10 and 20)."""
    root = tmp_path_factory.mktemp("train")
    data, assets = make_port_avatar_dataset(root)
    mp = pytest.MonkeyPatch()
    mp.setenv("FLAME_ASSET_DIR", assets)
    try:
        jax_out = str(root / "jax")
        _, jstate, jinfo = jax_training(
            JaxModelConfig(**_cfg(data, jax_out)), JaxOpt(**SCHEDULE),
            JaxPipeline(backend="jnp", capacity=1 << 18, chunk=16,
                        tile_size=16),
            checkpoint_iterations={10}, log_every=1)
        port_out = str(root / "port")
        model, state, info = training(
            ModelConfig(**_cfg(data, port_out)),
            OptimizationConfig(**SCHEDULE), PipelineConfig(tile_size=16),
            testing_iterations={20}, saving_iterations={20},
            checkpoint_iterations={10, 20}, log_every=1, device="cpu")
        yield dict(data=data, assets=assets, jax_out=jax_out,
                   port_out=port_out, jinfo=jinfo, jcount=int(jstate.count),
                   model=model, state=state, info=info, root=root)
    finally:
        mp.undo()


def test_loss_history_matches_jax(runs):
    jh = runs["jinfo"]["history"]
    th = runs["info"]["history"]
    assert [i for i, _ in th] == [i for i, _ in jh] == list(range(1, 21))
    np.testing.assert_allclose([v for _, v in th], [v for _, v in jh],
                               rtol=1e-3)
    assert th[-1][1] < th[0][1]
    assert runs["state"].count == runs["jcount"] == 20


def test_run_writes_artifacts(runs):
    out = runs["port_out"]
    for name in ("cfg.json", "cfg_args", "cameras.json", "chkpnt10.npz",
                 "chkpnt20.npz", "run_summary.json",
                 "point_cloud/iteration_20/point_cloud.ply",
                 "point_cloud/iteration_20/flame_param.npz"):
        assert os.path.exists(os.path.join(out, name)), name
    with open(os.path.join(out, "run_summary.json")) as f:
        summary = json.load(f)
    assert set(summary) == {"iterations", "elapsed_s", "final_ema_loss",
                            "n_alive", "densify", "opacity_reset"}
    assert summary["n_alive"] == runs["model"].num_gaussians == 10144
    assert summary["densify"] == summary["opacity_reset"] == 0
    metrics = runs["info"]["metrics"][20]
    assert set(metrics) == {"val", "test"}
    for m in metrics.values():
        assert set(m) == {"l1_loss", "psnr", "ssim"}
        assert all(np.isfinite(v) for v in m.values())
    with open(os.path.join(out, "cameras.json")) as f, \
            open(os.path.join(runs["jax_out"], "cameras.json")) as g:
        assert json.load(f) == json.load(g)


@pytest.mark.parametrize("package", ["port", "jax"])
def test_resume_from_checkpoint(runs, package, tmp_path, monkeypatch):
    monkeypatch.setenv("FLAME_ASSET_DIR", runs["assets"])
    ckpt = os.path.join(runs[f"{package}_out"], "chkpnt10.npz")
    model, state, info = training(
        ModelConfig(**_cfg(runs["data"], str(tmp_path / "resumed"))),
        OptimizationConfig(**dict(SCHEDULE, iterations=12)),
        PipelineConfig(tile_size=16), start_checkpoint=ckpt, log_every=1,
        device="cpu")
    assert state.count == 12
    assert [i for i, _ in info["history"]] == [11, 12]
    assert np.isfinite(info["ema_loss"])


def test_train_cli_on_cpu(runs, tmp_path):
    out = str(tmp_path / "cli")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               FLAME_ASSET_DIR=runs["assets"])
    res = subprocess.run(
        [sys.executable, "-m", "gaussianavatars_torch.train",
         "-s", runs["data"], "-m", out, "--bind_to_mesh", "--eval",
         "--sh_degree", "1", "--iterations", "5", "--tile_size", "16",
         "--device", "cpu", "--quiet"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout == ""
    assert os.path.exists(os.path.join(
        out, "point_cloud", "iteration_5", "point_cloud.ply"))
    assert os.path.exists(os.path.join(out, "chkpnt5.npz"))


def test_train_needs_a_gpu_unless_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        train_cli.main(["-s", str(tmp_path), "-m", str(tmp_path / "o"),
                        "--bind_to_mesh", "--iterations", "1"])
    # accepted, and like every other run it needs the GPU unless asked
    with pytest.raises(RuntimeError, match="CUDA"):
        train_cli.main(["-s", str(tmp_path), "-m", str(tmp_path / "o"),
                        "--detect_anomaly", "--debug_from", "1"])
    # the viewer and profiler flags are accepted now (and need the GPU);
    # multi-device training is still not ported
    with pytest.raises(RuntimeError, match="CUDA"):
        train_cli.main(["-s", str(tmp_path), "-m", str(tmp_path / "o"),
                        "--no_gui", "--profile_dir", str(tmp_path / "p"),
                        "--port", "0"])
    for argv in (["--distributed"], ["--profile_dir"]):
        with pytest.raises(SystemExit):
            train_cli.main(["-s", str(tmp_path)] + argv)


class _Hook:
    """Records every call made on it."""

    def __init__(self):
        self.calls = []
        self.conn = None

    def __getattr__(self, name):
        return lambda *a, **k: self.calls.append((name, a, k))


@pytest.mark.parametrize("arg", ["tb_writer", "gui"])
def test_unported_hooks_raise(arg, runs, tmp_path, monkeypatch):
    """The tensorboard writer and the network viewer, which `training`
    refused before they were ported, are used: the writer gets the losses
    and the number of Gaussians at every log point, the viewer is polled
    at the top of every iteration. A hook without their methods raises."""
    monkeypatch.setenv("FLAME_ASSET_DIR", runs["assets"])
    hook = _Hook()
    training(ModelConfig(**_cfg(runs["data"], str(tmp_path / "o"))),
             OptimizationConfig(**dict(SCHEDULE, iterations=2)),
             PipelineConfig(tile_size=16), log_every=1, device="cpu",
             **{arg: hook})
    names = [c[0] for c in hook.calls]
    if arg == "gui":
        assert names == ["try_connect", "try_connect"]
    else:
        steps = [c[1][2] for c in hook.calls if c[1][0] == "total_points"]
        assert steps == [1, 2]
        assert ("add_scalar", ("train_loss_patches/total_loss",
                               pytest.approx(runs["info"]["history"][0][1],
                                             rel=1e-3), 1), {}) in \
            hook.calls
    with pytest.raises(AttributeError):
        training(ModelConfig(model_path=str(tmp_path / "x"), **{
            k: v for k, v in _cfg(runs["data"], "").items()
            if k != "model_path"}),
            OptimizationConfig(**dict(SCHEDULE, iterations=1)),
            PipelineConfig(tile_size=16), log_every=1, device="cpu",
            **{arg: object()})
