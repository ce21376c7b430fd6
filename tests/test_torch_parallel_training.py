"""The port's training loop on the process mesh: `training` with
`render_parallel=2` on two gloo CPU ranks (`tests/torch_ranks.py`) across a
densification against JAX `training` with the same config on the virtual
CPU mesh (EMA loss history rtol 2e-2 / atol 2e-3, JAX
`tests/test_parallel_training.py`'s own tolerance; the same Gaussian
count; rank 0 alone writes the PLY), and `python -m
gaussianavatars_torch.train --distributed` as two processes with torchrun's
variables, render- and data-parallel."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from gaussianavatars_tpu.config import ModelConfig as JaxModelConfig
from gaussianavatars_tpu.config import OptimizationConfig as JaxOpt
from gaussianavatars_tpu.config import PipelineConfig as JaxPipeline
from gaussianavatars_tpu.train.loop import training as jax_training

from gaussianavatars_torch.config import (
    ModelConfig,
    OptimizationConfig,
    PipelineConfig,
)
from gaussianavatars_torch.render import __main__ as render_cli
from gaussianavatars_torch.train.loop import training

from . import torch_ranks
from .test_torch_blend import one_torch_thread  # noqa: F401
from .torch_fixtures import make_port_avatar_dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# densification at iteration 4; its threshold (JAX
# `tests/test_stretch_configs.py`'s) clones or splits every Gaussian seen,
# so no count hangs on a gradient at float32 noise from the threshold
SCHEDULE = dict(iterations=8, densification_interval=4, densify_from_iter=2,
                densify_until_iter=8, opacity_reset_interval=1000,
                position_lr_max_steps=8, densify_grad_threshold=1e-12)


def _train_cfg(data, out):
    return dict(source_path=data, model_path=out, bind_to_mesh=True,
                eval=True, sh_degree=1)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return make_port_avatar_dataset(tmp_path_factory.mktemp("pardata"))


def test_parallel_training_matches_jax(dataset, tmp_path, monkeypatch):
    """`training` with render_parallel=2 on two ranks across a
    densification against JAX `training` on a (1, 2) mesh; rank 0 alone
    writes the PLY."""
    data, assets = dataset
    monkeypatch.setenv("FLAME_ASSET_DIR", assets)
    torch_ranks.run_ranks(
        torch_ranks.train_loop, 2, tmp_path, data=data, assets=assets,
        out=str(tmp_path / "port"), schedule=SCHEDULE, render_parallel=2)
    jmodel, jstate, jinfo = jax_training(
        JaxModelConfig(**_train_cfg(data, str(tmp_path / "jax"))),
        JaxOpt(**SCHEDULE),
        JaxPipeline(backend="jnp", capacity=1 << 18, chunk=16, tile_size=16,
                    render_parallel=2),
        saving_iterations={8}, log_every=1)
    runs = [dict(np.load(tmp_path / f"loop_{r}.npz")) for r in range(2)]
    for run in runs[1:]:
        for k in runs[0]:
            np.testing.assert_array_equal(run[k], runs[0][k], err_msg=k)
    port = runs[0]
    jhist = np.asarray([v for _, v in jinfo["history"]])
    np.testing.assert_allclose(port["history"], jhist, rtol=2e-2, atol=2e-3)
    assert int(port["count"]) == int(jstate.count) == 8
    assert int(port["densify"]) == 1
    assert int(port["n"]) == jmodel.n_alive > 10144
    saves = [int(np.load(tmp_path / f"saves_{r}.npy")) for r in range(2)]
    assert saves == [1, 0]
    assert os.path.exists(tmp_path / "port" / "point_cloud" / "iteration_8"
                          / "point_cloud.ply")


@pytest.mark.parametrize("axis", ["--render_parallel", "--data_parallel"])
def test_train_cli_distributed(axis, dataset, tmp_path, monkeypatch):
    """`python -m gaussianavatars_torch.train --distributed
    --render_parallel 2 --device cpu` (and `--data_parallel 2`) as two
    processes with torchrun's variables: both finish, rank 0 alone prints
    and writes the PLY, the checkpoint and the event file, which the
    one-device `render` and `--start_checkpoint` read."""
    data, assets = dataset
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    out = str(tmp_path / "cli")
    procs = []
    for rank in range(2):
        env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
                   FLAME_ASSET_DIR=assets, RANK=str(rank), WORLD_SIZE="2",
                   LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "gaussianavatars_torch.train",
             "-s", data, "-m", out, "--bind_to_mesh", "--eval",
             "--sh_degree", "1", "--iterations", "3", "--tile_size", "16",
             "--device", "cpu", "--distributed", axis, "2"]
            # the render-parallel run serves the viewer (no client comes)
            + (["--port", "0"] if axis == "--render_parallel"
               else ["--no_gui"]),
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    results = []
    try:
        for p in procs:
            results.append(p.communicate(timeout=240))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (_, err) in zip(procs, results):
        assert p.returncode == 0, err[-2000:]
    assert "Training complete" in results[0][0]
    assert results[1][0] == ""            # rank 1 prints nothing
    assert os.path.exists(os.path.join(
        out, "point_cloud", "iteration_3", "point_cloud.ply"))
    assert os.path.exists(os.path.join(out, "chkpnt3.npz"))
    events = [f for f in os.listdir(out) if f.startswith("events.out")]
    assert len(events) == 1

    monkeypatch.setenv("FLAME_ASSET_DIR", assets)
    render_cli.main(["-m", out, "--skip_train", "--skip_val", "--device",
                     "cpu", "--quiet"])
    assert len(os.listdir(os.path.join(out, "test", "ours_3", "renders"))) \
        == 2
    _, state, info = training(
        ModelConfig(**_train_cfg(data, str(tmp_path / "resumed"))),
        OptimizationConfig(iterations=4), PipelineConfig(tile_size=16),
        start_checkpoint=os.path.join(out, "chkpnt3.npz"), log_every=1,
        device="cpu")
    assert state.count == 4 and [i for i, _ in info["history"]] == [4]
