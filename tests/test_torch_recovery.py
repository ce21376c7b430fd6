"""The port's quality protocols against the JAX package's examples.

The JAX examples (`examples/bound_avatar_recovery.py`,
`examples/synthetic_recovery.py`) are loaded from their files, unchanged,
and cut to a tiny size through their module constants and arguments: the
bound protocol at 1 timestep x 2 rings x 2 cameras, the synthetic one at
2000 Gaussians and 4 + 2 views, both at 48x40, tile 16 for the port's
plain CPU blend where the JAX example lets the tile be chosen.

  * the datasets equal the JAX examples': FLAME parameters and assets
    exactly, cameras (transforms.json) within atol 1e-6, the painted
    ground-truth avatar within atol 1e-5 / rtol 1e-4 (the FLAME and
    face-frame tolerance; the colour field is sin(23 x) of the face
    centres and the scale cap divides by the face scale), the point-cloud
    init exactly, the images within one level;
  * 3 iterations of the port's `training` and the JAX package's on the
    JAX example's dataset, with the example's schedule, agree as the loop
    tests' do (the EMA loss history within rtol 1e-3).
"""

import importlib.util
import json
import math
import os

import numpy as np
import pytest
import torch
from PIL import Image

from gaussianavatars_tpu.config import ModelConfig as JaxModelConfig
from gaussianavatars_tpu.config import OptimizationConfig as JaxOpt
from gaussianavatars_tpu.config import PipelineConfig as JaxPipeline
from gaussianavatars_tpu.data.scene import Scene as JaxScene
from gaussianavatars_tpu.models.flame_gaussians import (
    FlameGaussianModel as JaxFlameGaussianModel,
)
from gaussianavatars_tpu.train.loop import training as jax_training
from gaussianavatars_torch.config import (
    ModelConfig,
    OptimizationConfig,
    PipelineConfig,
)
from gaussianavatars_torch.data.scene import Scene
from gaussianavatars_torch.examples import bound_avatar_recovery as bound
from gaussianavatars_torch.examples import synthetic_recovery as synth
from gaussianavatars_torch.models.flame_gaussians import FlameGaussianModel
from gaussianavatars_torch.train.loop import training

from .test_torch_blend import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H = 48, 40
T_STEPS, N_CAMS = 1, 2
N_GT, N_TRAIN, N_TEST = 2000, 4, 2
ITERS = 3


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", os.path.join(REPO, "examples", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _png(path):
    return np.asarray(Image.open(path)).astype(np.int64)


def _bound_cfg(data, out, cls):
    return cls(source_path=data, model_path=out, bind_to_mesh=True,
               eval=True, sh_degree=2, white_background=True,
               not_finetune_flame_params=True)


def _schedule(iterations, densify_from, densify_until, interval):
    return dict(iterations=iterations, densify_from_iter=densify_from,
                densify_until_iter=densify_until,
                densification_interval=interval,
                opacity_reset_interval=10 * iterations,
                position_lr_max_steps=iterations)


@pytest.fixture(scope="module")
def bound_sets(tmp_path_factory):
    """The bound protocol's dataset written by both packages."""
    root = tmp_path_factory.mktemp("bound")
    jmod = _load("bound_avatar_recovery")
    jmod.T_STEPS, jmod.N_CAMS, jmod.HOLD_OUT = T_STEPS, N_CAMS, N_CAMS // 2
    mp = pytest.MonkeyPatch()
    try:
        out = {}
        for pkg in ("jax", "port"):
            data, assets = str(root / pkg / "data"), str(root / pkg / "assets")
            model_path = str(root / pkg / "gt")
            os.makedirs(model_path)
            if pkg == "jax":
                jmod.write_dataset(data, assets, W, H)
                mp.setenv("FLAME_ASSET_DIR", assets)
                cfg = _bound_cfg(data, model_path, JaxModelConfig)
                model = JaxFlameGaussianModel(cfg.sh_degree)
                scene = JaxScene(cfg, model)
                jmod.paint_gt_model(model)
                jmod.render_gt_images(model, scene, cfg, JaxPipeline(
                    backend="jnp", capacity=1 << 18, chunk=16, tile_size=16))
                params = {k: np.asarray(v)[:model.n_alive]
                          for k, v in model.params._asdict().items()}
            else:
                bound.write_dataset(data, assets, W, H, t_steps=T_STEPS,
                                    n_cams=N_CAMS)
                mp.setenv("FLAME_ASSET_DIR", assets)
                cfg = _bound_cfg(data, model_path, ModelConfig)
                model = FlameGaussianModel.from_assets(cfg.sh_degree,
                                                       device="cpu")
                scene = Scene(cfg, model)
                bound.paint_gt_model(model)
                bound.render_gt_images(model, scene, cfg,
                                       PipelineConfig(tile_size=16),
                                       torch.device("cpu"))
                params = {k: v.numpy() for k, v in
                          model.params._asdict().items()}
            out[pkg] = dict(data=data, assets=assets, params=params)
        yield out
    finally:
        mp.undo()


def test_bound_dataset_matches_jax(bound_sets):
    j, t = bound_sets["jax"], bound_sets["port"]
    for name in sorted(os.listdir(j["assets"])):
        with open(os.path.join(j["assets"], name), "rb") as f, \
                open(os.path.join(t["assets"], name), "rb") as g:
            assert f.read() == g.read(), name
    fp = sorted(os.listdir(os.path.join(j["data"], "flame_param")))
    assert fp == sorted(os.listdir(os.path.join(t["data"], "flame_param")))
    assert len(fp) == T_STEPS
    for name in fp + ["../canonical_flame_param.npz"]:
        a = np.load(os.path.join(j["data"], "flame_param", name))
        b = np.load(os.path.join(t["data"], "flame_param", name))
        assert set(a.files) == set(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    n_images = 0
    for split in ("train", "val", "test"):
        with open(os.path.join(j["data"], f"transforms_{split}.json")) as f:
            jt = json.load(f)
        with open(os.path.join(t["data"], f"transforms_{split}.json")) as f:
            tt = json.load(f)
        assert jt["camera_angle_x"] == tt["camera_angle_x"]
        assert len(jt["frames"]) == len(tt["frames"]) > 0
        for a, b in zip(jt["frames"], tt["frames"]):
            np.testing.assert_allclose(a.pop("transform_matrix"),
                                       b.pop("transform_matrix"), atol=1e-6)
            assert a == b
            d = np.abs(_png(os.path.join(j["data"], a["file_path"]))
                       - _png(os.path.join(t["data"], b["file_path"])))
            assert d.max() <= 1, (split, a["file_path"], d.max())
            n_images += 1
    assert n_images == T_STEPS * 2 * N_CAMS
    for k, v in j["params"].items():
        np.testing.assert_allclose(t["params"][k], v, atol=1e-5, rtol=1e-4,
                                   err_msg=k)


def test_bound_training_matches_jax(bound_sets, tmp_path, monkeypatch):
    """3 iterations of the bound protocol's schedule, both packages on the
    JAX example's dataset."""
    j = bound_sets["jax"]
    monkeypatch.setenv("FLAME_ASSET_DIR", j["assets"])
    schedule = _schedule(ITERS, 400, int(0.7 * ITERS), 300)
    _, jstate, jinfo = jax_training(
        _bound_cfg(j["data"], str(tmp_path / "jax"), JaxModelConfig),
        JaxOpt(**schedule),
        JaxPipeline(backend="jnp", capacity=1 << 18, chunk=16, tile_size=16),
        log_every=1)
    model, state, info = training(
        _bound_cfg(j["data"], str(tmp_path / "port"), ModelConfig),
        OptimizationConfig(**schedule), PipelineConfig(tile_size=16),
        log_every=1, device="cpu")
    jh, th = jinfo["history"], info["history"]
    assert [i for i, _ in th] == [i for i, _ in jh] == list(range(1, 4))
    np.testing.assert_allclose([v for _, v in th], [v for _, v in jh],
                               rtol=1e-3)
    assert state.count == int(jstate.count) == ITERS
    assert model.num_gaussians == 10144 and not state.flame_tr


@pytest.fixture(scope="module")
def synth_sets(tmp_path_factory):
    """The synthetic protocol's dataset written by both packages."""
    import jax.numpy as jnp

    import gaussianavatars_tpu.utils.ply as jply

    root = tmp_path_factory.mktemp("synth")
    jmod = _load("synthetic_recovery")
    jroot, troot = str(root / "jax"), str(root / "port")
    jgt = jmod.make_gt_scene(n=N_GT)
    jmod.render_dataset(jroot, jgt, W, H, fovx=0.8, n_train=N_TRAIN,
                        n_test=N_TEST)
    # the JAX example's init, as its main() draws it
    rng = np.random.default_rng(1)
    xyz = np.asarray(jgt["means3d"])[::4] + rng.normal(
        0, 0.02, (len(jgt["means3d"][::4]), 3))
    jply.store_point_cloud(os.path.join(jroot, "points3d.ply"), xyz,
                           rng.random((len(xyz), 3)) * 255)

    tgt = synth.make_gt_scene(n=N_GT, device="cpu")
    synth.render_dataset(troot, tgt, W, H, fovx=0.8, n_train=N_TRAIN,
                         n_test=N_TEST, tile_size=16)
    synth.write_noisy_init(troot, tgt)
    yield dict(jax=jroot, port=troot,
               jgt={k: np.asarray(v) for k, v in jgt.items()},
               tgt={k: v.numpy() for k, v in tgt.items()},
               jnp=jnp)


def test_synthetic_dataset_matches_jax(synth_sets):
    j, t = synth_sets["jax"], synth_sets["port"]
    for k, v in synth_sets["jgt"].items():
        np.testing.assert_array_equal(synth_sets["tgt"][k], v, err_msg=k)
    with open(os.path.join(j, "points3d.ply"), "rb") as f, \
            open(os.path.join(t, "points3d.ply"), "rb") as g:
        assert f.read() == g.read()
    n_images = 0
    for split in ("train", "test"):
        with open(os.path.join(j, f"transforms_{split}.json")) as f:
            jt = json.load(f)
        with open(os.path.join(t, f"transforms_{split}.json")) as f:
            tt = json.load(f)
        assert jt["camera_angle_x"] == tt["camera_angle_x"]
        for a, b in zip(jt["frames"], tt["frames"], strict=True):
            assert a["file_path"] == b["file_path"]
            np.testing.assert_allclose(a["transform_matrix"],
                                       b["transform_matrix"], atol=1e-6)
            ja = _png(os.path.join(j, a["file_path"] + ".png"))
            ta = _png(os.path.join(t, b["file_path"] + ".png"))
            assert ja.shape == ta.shape == (H, W, 4)
            assert np.abs(ja - ta).max() <= 1, a["file_path"]
            assert (ta[..., 3] == 255).all() and ta[..., :3].min() < 200
            n_images += 1
    assert n_images == N_TRAIN + N_TEST


def test_synthetic_training_matches_jax(synth_sets, tmp_path):
    """3 iterations of the synthetic protocol's schedule, both packages on
    the JAX example's dataset and init."""
    data = synth_sets["jax"]
    schedule = _schedule(ITERS, 500, int(0.75 * ITERS), 300)

    def cfg(cls, out):
        return cls(source_path=data, model_path=str(tmp_path / out),
                   bind_to_mesh=False, eval=True, sh_degree=3,
                   white_background=True)

    _, jstate, jinfo = jax_training(
        cfg(JaxModelConfig, "jax"), JaxOpt(**schedule),
        JaxPipeline(backend="jnp", capacity=1 << 18, chunk=16, tile_size=16),
        log_every=1)
    model, state, info = training(
        cfg(ModelConfig, "port"), OptimizationConfig(**schedule),
        PipelineConfig(tile_size=16), log_every=1, device="cpu")
    jh, th = jinfo["history"], info["history"]
    assert [i for i, _ in th] == [i for i, _ in jh] == list(range(1, 4))
    np.testing.assert_allclose([v for _, v in th], [v for _, v in jh],
                               rtol=1e-3)
    assert state.count == int(jstate.count) == ITERS
    assert model.binding is None and model.num_gaussians == N_GT // 4
    assert math.isfinite(info["ema_loss"])
