"""The port's data layer and configuration against the JAX package's.

On the JAX tests' avatar fixture (48x40, 2 timesteps, 3 cameras):
  * `Scene` gives the same cameras (R, T, FoV, sizes, background,
    timestep, camera id, image path) in the same shuffled order, the same
    FLAME parameters, `cameras_extent`, `cameras.json` and initial
    Gaussians (exactly);
  * `load_camera_image` matches within atol 1e-6 (RGB, RGBA composited on
    the background, gray);
  * the first 2 epochs of `CameraLoader(seed=0)` deliver the same cameras.
Also: resized views (the auto-cap, -r 2 and -r 4 of RGB and RGBA
sources) within 2/255 of the JAX loader's PIL resize, a `sparse/` folder
read as COLMAP, camera matrices and `camera_to_json`, the configuration
classes and files, and the image metrics and error map.
"""

import json
import os
import random
from argparse import ArgumentParser

import numpy as np
import pytest
import torch
from PIL import Image

from gaussianavatars_tpu import config as jax_config
from gaussianavatars_tpu.data import cameras as jax_cameras
from gaussianavatars_tpu.data import loader as jax_loader
from gaussianavatars_tpu.data.scene import Scene as JaxScene
from gaussianavatars_tpu.models.flame_gaussians import (
    FlameGaussianModel as JaxFlameModel,
)
from gaussianavatars_tpu.ops import transforms as jax_transforms
from gaussianavatars_tpu.utils import image as jax_image
from gaussianavatars_torch import config
from gaussianavatars_torch.data import cameras, loader
from gaussianavatars_torch.data.scene import Scene
from gaussianavatars_torch.models.flame_gaussians import FlameGaussianModel
from gaussianavatars_torch.ops import transforms
from gaussianavatars_torch.utils import image, system

from .dataset_fixtures import make_avatar_dataset
from .test_torch_blend import one_torch_thread  # noqa: F401

CAMERA_FIELDS = ("uid", "fovx", "fovy", "width", "height", "image_path",
                 "image_name", "timestep", "camera_id")


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    root = tmp_path_factory.mktemp("ds")
    data_dir, asset_dir = make_avatar_dataset(str(root))
    mp = pytest.MonkeyPatch()
    mp.setenv("FLAME_ASSET_DIR", asset_dir)
    try:
        kw = dict(source_path=data_dir, bind_to_mesh=True, eval=True,
                  sh_degree=1)
        (root / "jax").mkdir()
        random.seed(0)
        jmodel = JaxFlameModel(1)
        jscene = JaxScene(jax_config.ModelConfig(
            model_path=str(root / "jax"), **kw), jmodel)
        random.seed(0)
        tmodel = FlameGaussianModel.from_assets(1, device="cpu")
        tscene = Scene(config.ModelConfig(model_path=str(root / "port"),
                                          **kw), tmodel)
        yield jscene, jmodel, tscene, tmodel, root
    finally:
        mp.undo()


def _same_cameras(got, ref):
    assert len(got) == len(ref) > 0
    for g, r in zip(got, ref):
        for k in CAMERA_FIELDS:
            assert getattr(g, k) == getattr(r, k), k
        for k in ("R", "T", "bg"):
            np.testing.assert_array_equal(getattr(g, k), getattr(r, k), k)


def test_scene_matches_jax(scenes):
    jscene, jmodel, tscene, tmodel, root = scenes
    assert len(tscene.get_train_cameras()) == 4
    _same_cameras(tscene.get_train_cameras(), jscene.get_train_cameras())
    _same_cameras(tscene.get_val_cameras(), jscene.get_val_cameras())
    _same_cameras(tscene.get_test_cameras(), jscene.get_test_cameras())
    assert tscene.cameras_extent == jscene.cameras_extent > 0
    assert tmodel.num_timesteps == jmodel.num_timesteps == 2
    for k, v in jmodel.flame_param.items():
        np.testing.assert_array_equal(tmodel.flame_param[k].numpy(),
                                      np.asarray(v), err_msg=k)
        np.testing.assert_array_equal(tmodel.flame_param_orig[k],
                                      jmodel.flame_param_orig[k])
    with open(root / "port" / "cameras.json") as f, \
            open(root / "jax" / "cameras.json") as g:
        assert json.load(f) == json.load(g)


def test_scene_initial_gaussians_match_jax(scenes):
    _, jmodel, _, tmodel, _ = scenes
    n = jmodel.n_alive
    assert tmodel.num_gaussians == n == tmodel.flame_model.num_faces
    assert tmodel.active_sh_degree == jmodel.active_sh_degree == 0
    assert tmodel.spatial_lr_scale == jmodel.spatial_lr_scale
    for k in tmodel.params._fields:
        np.testing.assert_array_equal(getattr(tmodel.params, k).numpy(),
                                      np.asarray(getattr(jmodel.params, k))[:n],
                                      err_msg=k)
    np.testing.assert_array_equal(tmodel.binding.numpy(), jmodel.binding[:n])


def test_scene_raises_on_colmap(tmp_path):
    """A `sparse/` folder is read as a COLMAP scene, as the JAX package
    reads it: without its files both raise the same error."""
    (tmp_path / "sparse").mkdir()
    cfg = config.ModelConfig(source_path=str(tmp_path),
                             model_path=str(tmp_path / "out"))
    with pytest.raises(FileNotFoundError, match="images.txt"):
        Scene(cfg, None)
    with pytest.raises(FileNotFoundError, match="images.txt"):
        JaxScene(jax_config.ModelConfig(source_path=str(tmp_path),
                                        model_path=str(tmp_path / "out")),
                 None)


def test_load_camera_image_matches_jax(scenes):
    jscene, _, tscene, _, _ = scenes
    for split in ("get_train_cameras", "get_val_cameras",
                  "get_test_cameras"):
        for jc, tc in zip(getattr(jscene, split)(), getattr(tscene, split)()):
            got = loader.load_camera_image(tc)
            assert got.shape == (3, 40, 48) and got.dtype == np.float32
            np.testing.assert_allclose(got, jax_loader.load_camera_image(jc),
                                       atol=1e-6, rtol=0)


@pytest.mark.parametrize("mode", ["RGBA", "L"])
def test_load_composited_and_gray_images(mode, tmp_path):
    rng = np.random.default_rng(4)
    shape = (24, 30, 4) if mode == "RGBA" else (24, 30)
    path = str(tmp_path / f"img_{mode}.png")
    Image.fromarray(rng.integers(0, 256, shape, dtype=np.uint8),
                    mode).save(path)
    common = dict(uid=0, R=np.eye(3), T=np.zeros(3), fovx=0.8, fovy=0.7,
                  width=30, height=24, image_path=path,
                  bg=np.asarray([1.0, 0.5, 0.0], np.float32))
    got = loader.load_camera_image(cameras.Camera(**common))
    ref = jax_loader.load_camera_image(jax_cameras.Camera(**common))
    assert got.shape == (3, 24, 30)
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


def test_loader_order_matches_jax(scenes):
    jscene, _, tscene, _, _ = scenes
    jl = jax_loader.CameraLoader(jscene.get_train_cameras(), seed=0)
    tl = loader.CameraLoader(tscene.get_train_cameras(), seed=0)
    try:
        n = 2 * len(tscene.get_train_cameras())
        jseq = [next(jl)[0].image_path for _ in range(n)]
        tseq = []
        for _ in range(n):
            cam, img = next(tl)
            assert img.shape == (3, 40, 48)
            tseq.append(cam.image_path)
    finally:
        jl.stop()
        tl.stop()
    assert tseq == jseq
    assert sorted(tseq[:n // 2]) == sorted(tseq[n // 2:])   # whole epochs
    assert not any(t.is_alive() for t in tl._threads)


@pytest.mark.parametrize("mode", ["RGB", "RGBA"])
@pytest.mark.parametrize("size,resolution", [((1700, 30), -1),
                                             ((131, 97), 2),
                                             ((131, 97), 4)])
def test_resize_matches_jax(mode, size, resolution, tmp_path):
    """A resized view (the 1600 px auto-cap, -r 2, -r 4) equals the JAX
    loader's, which resizes with PIL's bicubic default before compositing
    RGBA onto the background, within 2/255."""
    w, h = size
    rng = np.random.default_rng(7)
    yy, xx = np.mgrid[0:h, 0:w]
    smooth = 127.5 + 120 * np.sin(xx / 17.0 + yy / 11.0)[..., None] \
        * np.float64([1.0, -0.7, 0.4])
    img = np.clip(smooth + rng.normal(0, 25, (h, w, 3)), 0, 255)
    if mode == "RGBA":
        alpha = np.clip(xx * 300.0 / w - 20, 0, 255)[..., None]
        img = np.concatenate([img, alpha], axis=-1)
    path = str(tmp_path / f"view_{mode}.png")
    Image.fromarray(img.astype(np.uint8), mode).save(path)
    common = dict(uid=0, R=np.eye(3), T=np.zeros(3), fovx=1.0, fovy=0.1,
                  width=w, height=h, image_path=path,
                  bg=np.float32([0.2, 0.5, 1.0]))
    tcam, jcam = cameras.Camera(**common), jax_cameras.Camera(**common)
    tw, th = tcam.resolution(resolution)
    assert (tw, th) == jcam.resolution(resolution) != (w, h)
    got = loader.load_camera_image(tcam, resolution)
    ref = jax_loader.load_camera_image(jcam, resolution)
    assert got.shape == ref.shape == (3, th, tw) and got.dtype == np.float32
    assert np.abs(got - ref).max() <= 2.0 / 255.0


def test_camera_params_match_jax():
    rng = np.random.default_rng(2)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    common = dict(uid=3, R=q, T=rng.normal(size=3), fovx=0.9, fovy=0.7,
                  width=64, height=48, image_name="x", timestep=1)
    tcam, jcam = cameras.Camera(**common), jax_cameras.Camera(**common)
    got, ref = tcam.to_params(device="cpu"), jcam.to_params()
    for k in ("viewmatrix", "projmatrix", "campos"):
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(ref, k)))
    for k in ("tan_fovx", "tan_fovy", "width", "height"):
        assert getattr(got, k) == getattr(ref, k)
    assert tcam.to_params(device="cpu") is got               # built once
    assert tcam.to_params(32, 24, device="cpu").width == 32
    assert cameras.camera_to_json(3, tcam) == \
        jax_cameras.camera_to_json(3, jcam)
    wv = tcam.world_view_transform()
    mini = dict(width=64, height=48, fovx=0.9, fovy=0.7, znear=0.01,
                zfar=100.0, world_view_transform=wv,
                full_proj_transform=got.projmatrix.numpy())
    tmini = cameras.MiniCam(**mini).to_params(device="cpu")
    jmini = jax_cameras.MiniCam(**mini).to_params()
    for k in ("viewmatrix", "projmatrix", "campos"):
        np.testing.assert_array_equal(getattr(tmini, k).numpy(),
                                      np.asarray(getattr(jmini, k)))
    for f, p in ((0.7, 48), (1.3, 802)):
        assert transforms.fov2focal(f, p) == jax_transforms.fov2focal(f, p)
        assert transforms.focal2fov(f * 100, p) == \
            jax_transforms.focal2fov(f * 100, p)


def test_config_matches_jax(tmp_path):
    tpu_only = {"backend", "chunk", "capacity", "slab_tile_rows",
                "level_scale", "level_scales"}
    for name in ("ModelConfig", "OptimizationConfig", "PipelineConfig"):
        got = vars(getattr(config, name)())
        ref = vars(getattr(jax_config, name)())
        assert set(ref) - set(got) <= tpu_only, name
        for k, v in got.items():
            if k != "data_device":
                assert ref[k] == v, (name, k)

    parser = ArgumentParser()
    for cls in (config.ModelConfig, config.OptimizationConfig,
                config.PipelineConfig):
        cls.add_to_parser(parser)
    args = parser.parse_args(["-s", "data", "-m", str(tmp_path), "-w",
                              "--iterations", "7", "--tile_size", "16",
                              "--bind_to_mesh", "--convert_SHs_python",
                              "--debug"])
    model_cfg = config.ModelConfig.extract(args)
    assert model_cfg.white_background and model_cfg.bind_to_mesh
    assert model_cfg.source_path == os.path.abspath("data")
    assert config.OptimizationConfig.extract(args).iterations == 7
    assert config.PipelineConfig.extract(args) == config.PipelineConfig(
        convert_SHs_python=True, debug=True, tile_size=16)

    config.save_config(str(tmp_path), model_cfg)
    assert config.load_config(str(tmp_path)) == model_cfg
    assert jax_config.load_config(str(tmp_path)).source_path == \
        model_cfg.source_path
    assert "Namespace(" in (tmp_path / "cfg_args").read_text()
    render = ArgumentParser()
    config.ModelConfig.add_to_parser(render, sentinel=True)
    merged = config.get_combined_config(render, ["-m", str(tmp_path),
                                                 "--sh_degree", "1"])
    assert merged.sh_degree == 1 and merged.white_background
    assert merged.source_path == model_cfg.source_path


def test_image_metrics_match_jax():
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    a, b = (rng.random((3, 16, 12)).astype(np.float32) for _ in range(2))
    np.testing.assert_allclose(
        image.l2_loss(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jax_image.l2_loss(jnp.asarray(a), jnp.asarray(b))),
        rtol=1e-6)
    np.testing.assert_array_equal(image.error_map(a, b),
                                  jax_image.error_map(a, b))


def test_system_utils(tmp_path):
    for n in (1, 30, 7):
        system.mkdir_p(str(tmp_path / f"iteration_{n}"))
    assert system.search_for_max_iteration(str(tmp_path)) == 30
    system.safe_state(3)
    first = (random.random(), np.random.random(), torch.rand(1).item())
    system.safe_state(3)
    assert (random.random(), np.random.random(), torch.rand(1).item()) \
        == first


@pytest.mark.parametrize("fits", [0, 1, 3])
def test_ground_truth_cache_budget(fits):
    """The training loop's device cache keeps the views that fit its budget
    in first-use order and hands those back without a copy; a view past
    the budget is copied again on each use, with the same values."""
    from gaussianavatars_torch.train.loop import GroundTruthCache

    imgs = [np.full((3, 4, 5), v, np.float32) for v in range(3)]
    cache = GroundTruthCache("cpu", fits * imgs[0].nbytes)
    first = [cache.get(v, img) for v, img in enumerate(imgs)]
    again = [cache.get(v, img) for v, img in enumerate(imgs)]
    for v, (a, b) in enumerate(zip(first, again)):
        assert (a is b) == (v < fits), v
        assert torch.equal(a, b) and float(b[0, 0, 0]) == v
    assert sorted(cache.images) == list(range(fits))
    assert cache.nbytes == fits * imgs[0].nbytes
