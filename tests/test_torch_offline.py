"""The port's offline tools against the JAX package's, on the CPU:

  * LPIPS with synthetic weights from a seed against the JAX `LPIPS`: rtol
    1e-4, and 0 (<= 1e-6) for identical images; the weights converter
    writes the same file;
  * the mesh renderer against the JAX one: coverage and face ids equal,
    images atol 1e-5. The JAX renderer tests faces on fixed patch buckets
    (at most 1024 faces wider than 32 px, 64 wider than 128 px); the port
    tests exact boxes. The cases stay where the buckets hold every face
    (asserted), including the one-triangle-fills-the-frame case;
  * `python -m gaussianavatars_torch.render` against the root `render.py`
    on one model directory: the same file tree, every PNG within 1 level;
    reenactment through `--target_path` against `make_render_fn` with the
    target's FLAME parameters, within 1 level;
  * `python -m gaussianavatars_torch.metrics` against the root
    `metrics.evaluate` on the same renders: the same keys, SSIM and PSNR
    within 1e-4 abs, LPIPS rtol 1e-4;
  * `evaluate_splits` with the synthetic LPIPS column against the JAX
    one, and without weights: no column and one warning line.
"""

import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianavatars_tpu.config import ModelConfig as JaxModelConfig
from gaussianavatars_tpu.config import PipelineConfig as JaxPipeline
from gaussianavatars_tpu.data.scene import Scene as JaxScene
from gaussianavatars_tpu.metrics_lib import lpips as jlpips
from gaussianavatars_tpu.models.flame_gaussians import (
    FlameGaussianModel as JaxFlameModel,
)
from gaussianavatars_tpu.render import mesh_renderer as jmesh
from gaussianavatars_tpu.train import loop as jloop
from gaussianavatars_torch import benchmark as tbench
from gaussianavatars_torch import metrics as tmetrics
from gaussianavatars_torch.config import (
    ModelConfig,
    PipelineConfig,
    save_config,
)
from gaussianavatars_torch.data.scene import Scene
from gaussianavatars_torch.metrics_lib import lpips as tlpips
from gaussianavatars_torch.models.flame_gaussians import FlameGaussianModel
from gaussianavatars_torch.ops.projection import CameraParams
from gaussianavatars_torch.render import __main__ as trender
from gaussianavatars_torch.render import mesh_renderer as tmesh
from gaussianavatars_torch.train import loop as tloop
from gaussianavatars_torch.utils.png import read_png

from .test_torch_blend import one_torch_thread  # noqa: F401
from .torch_fixtures import make_port_avatar_dataset
from .utils import make_camera

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ITERATION = 7


def lpips_weights(path, seed=0):
    """Synthetic LPIPS weights (the real ones are a user download)."""
    rng = np.random.default_rng(seed)
    weights, ci, in_ch = {}, 0, 3
    for ch, n_convs in tlpips._VGG_STAGES:
        for _ in range(n_convs):
            weights[f"conv{ci}_w"] = rng.normal(
                0, 0.08, (ch, in_ch, 3, 3)).astype(np.float32)
            weights[f"conv{ci}_b"] = rng.normal(0, 0.01, ch).astype(
                np.float32)
            in_ch = ch
            ci += 1
    for i, (ch, _) in enumerate(tlpips._VGG_STAGES):
        weights[f"lin{i}"] = np.abs(rng.normal(0, 0.05, ch)).astype(
            np.float32)
    np.savez(path, **weights)
    return path


def _port_camera(jcam):
    return CameraParams(**{
        k: torch.from_numpy(np.array(getattr(jcam, k)))
        if k in ("viewmatrix", "projmatrix", "campos") else getattr(jcam, k)
        for k in CameraParams._fields})


# ---------------------------------------------------------------------------
# LPIPS
# ---------------------------------------------------------------------------

def test_lpips_matches_jax(tmp_path):
    path = lpips_weights(str(tmp_path / "w.npz"))
    rng = np.random.default_rng(1)
    a = rng.random((2, 3, 48, 64)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.15, a.shape), 0, 1).astype(np.float32)
    port = tlpips.LPIPS(path, device="cpu")
    ref = np.asarray(jlpips.LPIPS(path)(a, b))
    got = port(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert got.shape == (2,) and ref.min() > 1e-4
    np.testing.assert_allclose(got, ref, rtol=1e-4)
    single = port(torch.from_numpy(a[1]), torch.from_numpy(b[1])).numpy()
    np.testing.assert_allclose(single, ref[1:], rtol=1e-4)
    same = port(torch.from_numpy(a), torch.from_numpy(a)).numpy()
    assert np.abs(same).max() <= 1e-6


def test_lpips_weights_path_and_converter_match_jax(tmp_path, monkeypatch):
    monkeypatch.delenv("LPIPS_WEIGHTS", raising=False)
    monkeypatch.setenv("FLAME_ASSET_DIR", str(tmp_path / "flame"))
    expected = os.path.normpath(str(tmp_path / "lpips_vgg.npz"))
    assert tlpips.default_weights_path() == expected
    assert not tlpips.lpips_available()
    monkeypatch.setenv("LPIPS_WEIGHTS", str(tmp_path / "w.npz"))
    assert tlpips.default_weights_path() == jlpips.default_weights_path()
    with pytest.raises(FileNotFoundError):
        tlpips.LPIPS(device="cpu")

    # a torchvision-style VGG16 state dict and LPIPS heads
    rng = np.random.default_rng(2)
    vgg, layer, in_ch = {}, 0, 3
    for ch, n_convs in tlpips._VGG_STAGES:
        for _ in range(n_convs):
            vgg[f"features.{layer}.weight"] = torch.from_numpy(
                rng.normal(size=(ch, in_ch, 3, 3)).astype(np.float32))
            vgg[f"features.{layer}.bias"] = torch.from_numpy(
                rng.normal(size=ch).astype(np.float32))
            in_ch = ch
            layer += 2
        layer += 1
    lin = {f"lin{i}.model.1.weight": torch.from_numpy(
        rng.random((1, ch, 1, 1)).astype(np.float32))
        for i, (ch, _) in enumerate(tlpips._VGG_STAGES)}
    torch.save(vgg, str(tmp_path / "vgg.pth"))
    torch.save(lin, str(tmp_path / "lin.pth"))
    for mod, name in ((tlpips, "port.npz"), (jlpips, "jax.npz")):
        mod.convert_torch_weights(str(tmp_path / "vgg.pth"),
                                  str(tmp_path / "lin.pth"),
                                  str(tmp_path / name))
    with np.load(tmp_path / "port.npz") as got, \
            np.load(tmp_path / "jax.npz") as ref:
        assert sorted(got) == sorted(ref) and len(got) == 31
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


# ---------------------------------------------------------------------------
# Mesh renderer
# ---------------------------------------------------------------------------

def _assert_buckets_hold_every_face(verts, faces, cam, scale):
    """The JAX renderer's patch buckets hold every face that needs them at
    `scale` times the camera's size."""
    xy, depths, _ = tmesh._project(torch.from_numpy(verts),
                                   torch.from_numpy(faces).long(),
                                   _port_camera(cam), cam.width * scale,
                                   cam.height * scale)
    tri = xy[torch.from_numpy(faces).long()]
    side = (tri.amax(1) - tri.amin(1)).amax(1)
    side = side[(depths[torch.from_numpy(faces).long()] > 0.01).all(1)]
    assert int((side > 31).sum()) <= 1024 and int((side > 127).sum()) <= 64


def _compare_mesh(verts, faces, jcam, **kw):
    tcam = _port_camera(jcam)
    _assert_buckets_hold_every_face(verts, faces, jcam, 1)
    ref = [np.asarray(x) for x in jmesh.rasterize_mesh(verts, faces, jcam)]
    got = [x.numpy() for x in tmesh.rasterize_mesh(verts, faces, tcam)]
    np.testing.assert_array_equal(got[1], ref[1], err_msg="coverage")
    np.testing.assert_array_equal(got[3], ref[3], err_msg="face ids")
    for g, r, what in zip(got, ref, ("rgb", "alpha", "depth")):
        np.testing.assert_allclose(g, r, atol=1e-5, rtol=1e-6, err_msg=what)
    for aa in (False, True):
        _assert_buckets_hold_every_face(verts, faces, jcam, 2 if aa else 1)
        ref = jmesh.render_mesh(verts, faces, jcam, antialias=aa, **kw)
        got = tmesh.render_mesh(verts, faces, tcam, antialias=aa, **kw)
        assert sorted(got) == ["albedo", "diffuse", "normal", "rgba"]
        for k in ref:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                       atol=1e-5, rtol=0, err_msg=k)
    bg = np.random.default_rng(0).random(
        (3, jcam.height, jcam.width)).astype(np.float32)
    np.testing.assert_allclose(
        tmesh.render_mesh_overlay(verts, faces, tcam, background=bg,
                                  opacity=0.4).numpy(),
        np.asarray(jmesh.render_mesh_overlay(verts, faces, jcam,
                                             background=bg, opacity=0.4)),
        atol=1e-5, rtol=0)
    return ref


def test_mesh_renderer_large_triangle_matches_jax():
    """One triangle spanning most of the frame (the full-frame case)."""
    verts = np.array([[-1.5, -1.2, 0.0], [1.5, -1.2, 0.0], [0.0, 1.4, 0.0]],
                     np.float32)
    out = _compare_mesh(verts, np.array([[0, 1, 2]], np.int32),
                        make_camera(width=96, height=80, fovx=0.9, dist=2.0),
                        background_color=[0.0, 0.0, 0.0],
                        face_colors=np.array([[0.2, 0.5, 0.9]], np.float32))
    assert (np.asarray(out["rgba"])[..., 3] > 0.5).sum() > 2500


@pytest.mark.parametrize("width,height,angle,lighting", [
    (64, 48, 0.0, "front"), (48, 36, 0.7, "constant")])
def test_mesh_renderer_flame_head_matches_jax(tmp_path, width, height, angle,
                                              lighting):
    """The posed synthetic FLAME head with teeth, its faces listed twice
    (the copies in reverse order): every pixel has equal depths from two
    faces, and both renderers give it the smaller face id."""
    model = tbench.make_bound_bench_model(sh_degree=0, n_per_face=1,
                                          num_timesteps=2, device="cpu")
    with torch.no_grad():
        verts = model.verts_at(model.flame_param, 1)[0].numpy()
    faces = model.flame_model.faces.numpy().astype(np.int32)
    twice = np.concatenate([faces, faces[::-1]])
    colors = np.random.default_rng(3).random((len(twice), 3)).astype(
        np.float32)
    cam = make_camera(width=width, height=height, fovx=0.5, dist=1.0,
                      angle=angle)
    _compare_mesh(verts, twice, cam, face_colors=colors,
                  lighting_type=lighting)
    _, alpha, _, fid = tmesh.rasterize_mesh(verts, twice, _port_camera(cam))
    assert 0.05 < float(alpha.mean()) < 0.95
    assert int(fid.max()) < len(faces)


# ---------------------------------------------------------------------------
# The render and metrics entry points
# ---------------------------------------------------------------------------

def _pngs(root):
    """{path relative to root: pixels} of every PNG under root/*/ours_*/."""
    out = {}
    for dirpath, _, files in os.walk(root):
        if "ours_" not in dirpath:
            continue
        for f in files:
            path = os.path.join(dirpath, f)
            out[os.path.relpath(path, root)] = read_png(path).astype(np.int16)
    return out


@pytest.fixture(scope="module")
def offline(tmp_path_factory):
    """One model directory (the port's bench avatar, 1 Gaussian per face,
    SH 3, on the close-camera dataset) rendered by the root `render.py`
    (jnp backend) and by the port's `render`, both with meshes; a second
    dataset with other FLAME parameters rendered by the port as a target;
    the root metrics on the port's renders (its results kept aside), then
    the port's metrics on them; synthetic LPIPS weights for both."""
    root = tmp_path_factory.mktemp("offline")
    data, assets = make_port_avatar_dataset(root)
    target = tbench.write_avatar_dataset(
        str(root / "target"),
        tbench.bench_meshes(np.random.default_rng(5), 2),
        96, 72, n_train_cams=2, dist=0.3)
    weights = lpips_weights(str(root / "lpips.npz"), seed=4)
    mp = pytest.MonkeyPatch()
    mp.setenv("FLAME_ASSET_DIR", assets)
    mp.setenv("LPIPS_WEIGHTS", weights)
    sys.path.insert(0, REPO)
    try:
        import metrics as root_metrics
        import render as root_render

        avatar = tbench.make_bound_bench_model(sh_degree=3, n_per_face=1,
                                               num_timesteps=2, device="cpu")
        dirs = {}
        for name in ("jax", "port"):
            dirs[name] = str(root / name)
            avatar.save_ply(os.path.join(
                dirs[name], "point_cloud", f"iteration_{ITERATION}",
                "point_cloud.ply"))
            save_config(dirs[name], ModelConfig(
                source_path=data, model_path=dirs[name], bind_to_mesh=True,
                eval=True, sh_degree=3))
        root_render.main(["-m", dirs["jax"], "--render_mesh", "--tile_size",
                          "16", "--backend", "jnp", "--capacity",
                          str(1 << 18), "--chunk", "16"])
        stats = trender.main(["-m", dirs["port"], "--render_mesh",
                              "--tile_size", "16", "--device", "cpu"])
        reenact = trender.main(["-m", dirs["port"], "-t", target,
                                "--tile_size", "16", "--device", "cpu"])
        root_metrics.evaluate([dirs["port"]], splits=("test", "val", "train"))
        with open(os.path.join(dirs["port"], "results.json")) as f:
            jax_results = json.load(f)
        with open(os.path.join(dirs["port"], "per_view.json")) as f:
            jax_per_view = json.load(f)
        port_results = tmetrics.main(["-m", dirs["port"], "--device", "cpu"])
        yield dict(dirs=dirs, data=data, target=target, stats=stats,
                   reenact=reenact, avatar=avatar, weights=weights,
                   jax_results=jax_results, jax_per_view=jax_per_view,
                   port_results=port_results[dirs["port"]])
    finally:
        sys.path.remove(REPO)
        mp.undo()


def test_render_matches_root_render(offline):
    ref = _pngs(offline["dirs"]["jax"])
    got = _pngs(offline["dirs"]["port"])
    got = {k: v for k, v in got.items()
           if not k.startswith(os.path.basename(offline["target"]))}
    assert sorted(got) == sorted(ref)
    assert len(ref) == 3 * 8
    assert {k.split(os.sep)[0] for k in ref} == {"train", "val", "test"}
    for k in ref:
        assert got[k].shape == ref[k].shape == (72, 96, 3), k
        assert np.abs(got[k] - ref[k]).max() <= 1, k
        if os.sep + "gt" + os.sep in k:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    renders = [v for k, v in got.items() if os.sep + "renders" + os.sep in k]
    assert min(float(v.std()) for v in renders) > 2.0
    assert offline["stats"]["train"]["images"] == 4
    assert {s["images"] for s in offline["stats"].values()} >= {2, 4}


def test_reenactment_follows_the_target(offline):
    """The target's cameras and FLAME motion drive the avatar: each PNG is
    make_render_fn's image with the target's parameters, within 1 level,
    and differs from the self-reenactment of the same camera."""
    name = os.path.basename(offline["target"])
    assert sorted(offline["reenact"]) == [name]
    avatar = offline["avatar"]
    model = FlameGaussianModel.from_assets(3, device="cpu")
    cfg = ModelConfig(source_path=offline["data"], target_path=offline[
        "target"], model_path=offline["dirs"]["port"], bind_to_mesh=True,
        eval=True, sh_degree=3)
    scene = Scene(cfg, model, load_iteration=-1, shuffle=False)
    cams = scene.get_train_cameras()
    assert len(cams) == 8
    render = tloop.make_render_fn(avatar, PipelineConfig(tile_size=16), 96,
                                  72, 3)
    own = render(avatar.params, avatar.flame_param, avatar.binding,
                 tloop.camera_arrays(cams[0].to_params()), torch.zeros(3),
                 cams[0].timestep).image
    for idx, cam in enumerate(cams):
        img = render(avatar.params, model.flame_param, avatar.binding,
                     tloop.camera_arrays(cam.to_params()), torch.zeros(3),
                     cam.timestep).image
        want = trender.to_uint8(img.clamp(0, 1)).numpy().astype(np.int16)
        got = read_png(os.path.join(offline["dirs"]["port"], name,
                                    f"ours_{ITERATION}", "renders",
                                    f"{idx:05d}.png")).astype(np.int16)
        assert np.abs(got - want).max() <= 1, idx
        if idx == 0:
            assert float((img - own).abs().max()) > 0.05


def test_metrics_match_root_metrics(offline):
    ref, got = offline["jax_results"], offline["port_results"]
    assert sorted(got) == sorted(ref) == [f"ours_{ITERATION}"]
    with open(os.path.join(offline["dirs"]["port"], "results.json")) as f:
        assert json.load(f) == got
    for method, scores in ref.items():
        assert sorted(got[method]) == sorted(scores) == ["LPIPS", "PSNR",
                                                         "SSIM"]
        for k in ("SSIM", "PSNR"):
            assert abs(got[method][k] - scores[k]) <= 1e-4, k
        np.testing.assert_allclose(got[method]["LPIPS"], scores["LPIPS"],
                                   rtol=1e-4)
    with open(os.path.join(offline["dirs"]["port"], "per_view.json")) as f:
        per_view = json.load(f)
    ref_pv = offline["jax_per_view"]
    for method, metrics in ref_pv.items():
        assert sorted(per_view[method]) == sorted(metrics)
        for k, views in metrics.items():
            assert sorted(per_view[method][k]) == sorted(views)
            tol = dict(rtol=1e-4) if k == "LPIPS" else dict(atol=1e-4)
            np.testing.assert_allclose(
                [per_view[method][k][n] for n in sorted(views)],
                [views[n] for n in sorted(views)], **tol, err_msg=k)


def test_evaluate_splits_lpips_matches_jax(offline, monkeypatch, capsys):
    d = offline["dirs"]["port"]
    monkeypatch.setenv("FLAME_ASSET_DIR", os.path.join(
        os.path.dirname(offline["data"]), "assets"))
    monkeypatch.setenv("LPIPS_WEIGHTS", offline["weights"])
    jmodel = JaxFlameModel(3)
    jcfg = JaxModelConfig(source_path=offline["data"], model_path=d,
                          bind_to_mesh=True, eval=True, sh_degree=3)
    jscene = JaxScene(jcfg, jmodel, load_iteration=-1, shuffle=False)
    jstate = jloop.StepState(
        params=jmodel.params, flame_tr={}, mu=None, nu=None, count=0,
        max_radii2d=None, grad_accum=None, denom=None)
    monkeypatch.setattr(jloop, "_EVAL_LPIPS", [])
    ref = jloop.evaluate_splits(
        jmodel, jscene, jcfg,
        JaxPipeline(backend="jnp", capacity=1 << 18, chunk=16, tile_size=16),
        jstate, dict(jmodel.flame_param), jnp.zeros(3))

    monkeypatch.setattr(tloop, "_EVAL_LPIPS", {})
    model = FlameGaussianModel.from_assets(3, device="cpu")
    cfg = ModelConfig(**{k: getattr(jcfg, k) for k in (
        "source_path", "model_path", "bind_to_mesh", "eval", "sh_degree")})
    scene = Scene(cfg, model, load_iteration=-1, shuffle=False)
    state = tloop.initial_state(model)
    fixed = {k: v for k, v in model.flame_param.items()
             if k not in state.flame_tr}
    pipe = PipelineConfig(tile_size=16)
    got = tloop.evaluate_splits(model, scene, cfg, pipe, state, fixed)
    assert sorted(got) == sorted(ref) == ["test", "val"]
    for split, m in ref.items():
        assert sorted(got[split]) == sorted(m) == ["l1_loss", "lpips",
                                                   "psnr", "ssim"]
        for k, v in m.items():
            np.testing.assert_allclose(got[split][k], v, rtol=1e-4,
                                       err_msg=f"{split} {k}")

    capsys.readouterr()
    monkeypatch.setenv("LPIPS_WEIGHTS", os.path.join(d, "missing.npz"))
    for _ in range(2):
        plain = tloop.evaluate_splits(model, scene, cfg, pipe, state, fixed)
        assert all("lpips" not in m for m in plain.values())
    warnings = [line for line in capsys.readouterr().out.splitlines()
                if "LPIPS" in line]
    assert len(warnings) == 1, warnings
