"""The port's COLMAP reader against the JAX package's.

  * the binary and text parsers of cameras, images and points3D on files
    written by the COLMAP format specification (as
    tests/test_unbound_and_colmap.py writes them) give what JAX's give,
    exactly; the port's own binary writers read back through both; the
    quaternion <-> rotation round trip;
  * `read_colmap_scene` on a PNG scene (binary and text): R, T, FoVs,
    sizes, names, the llffhold split and the points equal JAX's (exact or
    atol 1e-6), and the `points3D.ply` it writes is JAX's byte for byte;
  * image sizes from the file header equal PIL's for PNG and JPEG files;
  * `Scene` + `create_from_pcd` on the scene give JAX's Gaussians (atol
    1e-6), 5 iterations of unbound `training` agree with JAX's as the
    loop tests do (the EMA loss history within rtol 1e-3), and the `train`
    entry point trains from the scene's points;
  * a scene of JPEG views reads; on the CPU its first view decodes (the
    plain decoder, `utils/jpeg.py`) to the JAX loader's view within 1/255,
    while a CUDA loader without nvJPEG raises naming the file (it never
    decodes on the CPU); 5 unbound iterations on the JPEG scene agree with
    JAX's as the PNG scene's do.
"""

import math
import os
import struct

import numpy as np
import pytest
from PIL import Image

from gaussianavatars_tpu.config import ModelConfig as JaxModelConfig
from gaussianavatars_tpu.config import OptimizationConfig as JaxOpt
from gaussianavatars_tpu.config import PipelineConfig as JaxPipeline
from gaussianavatars_tpu.data import colmap as jcolmap
from gaussianavatars_tpu.data.loader import (
    load_camera_image as jax_load_camera_image,
)
from gaussianavatars_tpu.data.readers import (
    read_colmap_scene as jax_read_colmap_scene,
)
from gaussianavatars_tpu.data.scene import Scene as JaxScene
from gaussianavatars_tpu.models.gaussians import GaussianModel as JaxModel
from gaussianavatars_tpu.train.loop import training as jax_training
from gaussianavatars_torch.config import (
    ModelConfig,
    OptimizationConfig,
    PipelineConfig,
)
from gaussianavatars_torch.data import colmap
from gaussianavatars_torch.data.loader import load_camera_image
from gaussianavatars_torch.data.readers import read_colmap_scene
from gaussianavatars_torch.data.scene import Scene
from gaussianavatars_torch.models.gaussians import GaussianModel
from gaussianavatars_torch.train import __main__ as train_cli
from gaussianavatars_torch.train.loop import training
from gaussianavatars_torch.utils.ply import read_ply
from gaussianavatars_torch.utils.png import PNGError, image_size

from .test_torch_blend import one_torch_thread  # noqa: F401

W, H = 48, 40
N_VIEWS, N_POINTS = 10, 300


def _look_at(angle, elev, dist=4.0):
    """World-to-camera rotation and translation of a camera on the sphere
    of radius `dist` looking at the origin (COLMAP axes)."""
    pos = np.array([dist * math.cos(elev) * math.sin(angle),
                    dist * math.sin(elev),
                    -dist * math.cos(elev) * math.cos(angle)])
    fwd = -pos / np.linalg.norm(pos)
    right = np.cross([0.0, -1.0, 0.0], fwd)
    right /= np.linalg.norm(right)
    c2w = np.stack([right, np.cross(fwd, right), fwd], axis=1)
    return c2w.T, -c2w.T @ pos


def _write_scene(root, fmt="bin", ext=".png", seed=0):
    """A COLMAP scene by the format specification: a PINHOLE and a
    SIMPLE_PINHOLE camera, N_VIEWS images in a shuffled order (names out
    of order, each with two 2D points), N_POINTS points with tracks."""
    rng = np.random.default_rng(seed)
    sparse = os.path.join(root, "sparse", "0")
    os.makedirs(sparse)
    os.makedirs(os.path.join(root, "images"))
    cams = [(1, 1, [60.0, 62.0, W / 2, H / 2]), (2, 0, [58.0, W / 2, H / 2])]
    images = []
    for k, i in enumerate(rng.permutation(N_VIEWS)):
        R, t = _look_at(2 * math.pi * i / N_VIEWS, 0.3 * math.sin(i))
        name = f"view_{i:03d}{ext}"
        images.append((k + 1, jcolmap.rotmat2qvec(R), t, 1 + i % 2, name))
        img = (rng.random((H, W, 3)) * 255).astype(np.uint8)
        Image.fromarray(img).save(os.path.join(root, "images", name))
    xyz = rng.normal(0, 0.5, (N_POINTS, 3))
    rgb = rng.integers(0, 256, (N_POINTS, 3), dtype=np.uint8)
    if fmt == "bin":
        with open(os.path.join(sparse, "cameras.bin"), "wb") as f:
            f.write(struct.pack("<Q", len(cams)))
            for cid, model, params in cams:
                f.write(struct.pack("<iiQQ", cid, model, W, H))
                f.write(struct.pack(f"<{len(params)}d", *params))
        with open(os.path.join(sparse, "images.bin"), "wb") as f:
            f.write(struct.pack("<Q", len(images)))
            for iid, q, t, cid, name in images:
                f.write(struct.pack("<i", iid))
                f.write(struct.pack("<4d", *q))
                f.write(struct.pack("<3d", *t))
                f.write(struct.pack("<i", cid))
                f.write(name.encode() + b"\x00")
                f.write(struct.pack("<Q", 2))
                f.write(struct.pack("<ddq", 1.0, 2.0, -1))
                f.write(struct.pack("<ddq", 3.0, 4.0, 5))
        with open(os.path.join(sparse, "points3D.bin"), "wb") as f:
            f.write(struct.pack("<Q", N_POINTS))
            for i in range(N_POINTS):
                f.write(struct.pack("<QdddBBBd", i, *xyz[i], *rgb[i], 0.5))
                f.write(struct.pack("<Q", 1))
                f.write(struct.pack("<ii", 1, 0))
    else:
        names = {1: "PINHOLE", 0: "SIMPLE_PINHOLE"}
        with open(os.path.join(sparse, "cameras.txt"), "w") as f:
            f.write("# Camera list with one line of data per camera:\n")
            for cid, model, params in cams:
                f.write(f"{cid} {names[model]} {W} {H} "
                        + " ".join(repr(p) for p in params) + "\n")
        with open(os.path.join(sparse, "images.txt"), "w") as f:
            f.write("# Image list with two lines of data per image:\n")
            for iid, q, t, cid, name in images:
                f.write(f"{iid} " + " ".join(repr(float(v)) for v in q)
                        + " " + " ".join(repr(float(v)) for v in t)
                        + f" {cid} {name}\n")
                f.write("1.0 2.0 -1 3.0 4.0 5\n")
        with open(os.path.join(sparse, "points3D.txt"), "w") as f:
            f.write("# 3D point list with one line of data per point:\n")
            for i in range(N_POINTS):
                f.write(f"{i} " + " ".join(repr(float(v)) for v in xyz[i])
                        + " " + " ".join(str(int(c)) for c in rgb[i])
                        + " 0.5 1 0\n")
    return root


@pytest.fixture(scope="module", params=["bin", "txt"])
def scene_dir(request, tmp_path_factory):
    return _write_scene(str(tmp_path_factory.mktemp(request.param)),
                        request.param)


@pytest.mark.parametrize("fmt", ["bin", "txt"])
def test_parsers_match_jax(tmp_path, fmt):
    sparse = os.path.join(_write_scene(str(tmp_path), fmt), "sparse", "0")
    for kind in ("cameras", "images"):
        read = f"read_{kind}_{'binary' if fmt == 'bin' else 'text'}"
        path = os.path.join(sparse, f"{kind}.{fmt}")
        got, ref = getattr(colmap, read)(path), getattr(jcolmap, read)(path)
        assert list(got) == list(ref) and len(got) > 0
        for k in ref:
            for field in vars(ref[k]):
                a, b = getattr(got[k], field), getattr(ref[k], field)
                np.testing.assert_array_equal(a, b, err_msg=field)
    read = "read_points3d_" + ("binary" if fmt == "bin" else "text")
    path = os.path.join(sparse, f"points3D.{fmt}")
    for a, b in zip(getattr(colmap, read)(path), getattr(jcolmap, read)(path),
                    strict=True):
        assert a.dtype == b.dtype and a.shape[0] == N_POINTS
        np.testing.assert_array_equal(a, b)


def test_writers_read_back(tmp_path):
    rng = np.random.default_rng(4)
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    cams = [colmap.ColmapCamera(3, "SIMPLE_PINHOLE", 640, 480,
                                np.array([500.0, 320.0, 240.0]))]
    ims = [colmap.ColmapImage(5, q, rng.normal(size=3), 3, "a.png")]
    xyz, rgb = rng.normal(size=(7, 3)), rng.integers(0, 256, (7, 3),
                                                     dtype=np.uint8)
    colmap.write_cameras_binary(str(tmp_path / "c.bin"), cams)
    colmap.write_images_binary(str(tmp_path / "i.bin"), ims)
    colmap.write_points3d_binary(str(tmp_path / "p.bin"), xyz, rgb)
    got_c = jcolmap.read_cameras_binary(str(tmp_path / "c.bin"))[3]
    assert (got_c.model, got_c.width, got_c.height) == ("SIMPLE_PINHOLE",
                                                        640, 480)
    np.testing.assert_array_equal(got_c.params, cams[0].params)
    got_i = jcolmap.read_images_binary(str(tmp_path / "i.bin"))[5]
    np.testing.assert_array_equal(got_i.qvec, q)
    np.testing.assert_array_equal(got_i.tvec, ims[0].tvec)
    assert (got_i.camera_id, got_i.name) == (3, "a.png")
    pxyz, prgb, _ = colmap.read_points3d_binary(str(tmp_path / "p.bin"))
    np.testing.assert_array_equal(pxyz, xyz)
    np.testing.assert_array_equal(prgb, rgb)


def test_qvec_round_trip():
    rng = np.random.default_rng(5)
    for _ in range(20):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q) * (1 if q[0] >= 0 else -1)
        R = colmap.qvec2rotmat(q)
        np.testing.assert_allclose(R, jcolmap.qvec2rotmat(q), atol=0)
        np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-12)
        np.testing.assert_allclose(colmap.rotmat2qvec(R), q, atol=1e-9)
        np.testing.assert_array_equal(colmap.rotmat2qvec(R),
                                      jcolmap.rotmat2qvec(R))


def test_read_colmap_scene_matches_jax(scene_dir, tmp_path):
    import shutil

    jroot = str(tmp_path / "jax")
    shutil.copytree(scene_dir, jroot)
    for split in (False, True):
        got = read_colmap_scene(scene_dir, eval_split=split)
        ref = jax_read_colmap_scene(jroot, eval_split=split)
        for gcams, rcams in ((got.train_cameras, ref.train_cameras),
                             (got.test_cameras, ref.test_cameras)):
            assert [c.image_name for c in gcams] == \
                [c.image_name for c in rcams]
            for a, b in zip(gcams, rcams):
                for k in ("uid", "width", "height", "fovx", "fovy"):
                    assert getattr(a, k) == getattr(b, k), k
                np.testing.assert_allclose(a.R, b.R, atol=1e-6)
                np.testing.assert_allclose(a.T, b.T, atol=1e-6)
                assert os.path.relpath(a.image_path, scene_dir) == \
                    os.path.relpath(b.image_path, jroot)
        assert len(got.test_cameras) == (2 if split else 0)
        np.testing.assert_array_equal(got.points, ref.points)
        np.testing.assert_array_equal(got.colors, ref.colors)
        np.testing.assert_allclose(got.nerf_normalization["translate"],
                                   ref.nerf_normalization["translate"],
                                   atol=1e-6)
        assert got.nerf_normalization["radius"] == pytest.approx(
            ref.nerf_normalization["radius"], abs=1e-6)
    with open(got.ply_path, "rb") as f, open(ref.ply_path, "rb") as g:
        assert f.read() == g.read()


@pytest.mark.parametrize("size", [(37, 29), (640, 480)])
def test_header_sizes_match_pil(tmp_path, size):
    img = np.zeros((size[1], size[0], 3), np.uint8)
    for name, kw in (("a.png", {}), ("b.jpg", {}),
                     ("c.jpg", dict(progressive=True)),
                     ("d.jpg", dict(quality=50, optimize=True))):
        path = str(tmp_path / name)
        Image.fromarray(img).save(path, **kw)
        with Image.open(path) as im:
            assert image_size(path) == im.size == size, name


def _unbound_cfg(cls, data, out):
    return cls(source_path=data, model_path=out, bind_to_mesh=False,
               eval=True, sh_degree=1)


def test_scene_init_matches_jax(scene_dir, tmp_path):
    os.makedirs(tmp_path / "j")         # the JAX Scene does not make it
    jscene_model = JaxModel(sh_degree=1)
    JaxScene(_unbound_cfg(JaxModelConfig, scene_dir, str(tmp_path / "j")),
             jscene_model, shuffle=False)
    tmodel = GaussianModel(1, device="cpu")
    tscene = Scene(_unbound_cfg(ModelConfig, scene_dir, str(tmp_path / "t")),
                   tmodel, shuffle=False)
    n = jscene_model.n_alive
    assert tmodel.num_gaussians == n == N_POINTS and tmodel.binding is None
    for k in tmodel.params._fields:
        np.testing.assert_allclose(
            getattr(tmodel.params, k).numpy(),
            np.asarray(getattr(jscene_model.params, k))[:n], atol=1e-6,
            rtol=1e-5, err_msg=k)
    assert tmodel.spatial_lr_scale == pytest.approx(
        jscene_model.spatial_lr_scale, abs=1e-6)
    with open(tmp_path / "t" / "input.ply", "rb") as f, \
            open(tmp_path / "j" / "input.ply", "rb") as g:
        assert f.read() == g.read()
    assert len(tscene.get_test_cameras()) == 2


@pytest.mark.parametrize("ext", [".png", ".jpg"])
def test_unbound_training_matches_jax(tmp_path, ext):
    data = _write_scene(str(tmp_path / "scene"), "bin", ext=ext)
    schedule = dict(iterations=5, densify_from_iter=100,
                    opacity_reset_interval=1000, position_lr_max_steps=5)
    _, jstate, jinfo = jax_training(
        _unbound_cfg(JaxModelConfig, data, str(tmp_path / "jax")),
        JaxOpt(**schedule),
        JaxPipeline(backend="jnp", capacity=1 << 16, chunk=16, tile_size=16),
        log_every=1)
    model, state, info = training(
        _unbound_cfg(ModelConfig, data, str(tmp_path / "port")),
        OptimizationConfig(**schedule), PipelineConfig(tile_size=16),
        saving_iterations={5}, log_every=1, device="cpu")
    jh, th = jinfo["history"], info["history"]
    assert [i for i, _ in th] == [i for i, _ in jh] == list(range(1, 6))
    np.testing.assert_allclose([v for _, v in th], [v for _, v in jh],
                               rtol=1e-3)
    assert th[-1][1] < th[0][1]
    assert state.count == int(jstate.count) == 5
    assert model.num_gaussians == N_POINTS and model.binding is None
    assert os.path.exists(os.path.join(
        tmp_path, "port", "point_cloud", "iteration_5", "point_cloud.ply"))


def test_train_cli_on_colmap_scene(tmp_path):
    """`python -m gaussianavatars_torch.train -s <COLMAP scene>` trains
    unbound from the scene's points and writes its PLY."""
    data = _write_scene(str(tmp_path / "scene"), "txt")
    out = str(tmp_path / "out")
    train_cli.main(["-s", data, "-m", out, "--sh_degree", "1",
                    "--iterations", "2", "--tile_size", "16", "--device",
                    "cpu", "--quiet"])
    start = read_ply(os.path.join(out, "input.ply"))
    end = read_ply(os.path.join(out, "point_cloud", "iteration_2",
                                "point_cloud.ply"))
    points = read_colmap_scene(data).points
    np.testing.assert_array_equal(
        np.stack([start["x"], start["y"], start["z"]], axis=1), points)
    assert len(end["x"]) == N_POINTS and "binding" not in end


def test_jpeg_view_raises_with_its_name(tmp_path, monkeypatch):
    """The JPEG scene's first view decodes on the CPU to the JAX loader's
    view; a CUDA loader without nvJPEG raises naming it."""
    from gaussianavatars_tpu.data.cameras import Camera as JaxCamera
    from gaussianavatars_torch.data.loader import iterate_once
    from gaussianavatars_torch.utils import nvjpeg

    data = _write_scene(str(tmp_path), "bin", ext=".jpg")
    info = read_colmap_scene(data)
    cam = info.train_cameras[0]
    assert (cam.width, cam.height) == (W, H)
    assert cam.image_path.endswith(".jpg")
    got = load_camera_image(cam)
    ref = jax_load_camera_image(JaxCamera(
        uid=cam.uid, R=cam.R, T=cam.T, fovx=cam.fovx, fovy=cam.fovy,
        width=cam.width, height=cam.height, image_path=cam.image_path,
        bg=cam.bg))
    assert got.shape == ref.shape == (3, H, W)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1.0 / 255 + 1e-6)
    with pytest.raises(PNGError, match=f"{cam.image_path}.*JPEG"):
        from gaussianavatars_torch.utils.png import read_png

        read_png(cam.image_path)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    monkeypatch.setattr(nvjpeg, "_LIB", {})
    with pytest.raises(nvjpeg.NvJpegError, match=cam.image_path):
        next(iterate_once([cam], device="cuda"))
