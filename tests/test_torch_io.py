"""The port's file IO against the JAX package's.

  * PLY: the port's `save_ply` of a model carried over from JAX is the
    JAX writer's file byte for byte, `flame_param.npz` holds the same
    arrays, and each package's `load_ply` reads the other's file exactly
    (`binding_0` included); point-cloud PLYs are byte-identical too;
  * PNG (`utils/png.py`): PIL's gray, RGB and RGBA PNGs decode exactly, and
    PIL decodes the port's encoder output exactly for each of the five row
    filters; other formats and broken files raise, naming the file;
  * checkpoints: a JAX checkpoint restored by the port and a port
    checkpoint restored by JAX give equal states (parameters, Adam
    moments and count, statistics, binding, FLAME trainables); an
    unlabelled checkpoint raises.
"""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from gaussianavatars_tpu.benchmark import (
    make_bound_bench_model as jax_bound_model,
)
from gaussianavatars_tpu.models.flame_gaussians import (
    FlameGaussianModel as JaxFlameModel,
)
from gaussianavatars_tpu.models.gaussians import GaussianParams as JaxParams
from gaussianavatars_tpu.train.loop import StepState as JaxStepState
from gaussianavatars_tpu.train.loop import save_checkpoint as jax_save_ckpt
from gaussianavatars_tpu.utils import ply as jax_ply
from gaussianavatars_torch.convert import from_jax_arrays, load_checkpoint
from gaussianavatars_torch.models.flame import FlameHead
from gaussianavatars_torch.models.flame_gaussians import FlameGaussianModel
from gaussianavatars_torch.models.gaussians import GaussianParams
from gaussianavatars_torch.train.loop import StepState, save_checkpoint
from gaussianavatars_torch.utils import ply, png

from .flame_fixtures import make_flame_assets
from .test_torch_blend import one_torch_thread  # noqa: F401

FIELDS = GaussianParams._fields
STATS = ("max_radii2d", "xyz_gradient_accum", "denom")


@pytest.fixture(scope="module")
def carried(tmp_path_factory):
    """The JAX bound bench avatar (1 Gaussian per face, SH 3, 4
    timesteps), its port copy, and a factory of empty port models."""
    jmodel = jax_bound_model(sh_degree=3, n_per_face=1, seed=0,
                             num_timesteps=4)
    paths = make_flame_assets(str(tmp_path_factory.mktemp("flame")), seed=0)
    tmodel = from_jax_arrays(
        {k: np.asarray(getattr(jmodel.params, k)) for k in FIELDS},
        jmodel.binding,
        {k: np.asarray(v) for k, v in jmodel.flame_param.items()},
        sh_degree=3, n_alive=jmodel.n_alive,
        flame_model_path=paths["model"],
        flame_template_mesh_path=paths["obj"], device="cpu")

    def empty():
        return FlameGaussianModel(3, tmodel.flame_model)

    return jmodel, tmodel, empty


def _assert_same_model(tmodel, jmodel):
    n = jmodel.n_alive
    assert tmodel.num_gaussians == n
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(tmodel.params, k).numpy(),
                                      np.asarray(getattr(jmodel.params, k))[:n],
                                      err_msg=k)
    np.testing.assert_array_equal(tmodel.binding.numpy(), jmodel.binding[:n])


def test_save_ply_bytes_match_jax(carried, tmp_path):
    jmodel, tmodel, _ = carried
    jmodel.save_ply(str(tmp_path / "jax" / "point_cloud.ply"))
    tmodel.save_ply(str(tmp_path / "port" / "point_cloud.ply"))
    with open(tmp_path / "jax" / "point_cloud.ply", "rb") as f, \
            open(tmp_path / "port" / "point_cloud.ply", "rb") as g:
        ref, got = f.read(), g.read()
    assert len(got) > 10144 * 4 * 62
    assert got == ref
    with np.load(tmp_path / "jax" / "flame_param.npz") as a, \
            np.load(tmp_path / "port" / "flame_param.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)


def test_each_package_loads_the_others_ply(carried, tmp_path):
    jmodel, tmodel, empty = carried
    jmodel.save_ply(str(tmp_path / "jax" / "point_cloud.ply"))
    tmodel.save_ply(str(tmp_path / "port" / "point_cloud.ply"))

    got = empty()
    got.load_ply(str(tmp_path / "jax" / "point_cloud.ply"))
    _assert_same_model(got, jmodel)
    assert got.active_sh_degree == 3 and got.num_timesteps == 4
    assert torch.equal(got.binding_counter,
                       torch.bincount(got.binding, minlength=10144))
    for k, v in jmodel.flame_param.items():
        np.testing.assert_array_equal(got.flame_param[k].numpy(),
                                      np.asarray(v), err_msg=k)

    back = JaxFlameModel(3, flame_head=jmodel.flame_model)
    back.load_ply(str(tmp_path / "port" / "point_cloud.ply"))
    _assert_same_model(tmodel, back)
    assert back.num_timesteps == 4


def test_point_cloud_ply_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    xyz = rng.normal(size=(50, 3))
    rgb = rng.integers(0, 256, (50, 3)).astype(np.float64)
    jax_ply.store_point_cloud(str(tmp_path / "j.ply"), xyz, rgb)
    ply.store_point_cloud(str(tmp_path / "t.ply"), xyz, rgb)
    assert (tmp_path / "j.ply").read_bytes() == (tmp_path / "t.ply").read_bytes()
    for got, ref in zip(ply.fetch_point_cloud(str(tmp_path / "t.ply")),
                        jax_ply.fetch_point_cloud(str(tmp_path / "j.ply"))):
        np.testing.assert_array_equal(got, ref)


def _test_images():
    """Smooth gradients with noise (PIL picks several filters for them),
    a flat image and pure noise."""
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:37, 0:53]
    smooth = np.stack([(xx * 3) % 256, (yy * 5) % 256, (xx + yy) % 256], -1)
    smooth = (smooth + rng.integers(0, 9, smooth.shape)).astype(np.uint8)
    flat = np.full((20, 30, 3), 77, np.uint8)
    noise = rng.integers(0, 256, (19, 23, 3), dtype=np.uint8)
    return [smooth, flat, noise]


def _filters(buf: bytes, height: int) -> set:
    import zlib

    idat = b"".join(d for t, d in png._chunks(buf, "x") if t == b"IDAT")
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(height, -1)
    return set(rows[:, 0].tolist())


@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA"])
def test_png_decodes_pil_files(mode):
    used = set()
    for img in _test_images():
        if mode == "L":
            img = img[..., 0]
        elif mode == "RGBA":
            img = np.concatenate([img, img[..., 1:2] // 2 + 60], axis=-1)
        buf = io.BytesIO()
        Image.fromarray(img, mode).save(buf, "PNG")
        ref = np.asarray(Image.open(io.BytesIO(buf.getvalue())))
        got = png.decode_png(buf.getvalue())
        assert got.dtype == np.uint8 and got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)
        used |= _filters(buf.getvalue(), img.shape[0])
    assert len(used) >= 2, used


@pytest.mark.parametrize("filter_type", range(5))
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_encoder_read_by_pil(filter_type, channels, tmp_path):
    for img in _test_images():
        img = np.concatenate([img, img[..., :1]], -1)[..., :channels] \
            if channels != 1 else img[..., 0]
        path = str(tmp_path / "x.png")
        png.write_png(path, img, filter_type)
        with Image.open(path) as im:
            np.testing.assert_array_equal(np.asarray(im), img)
        np.testing.assert_array_equal(png.read_png(path), img)
        assert png.png_size(path) == (img.shape[1], img.shape[0])
        with open(path, "rb") as f:
            assert _filters(f.read(), img.shape[0]) == {filter_type}


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_c_pass_matches_numpy(channels):
    """Rows of all five filters mixed in one image, as an adaptive writer
    leaves them: the C pass (built with the host's compiler) and the numpy
    pass both rebuild the image that was filtered."""
    rng = np.random.default_rng(channels)
    h, w = 41, 23
    img = rng.integers(0, 256, (h, w, channels), np.uint8)
    ftype = np.concatenate([np.arange(5), rng.integers(0, 5, h - 5)])
    rows = np.empty((h, 1 + w * channels), np.uint8)
    rows[:, 0] = ftype
    for r in range(h):
        rows[r, 1:] = png._filter(img, int(ftype[r]))[r].reshape(-1)
    assert png.native_unfilter() is not None
    for native in (True, False):
        np.testing.assert_array_equal(
            png._unfilter(rows, h, w, channels, "x", native=native), img)


def test_png_rejects_other_files(tmp_path):
    jpg = str(tmp_path / "photo.png")
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(jpg, "JPEG")
    with pytest.raises(png.PNGError, match="photo.png: JPEG"):
        png.read_png(jpg)
    with pytest.raises(png.PNGError, match="JPEG"):
        png.png_size(jpg)
    good = png.encode_png(np.zeros((4, 5, 3), np.uint8))
    bad = str(tmp_path / "bad.png")
    with open(bad, "wb") as f:
        f.write(good[:-20])
    with pytest.raises(png.PNGError, match="bad.png"):
        png.read_png(bad)
    buf = io.BytesIO()
    Image.fromarray(np.zeros((4, 4), np.uint8)).convert("P").save(buf, "PNG")
    with pytest.raises(png.PNGError, match="color type 3"):
        png.decode_png(buf.getvalue(), "palette.png")


def _random_moments(params: dict, seed: int) -> tuple:
    rng = np.random.default_rng(seed)
    return tuple({k: rng.normal(0, 1e-3, np.shape(v)).astype(np.float32)
                  for k, v in params.items()} for _ in range(2))


def test_jax_checkpoint_restored_by_port(carried, tmp_path):
    jmodel, _, empty = carried
    n, cap = jmodel.n_alive, jmodel.capacity
    params = {k: np.asarray(getattr(jmodel.params, k)) for k in FIELDS}
    mu, nu = _random_moments(params, 0)
    flame_tr = {k: jnp.asarray(v) for k, v in
                jmodel.flame_trainable().items()}
    rng = np.random.default_rng(1)
    stats = {k: jnp.asarray(rng.random(cap).astype(np.float32))
             for k in STATS}
    jstate = JaxStepState(
        params=jmodel.params, flame_tr=flame_tr,
        mu={"gauss": JaxParams(**{k: jnp.asarray(v) for k, v in mu.items()}),
            "flame": {}},
        nu={"gauss": JaxParams(**{k: jnp.asarray(v) for k, v in nu.items()}),
            "flame": {}},
        count=jnp.asarray(5), max_radii2d=stats["max_radii2d"],
        grad_accum=stats["xyz_gradient_accum"], denom=stats["denom"])
    jmodel.max_radii2d, jmodel.xyz_gradient_accum, jmodel.denom = (
        stats[k] for k in STATS)
    path = str(tmp_path / "chkpnt7.npz")
    jax_save_ckpt(jmodel, jstate, 7, path)

    model = empty()     # with its FLAME parameters, as the loop has them
    model.flame_param = {k: v.clone() for k, v in
                         carried[1].flame_param.items()}
    iteration, adam, tr = load_checkpoint(path, model)
    assert iteration == 7 and adam.count == 5
    _assert_same_model(model, jmodel)
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(adam.mu, k).numpy(), mu[k][:n])
        np.testing.assert_array_equal(getattr(adam.nu, k).numpy(), nu[k][:n])
    for k in STATS:
        np.testing.assert_array_equal(getattr(model, k).numpy(),
                                      np.asarray(stats[k])[:n])
    np.testing.assert_array_equal(model.binding_counter.numpy(),
                                  jmodel.binding_counter)
    assert model.active_sh_degree == jmodel.active_sh_degree
    assert sorted(tr) == sorted(flame_tr)
    for k, v in flame_tr.items():
        np.testing.assert_array_equal(tr[k].numpy(), np.asarray(v))
        assert model.flame_param[k] is tr[k]


def test_port_checkpoint_restored_by_jax(carried, tmp_path):
    jmodel, tmodel, _ = carried
    n = tmodel.num_gaussians
    params = {k: getattr(tmodel.params, k).numpy() for k in FIELDS}
    mu, nu = _random_moments(params, 2)
    tmodel.reset_stats()
    tmodel.denom = torch.arange(n, dtype=torch.float32)
    state = StepState(
        params=tmodel.params, flame_tr=tmodel.flame_trainable(),
        mu={"gauss": GaussianParams(**{k: torch.from_numpy(v)
                                       for k, v in mu.items()}), "flame": {}},
        nu={"gauss": GaussianParams(**{k: torch.from_numpy(v)
                                       for k, v in nu.items()}), "flame": {}},
        count=9, max_radii2d=tmodel.max_radii2d,
        grad_accum=tmodel.xyz_gradient_accum, denom=tmodel.denom)
    path = str(tmp_path / "chkpnt11.npz")
    save_checkpoint(tmodel, state, 11, path)

    # what the JAX loop does with --start_checkpoint
    data = dict(np.load(path, allow_pickle=True))
    assert int(data.pop("iteration")) == 11
    back = JaxFlameModel(3, flame_head=jmodel.flame_model)
    adam = back.restore({k[2:]: v for k, v in data.items()
                         if k.startswith("g_")})
    _assert_same_model(tmodel, back)
    assert int(adam.count) == 9
    for k in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(adam.mu, k))[:n],
                                      mu[k])
        np.testing.assert_array_equal(np.asarray(getattr(adam.nu, k))[:n],
                                      nu[k])
    np.testing.assert_array_equal(np.asarray(back.denom)[:n],
                                  np.arange(n, dtype=np.float32))
    np.testing.assert_array_equal(back.binding_counter,
                                  tmodel.binding_counter.numpy())
    for k, v in state.flame_tr.items():
        np.testing.assert_array_equal(data[f"f_{k}"], v.numpy())


def test_unlabelled_checkpoint_raises(carried, tmp_path):
    _, tmodel, empty = carried
    params = {k: getattr(tmodel.params, k).numpy() for k in FIELDS}
    m, v = _random_moments(params, 3)
    tmodel.reset_stats()
    state = StepState(
        params=tmodel.params, flame_tr={},
        mu={"gauss": GaussianParams(**{k: torch.from_numpy(x)
                                       for k, x in m.items()}), "flame": {}},
        nu={"gauss": GaussianParams(**{k: torch.from_numpy(x)
                                       for k, x in v.items()}), "flame": {}},
        count=1, max_radii2d=tmodel.max_radii2d,
        grad_accum=tmodel.xyz_gradient_accum, denom=tmodel.denom)
    path = str(tmp_path / "chkpnt1.npz")
    save_checkpoint(tmodel, state, 1, path)
    data = dict(np.load(path))
    del data["g_features_rest_layout"]
    old = str(tmp_path / "old_layout.npz")
    np.savez(old, **data)
    with pytest.raises(ValueError, match="old_layout.npz"):
        load_checkpoint(old, empty())
    data["g_features_rest_layout"] = np.asarray("kmajor")
    np.savez(old, **data)
    with pytest.raises(ValueError, match="kmajor"):
        load_checkpoint(old, empty())


def test_flame_model_from_assets(tmp_path):
    paths = make_flame_assets(str(tmp_path), seed=0)
    model = FlameGaussianModel.from_assets(1, str(tmp_path), device="cpu")
    head = FlameHead(300, 100, flame_model_path=paths["model"],
                     flame_template_mesh_path=paths["obj"], device="cpu")
    assert torch.equal(model.flame_model.faces, head.faces)
    assert torch.equal(model.binding, torch.arange(head.num_faces))
    assert torch.equal(model.binding_counter,
                       torch.ones(head.num_faces, dtype=torch.int64))
