"""The port's diagnostic tools against the root `tools/` of the JAX
package.

`gaussianavatars_torch/tools/parity_vs_reference.py`:
  * `check_assets` passes on the synthetic FLAME assets (the real
    topology's dimensions and the teeth faces' sha256);
  * `exchange_cameras` equals the JAX tool's matrices (atol 1e-6);
  * `compare` accepts identical dumps and rejects divergent ones;
  * a port `dump` of the carried bench avatar against the JAX tool's dump
    of the same PLY and flame_param.npz, both tools at 64x44: `compare`
    accepts them, and beyond its loose reference-parity tolerances every
    view is within 5e-5 (the bound render's gate) on all but 1e-3 of its
    values and within 2/255 on every one (an alpha at the 1/255 threshold
    may flip under float32 rounding: 3 of 8448 values do at 64x44), and
    every gradient within max|d| / max|JAX| <= 2e-4 (the train step's
    gate); a dense and a sort dump of the same model (`--binning`) pass
    `compare` too.

`gaussianavatars_torch/tools/diag_eval_views.py` on a tiny bound-avatar
recovery run (2 timesteps, 2 cameras a ring, 48x40, 3 iterations): every
val and test view listed, the worst triples written, each view's PSNR
within 1e-3 dB of the JAX tool's on the same run directory, and each
split's mean within 1e-3 dB of the training's `evaluate_splits`.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from gaussianavatars_torch.config import (
    ModelConfig,
    OptimizationConfig,
    PipelineConfig,
)
from gaussianavatars_torch.convert import from_jax_arrays
from gaussianavatars_torch.tools import diag_eval_views as tdiag
from gaussianavatars_torch.tools import parity_vs_reference as tpvr
from gaussianavatars_torch.utils.png import read_png

from .flame_fixtures import make_flame_assets
from .test_torch_blend import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DUMP_W, DUMP_H = 64, 44
GRAD_REL = 2e-4
# a Gaussian whose alpha sits at the blend's 1/255 threshold may fall on
# either side under float32 rounding of the two packages' projections
FLIP_SHARE, FLIP_MAX = 1e-3, 2.0 / 255.0


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", os.path.join(REPO, "tools", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_check_assets_on_synthetic(tmp_path):
    make_flame_assets(str(tmp_path))
    assert tpvr.check_assets(str(tmp_path), device="cpu")


def test_exchange_cameras_match_jax():
    ours, ref = tpvr.exchange_cameras(), _jax_tool(
        "parity_vs_reference").exchange_cameras()
    assert len(ours) == len(ref) == tpvr.N_VIEWS
    for a, b in zip(ours, ref):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_allclose(np.asarray(a[k]), np.asarray(b[k]),
                                       atol=1e-6, rtol=0, err_msg=k)
    assert not np.allclose(ours[0]["world_view_transform"],
                           ours[3]["world_view_transform"])


def _fake_dump(d, rng, perturb=0.0):
    os.makedirs(d, exist_ok=True)
    for i in range(tpvr.N_VIEWS):
        np.save(os.path.join(d, f"view_{i}.npy"),
                rng.random((3, 8, 8)).astype(np.float32) + perturb)
    np.savez(os.path.join(d, "grads.npz"), **{
        k: rng.normal(size=(16, 3)).astype(np.float32) + perturb
        for k in ("d_xyz", "d_opacity", "d_scaling", "d_rotation",
                  "d_f_dc")})


def test_compare_accepts_identical_and_rejects_divergent(tmp_path):
    a, b, c = (str(tmp_path / n) for n in "abc")
    _fake_dump(a, np.random.default_rng(1))
    _fake_dump(b, np.random.default_rng(1))
    _fake_dump(c, np.random.default_rng(1), perturb=0.25)
    assert tpvr.compare(a, b)
    assert not tpvr.compare(a, c)
    os.remove(os.path.join(b, "view_3.npy"))
    assert not tpvr.compare(a, b)


@pytest.fixture(scope="module")
def avatar_ply(tmp_path_factory):
    """The JAX bound bench avatar (1 Gaussian per face, SH 3), written by
    the port as point_cloud.ply + flame_param.npz; returns (ply path,
    FLAME asset dir)."""
    from gaussianavatars_tpu.benchmark import make_bound_bench_model

    root = tmp_path_factory.mktemp("avatar")
    jmodel = make_bound_bench_model(sh_degree=3, n_per_face=1, seed=0,
                                    num_timesteps=4)
    paths = make_flame_assets(str(root / "flame"), seed=0)
    n = jmodel.n_alive
    tmodel = from_jax_arrays(
        {k: np.asarray(v)[:n] for k, v in jmodel.params._asdict().items()},
        np.asarray(jmodel.binding_device())[:n],
        {k: np.asarray(v) for k, v in jmodel.flame_param.items()},
        sh_degree=3, n_alive=n, flame_model_path=paths["model"],
        flame_template_mesh_path=paths["obj"], spatial_lr_scale=1.0,
        device="cpu")
    ply = str(root / "model" / "point_cloud.ply")
    os.makedirs(os.path.dirname(ply))
    tmodel.save_ply(ply)
    return ply, str(root / "flame")


def test_dump_matches_jax(avatar_ply, tmp_path, monkeypatch):
    ply, assets = avatar_ply
    monkeypatch.setenv("FLAME_ASSET_DIR", assets)
    jpvr = _jax_tool("parity_vs_reference")
    for mod in (tpvr, jpvr):
        monkeypatch.setattr(mod, "WIDTH", DUMP_W)
        monkeypatch.setattr(mod, "HEIGHT", DUMP_H)
    ours, ref, sort = (str(tmp_path / n) for n in ("port", "jax", "sort"))
    tpvr.dump(tpvr.load_model(ply, 3, "cpu"), ours, timestep=1)
    jpvr.dump(jpvr.load_model(ply, 3), ref, timestep=1)
    assert tpvr.compare(ours, ref)
    for i in range(tpvr.N_VIEWS):
        a, b = (np.load(os.path.join(d, f"view_{i}.npy")) for d in (ours, ref))
        assert a.shape == (3, DUMP_H, DUMP_W)
        d = np.abs(a - b)
        assert np.mean(d > 5e-5) <= FLIP_SHARE and d.max() <= FLIP_MAX, i
    assert np.load(os.path.join(ours, "view_0.npy")).std() > 0.01
    ga, gb = np.load(os.path.join(ours, "grads.npz")), np.load(
        os.path.join(ref, "grads.npz"))
    assert sorted(ga.files) == sorted(gb.files)
    for k in gb.files:
        assert ga[k].shape == gb[k].shape, k
        assert np.abs(gb[k]).max() > 0, k
        rel = np.abs(ga[k] - gb[k]).max() / np.abs(gb[k]).max()
        assert rel <= GRAD_REL, (k, rel)
    assert ga["d_f_dc"].shape[1:] == (1, 3)

    # the CLI: a sort dump of the same model against the dense one
    with pytest.raises(SystemExit) as exit_:
        tpvr.main(["--point_path", ply, "--out", sort, "--timestep", "1",
                   "--binning", "sort", "--device", "cpu"])
    assert exit_.value.code == 0
    assert tpvr.compare(sort, ours)


@pytest.fixture(scope="module")
def recovery_run(tmp_path_factory):
    """A tiny bound-avatar recovery run directory (data/, assets/, out/)
    with the PLY of iteration 3 and its evaluation."""
    from gaussianavatars_torch.data.scene import Scene
    from gaussianavatars_torch.examples import bound_avatar_recovery as bound
    from gaussianavatars_torch.models.flame_gaussians import (
        FlameGaussianModel,
    )
    from gaussianavatars_torch.train.loop import training

    run = str(tmp_path_factory.mktemp("run"))
    data, assets = os.path.join(run, "data"), os.path.join(run, "assets")
    bound.write_dataset(data, assets, 48, 40, t_steps=2, n_cams=2)
    cfg = ModelConfig(source_path=data, model_path=os.path.join(run, "out"),
                      bind_to_mesh=True, eval=True, sh_degree=2,
                      white_background=True, not_finetune_flame_params=True)
    mp = pytest.MonkeyPatch()
    mp.setenv("FLAME_ASSET_DIR", assets)
    try:
        os.makedirs(cfg.model_path)
        gt = FlameGaussianModel.from_assets(2, device="cpu")
        scene = Scene(cfg, gt)
        bound.paint_gt_model(gt)
        bound.render_gt_images(gt, scene, cfg, PipelineConfig(tile_size=16),
                               torch.device("cpu"))
        _, _, info = training(
            cfg, OptimizationConfig(
                iterations=3, densify_from_iter=400, densify_until_iter=2,
                densification_interval=300, opacity_reset_interval=30,
                position_lr_max_steps=3),
            PipelineConfig(tile_size=16), testing_iterations={3},
            saving_iterations={3}, device="cpu")
    finally:
        mp.undo()
    return run, info["metrics"][3]


def test_diag_eval_views_matches_jax(recovery_run, tmp_path, monkeypatch,
                                     capsys):
    run, metrics = recovery_run
    rows = tdiag.main(["--run", run, "--out", str(tmp_path / "port"),
                       "--worst", "2", "--device", "cpu"])
    printed = capsys.readouterr().out
    assert [r[0] for r in rows] == ["val", "val", "test", "test"]
    for split in ("val", "test"):
        mean = np.mean([r[3] for r in rows if r[0] == split])
        assert abs(mean - metrics[split]["psnr"]) <= 1e-3, split
    table = [line.split() for line in printed.splitlines()
             if line.startswith(("val ", "test "))]
    assert sorted((s, int(t), int(c)) for s, t, c, _ in table) == sorted(
        (r[0], r[1], r[2]) for r in rows)
    worst = sorted(rows, key=lambda r: r[3])[:2]
    for i, (split, t, c, _, img, gt) in enumerate(worst):
        base = tmp_path / "port" / f"worst{i}_{split}_t{t}_c{c}"
        np.testing.assert_array_equal(
            read_png(f"{base}_render.png"),
            (img.transpose(1, 2, 0) * 255).astype(np.uint8))
        assert read_png(f"{base}_gt.png").shape == (40, 48, 3)
        assert read_png(f"{base}_err.png").shape == (40, 48)

    # the JAX tool on the same run directory, its PSNR of every view
    # recorded as it computes them (it prints two decimals)
    import gaussianavatars_tpu.utils.image as jimage

    seen = []
    real = jimage.psnr

    def psnr(a, b):
        out = real(a, b)
        seen.append(float(np.asarray(out[0])))
        return out

    monkeypatch.setattr(jimage, "psnr", psnr)
    monkeypatch.setenv("FLAME_ASSET_DIR", os.path.join(run, "assets"))
    jdiag = _jax_tool("diag_eval_views")
    monkeypatch.setattr("sys.argv", ["diag_eval_views", "--run", run,
                                     "--out", str(tmp_path / "jax"),
                                     "--worst", "2"])
    jdiag.main()
    assert len(seen) == len(rows)
    for r, ref in zip(rows, seen):
        assert abs(r[3] - ref) <= 1e-3, (r[:3], r[3], ref)
    assert sorted(os.listdir(tmp_path / "jax")) == sorted(
        os.listdir(tmp_path / "port"))
