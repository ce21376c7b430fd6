"""The reference's pipeline options in the port against the JAX package.

  * `project_gaussians` with `scaling_modifier`, `colors_precomp` or
    `cov3d_precomp` against JAX's (atol 1e-6 / rtol 1e-5, radii and
    visibility equal), and `rasterize` with each against JAX's jnp
    rasterizer (atol 1e-5, a small scene);
  * `eval_sh` against JAX's on [N, 3, K] coefficients (atol 1e-6);
  * `make_render_fn` with `convert_SHs_python`, `compute_cov3D_python` or
    both against JAX `make_render_fn` with the same options (atol 5e-5,
    the render tolerance), on the bound bench avatar carried across;
  * one `make_train_step` with each option against JAX's step: losses
    rtol 1e-5, gradients per leaf max|d| / max|ref| <= 2e-4. The JAX
    train step reads neither option (only its `make_render_fn` does), so
    its default step is the reference: the colours and covariances are the
    same functions, computed outside the rasterizer, with their gradients
    through autograd;
  * `training(debug_from=N)` sets `pipe_cfg.debug` from iteration N on,
    and with it a non-finite loss stops the run with a state snapshot;
  * `python -m gaussianavatars_torch.train` and `.render` accept the root
    tools' pipeline flags (`--convert_SHs_python`, `--compute_cov3D_python`,
    `--debug`, and `--debug_from` / `--detect_anomaly` for training).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianavatars_tpu.benchmark import (
    make_bound_bench_model as jax_bound_model,
)
from gaussianavatars_tpu.config import OptimizationConfig as JaxOpt
from gaussianavatars_tpu.config import PipelineConfig as JaxPipeline
from gaussianavatars_tpu.ops import covariance as jcov
from gaussianavatars_tpu.ops import projection as jproj
from gaussianavatars_tpu.ops import sh as jsh
from gaussianavatars_tpu.ops.rasterize_tiles import rasterize as jrasterize
from gaussianavatars_tpu.train import optim as jax_optim
from gaussianavatars_tpu.train.loop import (
    StepState as JaxStepState,
    binding_arg,
    camera_arrays as jax_camera_arrays,
    lr_pytree as jax_lr_pytree,
    make_render_fn as jax_make_render_fn,
    make_train_step as jax_make_train_step,
)
from gaussianavatars_torch import benchmark as tbench
from gaussianavatars_torch.config import (
    ModelConfig,
    OptimizationConfig,
    PipelineConfig,
)
from gaussianavatars_torch.convert import from_jax_arrays
from gaussianavatars_torch.models.gaussians import (
    GaussianParams,
    world_space_gaussians,
)
from gaussianavatars_torch.ops import projection as tproj
from gaussianavatars_torch.ops import sh as tsh
from gaussianavatars_torch.ops.projection import CameraParams
from gaussianavatars_torch.ops.rasterize_tiles import rasterize
from gaussianavatars_torch.render import __main__ as render_cli
from gaussianavatars_torch.train import __main__ as train_cli
from gaussianavatars_torch.train import loop, optim
from gaussianavatars_torch.train.loop import (
    camera_arrays,
    initial_state,
    lr_pytree,
    make_render_fn,
    make_train_step,
)

from .flame_fixtures import make_flame_assets
from .utils import make_camera, make_scene
from .test_torch_blend import one_torch_thread  # noqa: F401
from .torch_fixtures import make_port_avatar_dataset

W, H = 64, 48
GRAD_REL = 2e-4
OPTIONS = {"convert_SHs_python": dict(convert_SHs_python=True),
           "compute_cov3D_python": dict(compute_cov3D_python=True),
           "both": dict(convert_SHs_python=True, compute_cov3D_python=True)}


def _t(a):
    return torch.from_numpy(np.array(a))


def _torch_camera(cam):
    return CameraParams(
        viewmatrix=_t(cam.viewmatrix), projmatrix=_t(cam.projmatrix),
        campos=_t(cam.campos), tan_fovx=cam.tan_fovx,
        tan_fovy=cam.tan_fovy, width=cam.width, height=cam.height)


def _precomputed(scene, arg, rng):
    """The option's value for `scene`, as numpy."""
    n = scene["means3d"].shape[0]
    if arg == "scaling_modifier":
        return 1.7
    if arg == "colors_precomp":
        return rng.random((n, 3)).astype(np.float32)
    return np.asarray(jcov.build_covariance_3d(
        np.asarray(scene["scales"]) * 1.3, np.asarray(scene["quats"])))


@pytest.mark.parametrize("arg", ["scaling_modifier", "colors_precomp",
                                 "cov3d_precomp"])
def test_project_gaussians_options_match_jax(arg):
    cam = make_camera(width=64, height=48, fovx=0.9, dist=3.0)
    scene = make_scene(n=200, seed=1, sh_degree=2)
    value = _precomputed(scene, arg, np.random.default_rng(2))
    args = [np.array(scene[k]) for k in
            ("means3d", "scales", "quats", "opacities", "shs")]
    ref = jproj.project_gaussians(*[jnp.asarray(a) for a in args], 2, cam,
                                  **{arg: value})
    out = tproj.project_gaussians(
        *[torch.from_numpy(a) for a in args], 2, _torch_camera(cam),
        **{arg: value if arg == "scaling_modifier"
           else torch.from_numpy(value)})
    default = tproj.project_gaussians(*[torch.from_numpy(a) for a in args],
                                      2, _torch_camera(cam))
    for name in out._fields:
        a, b = getattr(out, name).numpy(), np.asarray(getattr(ref, name))
        if name in ("radii", "valid"):
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            np.testing.assert_allclose(a, b, atol=1e-6, rtol=1e-5,
                                       err_msg=name)
    changed = "colors" if arg == "colors_precomp" else "conics"
    assert not torch.allclose(getattr(out, changed),
                              getattr(default, changed))


@pytest.mark.parametrize("arg", ["scaling_modifier", "colors_precomp",
                                 "cov3d_precomp"])
def test_rasterize_options_match_jax(arg):
    cam = make_camera(width=48, height=40)
    scene = make_scene(n=80, seed=0, sh_degree=2)
    value = _precomputed(scene, arg, np.random.default_rng(3))
    ref = jrasterize(
        *[jnp.asarray(scene[k]) for k in
          ("means3d", "scales", "quats", "opacities", "shs")], 2, cam,
        jnp.ones(3), capacity=1 << 14, tile_size=16, chunk=16,
        backend="jnp", binning_impl="dense", **{arg: value})
    out = rasterize(
        *[_t(scene[k]) for k in
          ("means3d", "scales", "quats", "opacities", "shs")], 2,
        _torch_camera(cam), torch.ones(3), tile_size=16,
        **{arg: value if arg == "scaling_modifier" else _t(value)})
    assert out.instance_total > 0
    np.testing.assert_allclose(out.image.numpy(), np.asarray(ref.image),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("degree", [0, 1, 2, 3, 4])
def test_eval_sh_matches_jax(degree):
    rng = np.random.default_rng(degree)
    sh = rng.normal(size=(50, 3, 25)).astype(np.float32)
    dirs = rng.normal(size=(50, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    assert tsh.num_sh_coeffs(degree) == jsh.num_sh_coeffs(degree)
    np.testing.assert_allclose(
        tsh.eval_sh(degree, _t(sh), _t(dirs)).numpy(),
        np.asarray(jsh.eval_sh(degree, jnp.asarray(sh), jnp.asarray(dirs))),
        atol=1e-6, rtol=1e-5)


@pytest.fixture(scope="module")
def carried(tmp_path_factory):
    """The JAX bound bench avatar (1 Gaussian per face, SH 3) and the
    port's copy of it, with a zero Adam state."""
    jmodel = jax_bound_model(sh_degree=3, n_per_face=1, seed=0,
                             num_timesteps=4)
    paths = make_flame_assets(str(tmp_path_factory.mktemp("flame")), seed=0)
    flame_tr = jmodel.flame_trainable()
    mu, nu, count = jax_optim.init({"gauss": jmodel.params,
                                    "flame": flame_tr})

    def np_tree(tree):
        if isinstance(tree, dict):
            return {k: np_tree(v) for k, v in tree.items()}
        if hasattr(tree, "_fields"):
            return {k: np_tree(getattr(tree, k)) for k in tree._fields}
        return np.array(tree)

    tmodel = from_jax_arrays(
        np_tree(jmodel.params), jmodel.binding,
        np_tree(dict(jmodel.flame_param)), sh_degree=3,
        n_alive=jmodel.n_alive, flame_model_path=paths["model"],
        flame_template_mesh_path=paths["obj"],
        opt_state=(np_tree(mu), np_tree(nu), int(count)),
        stats={"max_radii2d": np.asarray(jmodel.max_radii2d),
               "xyz_gradient_accum": np.asarray(jmodel.xyz_gradient_accum),
               "denom": np.asarray(jmodel.denom)},
        spatial_lr_scale=1.0, device="cpu")
    return dict(jmodel=jmodel, tmodel=tmodel, flame_tr=flame_tr, mu=mu,
                nu=nu, count=count, np_tree=np_tree)


@pytest.mark.parametrize("option", list(OPTIONS))
def test_render_options_match_jax(carried, option):
    jmodel, tmodel = carried["jmodel"], carried["tmodel"]
    jcam = make_camera(width=W, height=H, fovx=0.5, dist=1.0)
    jrender = jax_make_render_fn(
        jmodel, JaxPipeline(backend="jnp", capacity=1 << 16, chunk=16,
                            tile_size=32, **OPTIONS[option]), W, H, 3)
    trender = make_render_fn(tmodel, PipelineConfig(**OPTIONS[option]), W, H,
                             3)
    tcam = camera_arrays(tbench.bench_camera(W, H, device="cpu"))
    bg = np.ones(3, np.float32)
    ref = jrender(jmodel.params, dict(jmodel.flame_param),
                  binding_arg(jmodel), jmodel.active_mask(),
                  jax_camera_arrays(jcam), jnp.asarray(bg), jnp.int32(1))
    out = trender(tmodel.params, tmodel.flame_param, tmodel.binding, tcam,
                  torch.from_numpy(bg), 1)
    assert out.image.std() > 0.01
    np.testing.assert_allclose(out.image.numpy(), np.asarray(ref),
                               atol=5e-5, rtol=0)


@pytest.fixture(scope="module")
def jax_step(carried):
    """One JAX train step of the carried avatar (timestep 1, a random
    ground truth)."""
    jmodel = carried["jmodel"]
    flame_tr = carried["flame_tr"]
    jstate = JaxStepState(
        params=jmodel.params, flame_tr=flame_tr, mu=carried["mu"],
        nu=carried["nu"], count=carried["count"],
        max_radii2d=jmodel.max_radii2d,
        grad_accum=jmodel.xyz_gradient_accum, denom=jmodel.denom)
    opt = JaxOpt()
    jstep = jax_make_train_step(
        jmodel, opt, JaxPipeline(backend="jnp", capacity=1 << 16, chunk=16,
                                 tile_size=32), W, H, 3, 4)
    gt = np.random.default_rng(2).random((3, H, W)).astype(np.float32)
    jcam = make_camera(width=W, height=H, fovx=0.5, dist=1.0)
    fixed = {k: v for k, v in jmodel.flame_param.items()
             if k not in flame_tr}
    js, jl, _ = jstep(jstate, fixed, binding_arg(jmodel),
                      jmodel.active_mask(), jax_camera_arrays(jcam),
                      jnp.asarray(gt), jnp.ones(3), jnp.int32(1),
                      jax_lr_pytree(opt, 1e-3, flame_tr, 1.0))
    return dict(state=carried["np_tree"](js),
                losses={k: float(v) for k, v in jl.items()}, gt=gt)


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


@pytest.mark.parametrize("option", list(OPTIONS))
def test_train_step_options_match_jax(carried, jax_step, option):
    tmodel = carried["tmodel"]
    state = initial_state(tmodel)
    state = optim.tree_map(
        lambda x: x.clone() if isinstance(x, torch.Tensor) else x, state)
    step = make_train_step(tmodel, OptimizationConfig(),
                           PipelineConfig(**OPTIONS[option]), W, H, 3, 4)
    fixed = {k: v for k, v in tmodel.flame_param.items()
             if k not in state.flame_tr}
    ts, tl, _ = step(state, fixed, tmodel.binding,
                     camera_arrays(tbench.bench_camera(W, H, device="cpu")),
                     torch.from_numpy(jax_step["gt"]), torch.ones(3), 1,
                     lr_pytree(OptimizationConfig(), 1e-3, state.flame_tr,
                               1.0))
    jl, js = jax_step["losses"], jax_step["state"]
    assert set(tl) == set(jl)
    for k in jl:
        np.testing.assert_allclose(float(tl[k]), jl[k], rtol=1e-5,
                                   err_msg=k)
    n = tmodel.num_gaussians
    for leaf in GaussianParams._fields:
        ref = js["mu"]["gauss"][leaf][:n]
        assert np.abs(ref).max() > 0, leaf
        assert _rel(getattr(ts.mu["gauss"], leaf).numpy(), ref) <= GRAD_REL, \
            leaf
    for leaf, ref in js["mu"]["flame"].items():
        assert _rel(ts.mu["flame"][leaf].numpy(), ref) <= GRAD_REL, leaf
    assert _rel(ts.grad_accum.numpy(), js["grad_accum"][:n]) <= GRAD_REL


def test_option_paths_match_default_path(carried):
    """On the port alone: with both options, the image and the gradients
    equal the default path's up to float32 reordering."""
    tmodel = carried["tmodel"]
    cam = tbench.bench_camera(W, H, device="cpu")
    out = {}
    for name, opts in (("default", {}), ("both", OPTIONS["both"])):
        params = GaussianParams(*[p.detach().clone().requires_grad_()
                                  for p in tmodel.params])
        frames = tmodel.face_frames_at(tmodel.flame_param, 0)
        m, s, q, o, shs = world_space_gaussians(params, tmodel.binding,
                                                frames)
        img = rasterize(m, s, q, o, shs, 3, cam, torch.ones(3),
                        **loop._precomputed(PipelineConfig(**opts), cam, m,
                                            s, q, shs, 3)).image
        grads = torch.autograd.grad((img * img).sum(), list(params))
        out[name] = (img.detach(), grads)
    assert (out["both"][0] - out["default"][0]).abs().max() <= 1e-5
    for g, g0 in zip(out["both"][1], out["default"][1]):
        assert _rel(g.numpy(), g0.numpy()) <= GRAD_REL


@pytest.fixture(scope="module")
def avatar_data(tmp_path_factory):
    return make_port_avatar_dataset(tmp_path_factory.mktemp("data"))


def _nan_after(monkeypatch, first_bad_call):
    """Make the loss stack's total non-finite from its `first_bad_call`-th
    call (counted from 1) on."""
    calls = [0]
    real = getattr(loop.compute_losses, "real", loop.compute_losses)

    def losses(*args, **kwargs):
        calls[0] += 1
        total, parts = real(*args, **kwargs)
        if calls[0] >= first_bad_call:
            total = total * float("nan")
        return total, parts

    losses.real = real
    monkeypatch.setattr(loop, "compute_losses", losses)


def test_debug_from_sets_debug_and_stops_on_nan(avatar_data, tmp_path,
                                                monkeypatch):
    data, assets = avatar_data
    monkeypatch.setenv("FLAME_ASSET_DIR", assets)
    schedule = dict(densify_from_iter=100, opacity_reset_interval=1000,
                    position_lr_max_steps=3)

    def cfg(out):
        return ModelConfig(source_path=data, model_path=str(tmp_path / out),
                           bind_to_mesh=True, sh_degree=1)

    _nan_after(monkeypatch, 2)
    # debug off until iteration 3: the non-finite loss of iteration 2 is
    # logged, not stopped at
    pipe = PipelineConfig(tile_size=16)
    _, _, info = loop.training(cfg("late"), OptimizationConfig(
        iterations=2, **schedule), pipe, log_every=1, debug_from=3,
        device="cpu")
    assert not pipe.debug and not np.isfinite(info["ema_loss"])
    _nan_after(monkeypatch, 2)
    pipe = PipelineConfig(tile_size=16)
    with pytest.raises(FloatingPointError, match="iteration 3"):
        loop.training(cfg("on"), OptimizationConfig(iterations=3,
                                                    **schedule), pipe,
                      log_every=1, debug_from=2, device="cpu")
    assert pipe.debug
    snap = np.load(str(tmp_path / "on" / "snapshot_fw_3.npz"))
    assert int(snap["iteration"]) == 3


def test_entry_points_take_pipeline_flags(avatar_data, tmp_path,
                                          monkeypatch):
    data, assets = avatar_data
    monkeypatch.setenv("FLAME_ASSET_DIR", assets)
    out = str(tmp_path / "model")
    train_cli.main(["-s", data, "-m", out, "--bind_to_mesh", "--eval",
                    "--sh_degree", "1", "--iterations", "2",
                    "--tile_size", "16", "--convert_SHs_python",
                    "--compute_cov3D_python", "--debug_from", "1",
                    "--detect_anomaly", "--device", "cpu", "--quiet"])
    assert os.path.exists(os.path.join(out, "point_cloud", "iteration_2",
                                       "point_cloud.ply"))
    assert not torch.is_anomaly_enabled()
    result = render_cli.main(["-m", out, "--skip_train", "--skip_test",
                              "--tile_size", "16", "--convert_SHs_python",
                              "--compute_cov3D_python", "--debug",
                              "--device", "cpu", "--quiet"])
    assert result["val"]["images"] == 2
