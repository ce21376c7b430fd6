"""The sort binning (`--binning sort`) through the port's render, train
step, sharded render and step, and entry points.

The model is the JAX bound bench avatar (1 Gaussian per face, SH 3)
carried into the port (`convert.from_jax_arrays`, through
`tests/torch_ranks.py`'s model file). Tolerances:
  * `make_render_fn` with `PipelineConfig(binning="sort")` against JAX's
    with `binning="sort"`: atol 5e-5 (the bound render's gate);
  * one `make_train_step` with the sort binning against JAX's: losses rtol
    1e-5, every gradient leaf (through Adam's first moment) and
    `grad_accum` max|d| / max|JAX| <= 2e-4, `denom` and `max_radii2d`
    equal (the step's gates);
  * the port's sort step against its dense step from the same state: the
    same gates (the densification statistics do not depend on the
    binning: radii and visibility equal, the means2d gradient within
    2e-4);
  * the sharded render (2 gloo ranks) with the sort binning against
    `make_render_fn`'s sort image: max|d| <= 1e-5; the sharded step on a
    1 x 2 mesh against the one-device sort step: the step's gates;
  * `python -m gaussianavatars_torch.train --binning sort --device cpu`
    trains and writes its PLY, and `render --binning sort` renders it.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianavatars_tpu.benchmark import (
    make_bound_bench_model as jax_bound_model,
)
from gaussianavatars_tpu.config import OptimizationConfig as JaxOpt
from gaussianavatars_tpu.config import PipelineConfig as JaxPipeline
from gaussianavatars_tpu.models.gaussians import GaussianParams as JaxParams
from gaussianavatars_tpu.train import optim as jax_optim
from gaussianavatars_tpu.train.loop import (
    StepState as JaxStepState,
    binding_arg,
    camera_arrays as jax_camera_arrays,
    lr_pytree as jax_lr_pytree,
    make_render_fn as jax_make_render_fn,
    make_train_step as jax_make_train_step,
)
from gaussianavatars_torch.config import OptimizationConfig, PipelineConfig
from gaussianavatars_torch.models.gaussians import GaussianParams
from gaussianavatars_torch.render import __main__ as render_cli
from gaussianavatars_torch.train import optim
from gaussianavatars_torch.train.loop import (
    camera_arrays,
    initial_state,
    lr_pytree,
    make_render_fn,
    make_train_step,
)

from . import torch_ranks
from .flame_fixtures import make_flame_assets
from .test_torch_blend import one_torch_thread  # noqa: F401
from .torch_fixtures import make_port_avatar_dataset
from .utils import make_camera

W, H = 64, 48
GRAD_REL = 2e-4
TIMESTEP = 1
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def _jax_pipe(binning):
    return JaxPipeline(backend="jnp", capacity=1 << 16, chunk=16,
                       tile_size=32, binning=binning)


@pytest.fixture(scope="module")
def carried(tmp_path_factory):
    """The JAX avatar, its file for the ranks and the port's copy, one
    64x48 view (timestep 1) with a random ground truth."""
    root = tmp_path_factory.mktemp("carried")
    jmodel = jax_bound_model(sh_degree=3, n_per_face=1, seed=0,
                             num_timesteps=4)
    paths = make_flame_assets(str(root / "flame"), seed=0)
    torch_ranks.save_model(
        root / "model0.npz",
        {k: np.asarray(getattr(jmodel.params, k)) for k in JaxParams._fields},
        np.asarray(jmodel.binding_device()),
        {k: np.asarray(v) for k, v in jmodel.flame_param.items()}, 3, paths,
        jmodel.n_alive)
    cam = make_camera(width=W, height=H, fovx=0.5, dist=1.0)
    gt = np.random.default_rng(2).random((3, H, W)).astype(np.float32)
    views = dict(gts=gt[None], bgs=np.ones((1, 3), np.float32),
                 timesteps=np.asarray([TIMESTEP], np.int32))
    views.update({f"c0_{k}": np.asarray(getattr(cam, k), np.float32)
                  for k in ("viewmatrix", "projmatrix", "campos")})
    views.update(c0_tan_fovx=np.float32(cam.tan_fovx),
                 c0_tan_fovy=np.float32(cam.tan_fovy))
    np.savez(root / "views.npz", **views)
    tmodel = torch_ranks._carried_model(str(root / "model0.npz"))
    return dict(root=root, jmodel=jmodel, tmodel=tmodel, cam=cam, gt=gt,
                tcam=torch_ranks._camera(views, "c0_"))


def test_sort_render_matches_jax(carried):
    jmodel, tmodel = carried["jmodel"], carried["tmodel"]
    ref = jax_make_render_fn(jmodel, _jax_pipe("sort"), W, H, 3)(
        jmodel.params, dict(jmodel.flame_param), binding_arg(jmodel),
        jmodel.active_mask(), jax_camera_arrays(carried["cam"]),
        jnp.ones(3), jnp.int32(TIMESTEP))
    outs = {b: make_render_fn(tmodel, PipelineConfig(binning=b), W, H, 3)(
        tmodel.params, tmodel.flame_param, tmodel.binding,
        camera_arrays(carried["tcam"]), torch.ones(3), TIMESTEP)
        for b in ("sort", "dense")}
    assert outs["sort"].image.std() > 0.01
    assert outs["sort"].instance_total > outs["dense"].instance_total
    np.testing.assert_allclose(outs["sort"].image.numpy(), np.asarray(ref),
                               atol=5e-5, rtol=0)


def _port_step(carried, binning):
    tmodel = carried["tmodel"]
    state = optim.tree_map(
        lambda x: x.clone() if isinstance(x, torch.Tensor) else x,
        initial_state(tmodel))
    step = make_train_step(tmodel, OptimizationConfig(),
                           PipelineConfig(binning=binning), W, H, 3, 4)
    fixed = {k: v for k, v in tmodel.flame_param.items()
             if k not in state.flame_tr}
    ts, tl, total = step(state, fixed, tmodel.binding,
                         camera_arrays(carried["tcam"]),
                         torch.from_numpy(carried["gt"]), torch.ones(3),
                         TIMESTEP, lr_pytree(OptimizationConfig(), 1e-3,
                                             state.flame_tr, 1.0))
    return ts, {k: float(v) for k, v in tl.items()}, total


def _check_steps(ts, tl, ref_state, ref_losses, n):
    """Port step (ts, tl) against a reference step's numpy state and
    losses at the step's gates."""
    assert set(tl) == set(ref_losses)
    for k in ref_losses:
        np.testing.assert_allclose(tl[k], ref_losses[k], rtol=1e-5,
                                   err_msg=k)
    for leaf in GaussianParams._fields:
        ref = np.asarray(ref_state["mu"]["gauss"][leaf])[:n]
        assert np.abs(ref).max() > 0, leaf
        assert _rel(getattr(ts.mu["gauss"], leaf).numpy(), ref) <= \
            GRAD_REL, leaf
    for leaf, ref in ref_state["mu"]["flame"].items():
        assert _rel(ts.mu["flame"][leaf].numpy(), ref) <= GRAD_REL, leaf
    assert _rel(ts.grad_accum.numpy(), ref_state["grad_accum"][:n]) <= \
        GRAD_REL
    np.testing.assert_array_equal(ts.denom.numpy(), ref_state["denom"][:n])
    np.testing.assert_array_equal(ts.max_radii2d.numpy(),
                                  ref_state["max_radii2d"][:n])


def _np_state(state):
    return {"mu": {"gauss": {k: np.asarray(getattr(state.mu["gauss"], k))
                             for k in state.mu["gauss"]._fields},
                   "flame": {k: np.asarray(v)
                             for k, v in state.mu["flame"].items()}},
            "grad_accum": np.asarray(state.grad_accum),
            "denom": np.asarray(state.denom),
            "max_radii2d": np.asarray(state.max_radii2d)}


def test_sort_train_step_matches_jax(carried):
    jmodel = carried["jmodel"]
    flame_tr = jmodel.flame_trainable()
    mu, nu, count = jax_optim.init({"gauss": jmodel.params,
                                    "flame": flame_tr})
    jstate = JaxStepState(
        params=jmodel.params, flame_tr=flame_tr, mu=mu, nu=nu, count=count,
        max_radii2d=jmodel.max_radii2d, grad_accum=jmodel.xyz_gradient_accum,
        denom=jmodel.denom)
    opt = JaxOpt()
    jstep = jax_make_train_step(jmodel, opt, _jax_pipe("sort"), W, H, 3, 4)
    fixed = {k: v for k, v in jmodel.flame_param.items()
             if k not in flame_tr}
    js, jl, _ = jstep(jstate, fixed, binding_arg(jmodel),
                      jmodel.active_mask(), jax_camera_arrays(carried["cam"]),
                      jnp.asarray(carried["gt"]), jnp.ones(3),
                      jnp.int32(TIMESTEP),
                      jax_lr_pytree(opt, 1e-3, flame_tr, 1.0))
    ts, tl, total = _port_step(carried, "sort")
    assert total > 0
    _check_steps(ts, tl, _np_state(js), {k: float(v) for k, v in jl.items()},
                 carried["tmodel"].num_gaussians)


def test_sort_step_statistics_match_dense(carried):
    sort_s, sort_l, sort_total = _port_step(carried, "sort")
    dense_s, dense_l, dense_total = _port_step(carried, "dense")
    assert sort_total > dense_total
    _check_steps(sort_s, sort_l, _np_state(dense_s), dense_l,
                 carried["tmodel"].num_gaussians)


def test_sharded_sort_render_matches_single(tmp_path):
    from .test_torch_parallel import _cam_arrays, _scene_params

    cam = make_camera(width=64, height=64)
    arrays = _scene_params(64, seed=64)
    np.savez(tmp_path / "scene.npz", **arrays, **_cam_arrays(cam))
    torch_ranks.run_ranks(torch_ranks.sharded_render, 2, tmp_path,
                          width=64, height=64, sh_degree=2, tile_size=16,
                          binning="sort")
    from gaussianavatars_torch.models.gaussians import GaussianModel

    model = GaussianModel(2, GaussianParams(**{
        k: torch.from_numpy(v) for k, v in arrays.items()}), device="cpu")
    single = make_render_fn(
        model, PipelineConfig(tile_size=16, binning="sort"), 64, 64, 2)(
        model.params, None, None,
        camera_arrays(torch_ranks._camera(_cam_arrays(cam))),
        torch.ones(3)).image.numpy()
    assert single.std() > 0.01
    for r in range(2):
        np.testing.assert_allclose(np.load(tmp_path / f"image_{r}.npy"),
                                   single, atol=1e-5, rtol=0)


def test_sharded_sort_step_matches_single(carried):
    root = carried["root"]
    torch_ranks.run_ranks(torch_ranks.train_step, 2, root, n_data=1,
                          width=W, height=H, tile_size=32, subjects=False,
                          binning="sort")
    outs = [dict(np.load(root / f"out_{r}.npz")) for r in range(2)]
    ts, tl, _ = _port_step(carried, "sort")
    n = carried["tmodel"].num_gaussians
    for k in outs[0]:
        if k.startswith("loss_"):
            np.testing.assert_allclose(outs[0][k], tl[k[5:]], rtol=1e-5,
                                       err_msg=k)
    joined = {k: np.concatenate([o[k] for o in outs]) for k in
              ["grad_accum", "denom", "max_radii2d"]
              + [f"mu_{f}" for f in GaussianParams._fields]}
    for f in GaussianParams._fields:
        assert _rel(joined[f"mu_{f}"], getattr(ts.mu["gauss"], f).numpy()) \
            <= GRAD_REL, f
    for k, v in ts.mu["flame"].items():
        assert _rel(outs[0][f"fmu_{k}"], v.numpy()) <= GRAD_REL, k
    assert _rel(joined["grad_accum"], ts.grad_accum.numpy()) <= GRAD_REL
    np.testing.assert_array_equal(joined["denom"], ts.denom.numpy())
    np.testing.assert_array_equal(joined["max_radii2d"],
                                  ts.max_radii2d.numpy())
    assert joined["denom"].shape[0] == n


def test_entry_points_take_binning_sort(tmp_path_factory, tmp_path,
                                       monkeypatch):
    data, assets = make_port_avatar_dataset(tmp_path_factory.mktemp("data"))
    out = str(tmp_path / "model")
    env = dict(os.environ, FLAME_ASSET_DIR=assets, OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "gaussianavatars_torch.train", "-s", data,
         "-m", out, "--bind_to_mesh", "--eval", "--sh_degree", "1",
         "--iterations", "2", "--tile_size", "16", "--binning", "sort",
         "--no_gui", "--device", "cpu", "--quiet"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    assert os.path.exists(os.path.join(out, "point_cloud", "iteration_2",
                                       "point_cloud.ply"))
    monkeypatch.setenv("FLAME_ASSET_DIR", assets)
    result = render_cli.main(["-m", out, "--skip_train", "--skip_test",
                              "--tile_size", "16", "--binning", "sort",
                              "--device", "cpu", "--quiet"])
    assert result["val"]["images"] == 2
