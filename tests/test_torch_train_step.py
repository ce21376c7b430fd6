"""The port's train step against the JAX package's `make_train_step` (jnp
backend) on the FLAME-bound bench avatar (1 Gaussian per face, SH 3,
64x48), carried across with its zero Adam state by `from_jax_arrays`.

Tolerances:
  * losses of one step: rtol 1e-5 (float32 sums in another order);
  * gradients, read from the first Adam moment as mu / (1 - B1), per
    leaf: max|d| / max|ref| <= 2e-4, the ROADMAP gradient tolerance (the
    JAX blend carries T in log space, the port as products);
  * densification statistics: grad_accum and the visible count as the
    gradients, max_radii2d exactly;
  * total loss of three steps: rtol 1e-3. Adam's first steps divide each
    gradient by its own magnitude, so a near-zero gradient whose sign
    differs between the two packages moves its parameter by a full lr.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gaussianavatars_tpu.benchmark import (
    make_bound_bench_model as jax_bound_model,
    scene_to_model as jax_scene_to_model,
)
from gaussianavatars_tpu.config import OptimizationConfig as JaxOpt
from gaussianavatars_tpu.config import PipelineConfig as JaxPipeline
from gaussianavatars_tpu.train import optim as jax_optim
from gaussianavatars_tpu.train.loop import (
    StepState as JaxStepState,
    binding_arg,
    camera_arrays as jax_camera_arrays,
    lr_pytree as jax_lr_pytree,
    make_train_step as jax_make_train_step,
)
from gaussianavatars_torch import bench as tbench_entry
from gaussianavatars_torch import benchmark as tbench
from gaussianavatars_torch.config import OptimizationConfig, PipelineConfig
from gaussianavatars_torch.convert import from_jax_arrays
from gaussianavatars_torch.models.gaussians import GaussianModel, GaussianParams
from gaussianavatars_torch.ops.projection import CameraParams
from gaussianavatars_torch.train import optim
from gaussianavatars_torch.train.loop import (
    camera_arrays,
    initial_state,
    lr_pytree,
    make_train_step,
)

from .flame_fixtures import make_flame_assets
from .utils import make_camera, make_scene
from .test_torch_blend import one_torch_thread  # noqa: F401

W, H = 64, 48
JAX_PIPE = JaxPipeline(backend="jnp", capacity=1 << 16, chunk=16,
                       tile_size=32, binning="dense")
GRAD_REL = 2e-4


def _np_tree(tree):
    """Copies to numpy (dicts and NamedTuples become dicts)."""
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return {k: _np_tree(getattr(tree, k)) for k in tree._fields}
    return np.array(tree)


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def _gt(seed=2):
    return np.random.default_rng(seed).random((3, H, W)).astype(np.float32)


@pytest.fixture(scope="module")
def bound(tmp_path_factory):
    """One JAX step and one port step from the same carried state; then
    two more steps of each."""
    jmodel = jax_bound_model(sh_degree=3, n_per_face=1, seed=0,
                             num_timesteps=4)
    n = jmodel.n_alive
    paths = make_flame_assets(str(tmp_path_factory.mktemp("flame")), seed=0)
    flame_tr = jmodel.flame_trainable()
    mu, nu, count = jax_optim.init({"gauss": jmodel.params,
                                    "flame": flame_tr})
    tmodel = from_jax_arrays(
        _np_tree(jmodel.params), jmodel.binding,
        _np_tree(dict(jmodel.flame_param)), sh_degree=3, n_alive=n,
        flame_model_path=paths["model"],
        flame_template_mesh_path=paths["obj"],
        opt_state=(_np_tree(mu), _np_tree(nu), int(count)),
        stats={"max_radii2d": np.asarray(jmodel.max_radii2d),
               "xyz_gradient_accum": np.asarray(jmodel.xyz_gradient_accum),
               "denom": np.asarray(jmodel.denom)},
        spatial_lr_scale=1.0, device="cpu")

    jcam = make_camera(width=W, height=H, fovx=0.5, dist=1.0)
    gt = _gt()
    bg = np.ones(3, np.float32)
    opt = JaxOpt()
    jstate = JaxStepState(
        params=jmodel.params, flame_tr=flame_tr, mu=mu, nu=nu, count=count,
        max_radii2d=jmodel.max_radii2d,
        grad_accum=jmodel.xyz_gradient_accum, denom=jmodel.denom)
    jstep = jax_make_train_step(jmodel, opt, JAX_PIPE, W, H, 3, 4)
    jfixed = {k: v for k, v in jmodel.flame_param.items() if k not in flame_tr}
    jlrs = jax_lr_pytree(opt, 1e-3, flame_tr, 1.0)

    def jax_step(state, timestep):
        return jstep(state, jfixed, binding_arg(jmodel),
                     jmodel.active_mask(), jax_camera_arrays(jcam),
                     jnp.asarray(gt), jnp.asarray(bg), jnp.int32(timestep),
                     jlrs)

    tstate = initial_state(tmodel)
    tstep = make_train_step(tmodel, OptimizationConfig(), PipelineConfig(),
                            W, H, 3, tmodel.num_timesteps)
    tfixed = {k: v for k, v in tmodel.flame_param.items()
              if k not in tstate.flame_tr}
    tlrs = lr_pytree(OptimizationConfig(), 1e-3, tstate.flame_tr, 1.0)
    tcam = camera_arrays(tbench.bench_camera(W, H, device="cpu"))

    def port_step(state, timestep):
        return tstep(state, tfixed, tmodel.binding, tcam,
                     torch.from_numpy(gt), torch.from_numpy(bg), timestep,
                     tlrs)

    flame_before = {k: v.clone() for k, v in tstate.flame_tr.items()}
    js, jl1, jtot1 = jax_step(jstate, 1)
    ts, tl1, ttot1 = port_step(tstate, 1)
    # copies: the JAX state goes into the next call, and the port's step
    # updates its state in place
    one = dict(jax=(_np_tree(js), {k: float(v) for k, v in jl1.items()},
                    int(jtot1)),
               port=(_clone(ts), {k: float(v) for k, v in tl1.items()},
                     ttot1),
               n=n, flame_before=flame_before)
    totals = []
    for timestep in (2, 3):
        js, jl, _ = jax_step(js, timestep)
        ts, tl, _ = port_step(ts, timestep)
        totals.append((float(jl["total"]), float(tl["total"])))
    one["three_step_totals"] = totals
    return one


def _clone(state):
    return optim.tree_map(
        lambda x: x.clone() if isinstance(x, torch.Tensor) else x, state)


def test_step_losses_match_jax(bound):
    (_, jl, jtot), (_, tl, ttot) = bound["jax"], bound["port"]
    assert set(jl) == set(tl) == {"l1", "ssim", "xyz", "scale", "total"}
    for k in jl:
        np.testing.assert_allclose(tl[k], jl[k], rtol=1e-5, err_msg=k)
    assert ttot == jtot > 0


@pytest.mark.parametrize("leaf", list(GaussianParams._fields))
def test_step_gauss_gradients_match_jax(bound, leaf):
    (jstate, _, _), (tstate, _, _) = bound["jax"], bound["port"]
    n = bound["n"]
    ref = jstate["mu"]["gauss"][leaf][:n] / (1.0 - optim.B1)
    got = getattr(tstate.mu["gauss"], leaf).numpy() / (1.0 - optim.B1)
    assert np.abs(ref).max() > 0
    assert _rel(got, ref) <= GRAD_REL, leaf


@pytest.mark.parametrize("leaf", ["expr", "rotation", "neck_pose",
                                  "jaw_pose", "eyes_pose", "translation"])
def test_step_flame_gradients_match_jax(bound, leaf):
    (jstate, _, _), (tstate, _, _) = bound["jax"], bound["port"]
    ref = jstate["mu"]["flame"][leaf] / (1.0 - optim.B1)
    got = tstate.mu["flame"][leaf].numpy() / (1.0 - optim.B1)
    assert np.abs(ref).max() > 0
    assert _rel(got, ref) <= GRAD_REL, leaf
    assert not np.any(got[[0, 2, 3]])        # only timestep 1 was driven


def test_step_updates_params_and_flame(bound):
    (jstate, _, _), (tstate, _, _) = bound["jax"], bound["port"]
    assert tstate.count == int(jstate["count"]) == 1
    for k in GaussianParams._fields:
        assert torch.isfinite(getattr(tstate.params, k)).all(), k
    for k, before in bound["flame_before"].items():
        after = tstate.flame_tr[k]
        assert not torch.equal(after[1], before[1]), k
        assert torch.equal(after[[0, 2, 3]], before[[0, 2, 3]]), k


def test_step_densification_stats_match_jax(bound):
    (jstate, _, _), (tstate, _, _) = bound["jax"], bound["port"]
    n = bound["n"]
    np.testing.assert_array_equal(tstate.denom.numpy(),
                                  jstate["denom"][:n])
    np.testing.assert_array_equal(tstate.max_radii2d.numpy(),
                                  jstate["max_radii2d"][:n])
    assert _rel(tstate.grad_accum.numpy(), jstate["grad_accum"][:n]) \
        <= GRAD_REL
    assert float(tstate.grad_accum.max()) > 0
    assert (tstate.grad_accum[tstate.denom == 0] == 0).all()


def test_three_step_losses_match_jax(bound):
    for jtotal, ttotal in bound["three_step_totals"]:
        np.testing.assert_allclose(ttotal, jtotal, rtol=1e-3)


def test_unbound_step_matches_jax():
    scene = make_scene(n=128, seed=4)
    jmodel = jax_scene_to_model(scene, sh_degree=2)
    jmodel.reset_stats()
    # copied first: the JAX step takes its state's buffers over
    tmodel = GaussianModel(2, GaussianParams(**{
        k: torch.from_numpy(np.array(getattr(jmodel.params, k)))
        for k in GaussianParams._fields}))
    tmodel.reset_stats()
    mu, nu, count = jax_optim.init({"gauss": jmodel.params, "flame": {}})
    jstate = JaxStepState(
        params=jmodel.params, flame_tr={}, mu=mu, nu=nu, count=count,
        max_radii2d=jmodel.max_radii2d,
        grad_accum=jmodel.xyz_gradient_accum, denom=jmodel.denom)
    jcam = make_camera(width=48, height=40)
    gt = np.random.default_rng(1).random((3, 40, 48)).astype(np.float32)
    bg = np.asarray([0.2, 0.5, 0.8], np.float32)
    opt = JaxOpt()
    jstep = jax_make_train_step(jmodel, opt, JAX_PIPE, 48, 40, 2, 1)
    jout, jl, _ = jstep(jstate, {}, None, jmodel.active_mask(),
                        jax_camera_arrays(jcam), jnp.asarray(gt),
                        jnp.asarray(bg), jnp.int32(0),
                        jax_lr_pytree(opt, 1e-3, {}, 1.0))

    tcam = CameraParams(**{k: torch.from_numpy(np.array(getattr(jcam, k)))
                           if k in ("viewmatrix", "projmatrix", "campos")
                           else getattr(jcam, k) for k in CameraParams._fields})
    tstep = make_train_step(tmodel, OptimizationConfig(), PipelineConfig(),
                            48, 40, 2, 1)
    tout, tl, total = tstep(initial_state(tmodel), {}, None,
                            camera_arrays(tcam), torch.from_numpy(gt),
                            torch.from_numpy(bg), 0,
                            lr_pytree(OptimizationConfig(), 1e-3, {}, 1.0))
    assert total > 0 and set(tl) == {"l1", "ssim", "total"}
    for k in jl:
        np.testing.assert_allclose(float(tl[k]), float(jl[k]), rtol=1e-5,
                                   err_msg=k)
    for k in GaussianParams._fields:
        got = getattr(tout.mu["gauss"], k).numpy()
        assert _rel(got, np.asarray(getattr(jout.mu["gauss"], k))) \
            <= GRAD_REL, k


def test_bench_entry_point_on_cpu():
    result = tbench_entry.main([
        "--device", "cpu", "--steps", "1", "--rounds", "1", "--width",
        str(W), "--height", str(H), "--n_per_face", "1"])
    assert result["metric"] == "bound_step_ms_64x48_10k"
    assert result["value"] > 0 and result["device"] == "cpu"


def test_train_entry_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError):
        tbench_entry.main(["--steps", "1", "--rounds", "1"])


def test_schedule_and_image_metrics_match_jax():
    from gaussianavatars_tpu.utils import image as jimage
    from gaussianavatars_tpu.utils.schedules import expon_lr as jax_expon_lr
    from gaussianavatars_torch.utils import image as timage
    from gaussianavatars_torch.utils.schedules import expon_lr

    steps = np.array([-1, 0, 1, 500, 30_000, 600_000, 700_000])
    for delay in (0, 1000):
        np.testing.assert_array_equal(
            expon_lr(steps, 0.005, 0.00005, delay, 0.01, 600_000),
            jax_expon_lr(steps, 0.005, 0.00005, delay, 0.01, 600_000))
    rng = np.random.default_rng(0)
    a, b = (rng.random((2, 3, 16, 12)).astype(np.float32) for _ in range(2))
    for name in ("l1_loss", "mse", "psnr"):
        np.testing.assert_allclose(
            getattr(timage, name)(torch.from_numpy(a),
                                  torch.from_numpy(b)).numpy(),
            np.asarray(getattr(jimage, name)(jnp.asarray(a), jnp.asarray(b))),
            rtol=1e-6, err_msg=name)


def test_flame_trainable_subset():
    model = tbench.make_bound_bench_model(sh_degree=1, n_per_face=1,
                                          device="cpu")
    tr = model.flame_trainable()
    assert sorted(tr) == sorted(["expr", "rotation", "neck_pose",
                                 "jaw_pose", "eyes_pose", "translation"])
    assert all(tr[k] is model.flame_param[k] for k in tr)
    new_expr = tr["expr"] + 1.0
    model.merge_flame_trainable({"expr": new_expr})
    assert model.flame_param["expr"] is new_expr
    model.not_finetune_flame_params = True
    assert model.flame_trainable() == {}
    assert initial_state(model).flame_tr == {}
