"""The port's FLAME regularizers and the parts of the FLAME head they need
against the JAX package, on the synthetic FLAME assets of
tests/flame_fixtures.py: the region masks (`FlameMask`, exactly), the mesh
laplacian and the landmarks (atol 1e-6 on the same vertices), the two
regularizer losses (rtol 1e-5), a train step with all three regularizer
weights non-zero (losses rtol 1e-5, gradients per leaf max|d| / max|ref|
<= 2e-4, the ROADMAP gradient tolerance) and `load_ply` with a motion file
and disabled faces (exactly)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianavatars_tpu.benchmark import (
    make_bound_bench_model as jax_bound_model,
)
from gaussianavatars_tpu.config import OptimizationConfig as JaxOpt
from gaussianavatars_tpu.config import PipelineConfig as JaxPipeline
from gaussianavatars_tpu.models import flame_gaussians as jfg
from gaussianavatars_tpu.models.flame import FlameHead as JFlameHead
from gaussianavatars_tpu.ops import lbs as jlbs
from gaussianavatars_tpu.train import optim as jax_optim
from gaussianavatars_tpu.train.loop import (
    StepState as JaxStepState,
    binding_arg,
    camera_arrays as jax_camera_arrays,
    lr_pytree as jax_lr_pytree,
    make_train_step as jax_make_train_step,
)
from gaussianavatars_torch import benchmark as tbench
from gaussianavatars_torch.config import OptimizationConfig, PipelineConfig
from gaussianavatars_torch.convert import from_jax_arrays
from gaussianavatars_torch.models import flame_gaussians as tfg
from gaussianavatars_torch.models.flame import FlameHead as TFlameHead
from gaussianavatars_torch.models.gaussians import GaussianParams
from gaussianavatars_torch.ops import lbs as tlbs
from gaussianavatars_torch.train import optim
from gaussianavatars_torch.train.loop import (
    camera_arrays,
    initial_state,
    lr_pytree,
    make_train_step,
)

from .flame_fixtures import make_flame_assets
from .utils import make_camera
from .test_torch_blend import one_torch_thread  # noqa: F401

W, H = 64, 48
GRAD_REL = 2e-4
REG = dict(lambda_dynamic_offset=0.5, lambda_dynamic_offset_std=2.0,
           lambda_laplacian=300.0)


@pytest.fixture(scope="module")
def heads(tmp_path_factory):
    """The JAX and the port's head with teeth, masks and landmarks."""
    paths = make_flame_assets(str(tmp_path_factory.mktemp("flame")), seed=0)
    jhead = JFlameHead(300, 100, flame_model_path=paths["model"],
                       flame_lmk_embedding_path=paths["lmk"],
                       flame_template_mesh_path=paths["obj"],
                       flame_parts_path="/nonexistent")
    thead = TFlameHead(300, 100, flame_model_path=paths["model"],
                       flame_template_mesh_path=paths["obj"],
                       flame_lmk_embedding_path=paths["lmk"],
                       flame_parts_path="/nonexistent", device="cpu")
    return jhead, thead


def test_flame_mask_matches_jax(heads):
    jhead, thead = heads
    jm, tm = jhead.mask, thead.mask
    assert "teeth" in tm.v and "left_half" in tm.v
    for table in ("v", "f", "vt"):
        ref, got = getattr(jm, table), getattr(tm, table)
        assert sorted(got) == sorted(ref), table
        for name in ref:
            np.testing.assert_array_equal(got[name], ref[name],
                                          err_msg=f"{table}[{name}]")
    np.testing.assert_array_equal(tm.fid2cid, jm.fid2cid)
    assert (tm.num_verts, tm.num_faces) == (jm.num_verts, jm.num_faces)
    regions = ["teeth", "lips_tight", "left_half"]
    for query in ("get_vid_by_region", "get_vid_except_region",
                  "get_fid_by_region", "get_fid_except_region"):
        np.testing.assert_array_equal(getattr(tm, query)(regions),
                                      getattr(jm, query)(regions),
                                      err_msg=query)


def test_laplacian_and_landmarks_match_jax(heads):
    jhead, thead = heads
    np.testing.assert_array_equal(thead.laplacian_edges.numpy(),
                                  np.asarray(jhead.laplacian_edges))
    np.testing.assert_array_equal(thead.laplacian_degree.numpy(),
                                  np.asarray(jhead.laplacian_degree))
    rng = np.random.default_rng(3)
    verts = rng.normal(0, 0.1, (2, thead.num_verts, 3)).astype(np.float32)
    np.testing.assert_allclose(
        thead.laplacian_smooth(torch.from_numpy(verts)).numpy(),
        np.asarray(jhead.laplacian_smooth(jnp.asarray(verts))), atol=1e-6,
        rtol=0)
    np.testing.assert_allclose(
        tlbs.vertices2landmarks(
            torch.from_numpy(verts), thead.faces, thead.full_lmk_faces_idx,
            thead.full_lmk_bary_coords).numpy(),
        np.asarray(jlbs.vertices2landmarks(
            jnp.asarray(verts), jhead.j_faces,
            jnp.asarray(jhead.full_lmk_faces_idx),
            jnp.asarray(jhead.full_lmk_bary_coords))), atol=1e-6, rtol=0)


def test_forward_returns_in_jax_order(heads):
    jhead, thead = heads
    rng = np.random.default_rng(4)
    args = [rng.normal(0, s, (1, n)).astype(np.float32) for s, n in (
        (0.5, 300), (0.5, 100), (0.2, 3), (0.2, 3), (0.1, 3), (0.1, 6),
        (0.05, 3))]
    off = rng.normal(0, 1e-3, (1, thead.num_verts, 3)).astype(np.float32)
    for centred in (False, True):
        ref = jhead.forward(*map(jnp.asarray, args),
                            zero_centered_at_root_node=centred,
                            return_verts_cano=True,
                            dynamic_offset=jnp.asarray(off))
        got = thead(*map(torch.from_numpy, args),
                    zero_centered_at_root_node=centred,
                    return_verts_cano=True,
                    dynamic_offset=torch.from_numpy(off))
        assert len(got) == len(ref) == 3
        assert got[2].shape == (1, 70, 3)
        for g, r, what in zip(got, ref, ("verts", "verts_cano", "lmks")):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5,
                                       rtol=1e-5, err_msg=what)
    only = thead(*map(torch.from_numpy, args), return_landmarks=False)
    assert isinstance(only, torch.Tensor)


def test_regularizer_losses_match_jax(heads):
    """Values and the gradient: only the dynamic offset carries one, the
    canonical vertices none (the JAX stop_gradient)."""
    jhead, thead = heads
    jm = jfg.FlameGaussianModel(0, flame_head=jhead)
    tm = tfg.FlameGaussianModel(0, thead)
    rng = np.random.default_rng(5)
    off = rng.normal(0, 1e-3, (3, thead.num_verts, 3)).astype(np.float32)
    cano = rng.normal(0, 0.1, (1, thead.num_verts, 3)).astype(np.float32)

    def jax_losses(o, c):
        p = {"dynamic_offset": o}
        return (jm.compute_dynamic_offset_loss(p, 1),
                jm.compute_laplacian_loss(p, 1, c))

    ref = jax_losses(jnp.asarray(off), jnp.asarray(cano))
    ref_g = jax.grad(lambda o, c: jax_losses(o, c)[1], argnums=(0, 1))(
        jnp.asarray(off), jnp.asarray(cano))
    t_off = torch.from_numpy(off).requires_grad_()
    t_cano = torch.from_numpy(cano).requires_grad_()
    p = {"dynamic_offset": t_off}
    got = (tm.compute_dynamic_offset_loss(p, 1),
           tm.compute_laplacian_loss(p, 1, t_cano))
    for g, r, what in zip([x.detach() for x in got], ref, ("dy_off", "lap")):
        assert float(r) > 0
        np.testing.assert_allclose(g.item(), float(r), rtol=1e-5,
                                   err_msg=what)
    g_off, g_cano = torch.autograd.grad(got[1], [t_off, t_cano],
                                        allow_unused=True)
    assert g_cano is None and not np.any(np.asarray(ref_g[1]))
    np.testing.assert_allclose(g_off.numpy(), np.asarray(ref_g[0]),
                               atol=1e-6 * np.abs(ref_g[0]).max(), rtol=1e-4)


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return {k: _np_tree(getattr(tree, k)) for k in tree._fields}
    return np.array(tree)


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


@pytest.fixture(scope="module")
def regularized(tmp_path_factory):
    """One JAX step and one port step of the bound bench avatar (1
    Gaussian per face, SH 3, 64x48) with all three regularizers on and a
    random dynamic offset."""
    jmodel = jax_bound_model(sh_degree=3, n_per_face=1, seed=0,
                             num_timesteps=4)
    rng = np.random.default_rng(6)
    off = rng.normal(0, 1e-3, np.shape(jmodel.flame_param["dynamic_offset"]))
    jmodel.flame_param["dynamic_offset"] = jnp.asarray(off, jnp.float32)
    paths = make_flame_assets(str(tmp_path_factory.mktemp("flame")), seed=0)
    flame_tr = jmodel.flame_trainable()
    mu, nu, count = jax_optim.init({"gauss": jmodel.params,
                                    "flame": flame_tr})
    tmodel = from_jax_arrays(
        _np_tree(jmodel.params), jmodel.binding,
        _np_tree(dict(jmodel.flame_param)), sh_degree=3,
        n_alive=jmodel.n_alive, flame_model_path=paths["model"],
        flame_template_mesh_path=paths["obj"],
        opt_state=(_np_tree(mu), _np_tree(nu), int(count)),
        spatial_lr_scale=1.0, device="cpu")
    gt = np.random.default_rng(2).random((3, H, W)).astype(np.float32)
    bg = np.ones(3, np.float32)

    opt = JaxOpt(**REG)
    jstate = JaxStepState(
        params=jmodel.params, flame_tr=flame_tr, mu=mu, nu=nu, count=count,
        max_radii2d=jmodel.max_radii2d,
        grad_accum=jmodel.xyz_gradient_accum, denom=jmodel.denom)
    jstep = jax_make_train_step(
        jmodel, opt, JaxPipeline(backend="jnp", capacity=1 << 16, chunk=16,
                                 tile_size=32, binning="dense"), W, H, 3, 4)
    jfixed = {k: v for k, v in jmodel.flame_param.items()
              if k not in flame_tr}
    js, jl, _ = jstep(jstate, jfixed, binding_arg(jmodel),
                      jmodel.active_mask(),
                      jax_camera_arrays(make_camera(width=W, height=H,
                                                    fovx=0.5, dist=1.0)),
                      jnp.asarray(gt), jnp.asarray(bg), jnp.int32(1),
                      jax_lr_pytree(opt, 1e-3, flame_tr, 1.0))

    topt = OptimizationConfig(**REG)
    tstate = initial_state(tmodel)
    tstep = make_train_step(tmodel, topt, PipelineConfig(), W, H, 3,
                            tmodel.num_timesteps)
    tfixed = {k: v for k, v in tmodel.flame_param.items()
              if k not in tstate.flame_tr}
    ts, tl, _ = tstep(tstate, tfixed, tmodel.binding,
                      camera_arrays(tbench.bench_camera(W, H, device="cpu")),
                      torch.from_numpy(gt), torch.from_numpy(bg), 1,
                      lr_pytree(topt, 1e-3, tstate.flame_tr, 1.0))
    return dict(jax=(_np_tree(js), {k: float(v) for k, v in jl.items()}),
                port=(ts, {k: float(v) for k, v in tl.items()}),
                n=jmodel.n_alive)


def test_regularized_step_losses_match_jax(regularized):
    (_, jl), (_, tl) = regularized["jax"], regularized["port"]
    # the JAX step returns its dict through jit, which sorts the keys
    assert list(tl) == ["l1", "ssim", "xyz", "scale", "dy_off",
                        "dynamic_offset_std", "lap", "total"]
    assert set(jl) == set(tl)
    for k in ("dy_off", "dynamic_offset_std", "lap"):
        assert jl[k] > 1e-4 * jl["total"], k
    for k in jl:
        np.testing.assert_allclose(tl[k], jl[k], rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("tree,leaf", [
    *[("gauss", k) for k in GaussianParams._fields],
    *[("flame", k) for k in ("expr", "rotation", "neck_pose", "jaw_pose",
                             "eyes_pose", "translation")]])
def test_regularized_step_gradients_match_jax(regularized, tree, leaf):
    (jstate, _), (tstate, _) = regularized["jax"], regularized["port"]
    ref = jstate["mu"][tree][leaf] / (1.0 - optim.B1)
    got = tstate.mu[tree]
    got = (getattr(got, leaf) if tree == "gauss" else got[leaf]).numpy()
    if tree == "gauss":
        ref = ref[:regularized["n"]]
    got = got / (1.0 - optim.B1)
    assert np.abs(ref).max() > 0
    assert _rel(got, ref) <= GRAD_REL, leaf


def test_load_ply_motion_and_disabled_faces_match_jax(heads, tmp_path):
    jhead, thead = heads
    jmodel = jax_bound_model(sh_degree=1, n_per_face=2, seed=0,
                             num_timesteps=3)
    ply = str(tmp_path / "point_cloud.ply")
    jmodel.save_ply(ply)
    rng = np.random.default_rng(7)
    t, v = 5, thead.num_verts
    motion = str(tmp_path / "motion.npz")
    np.savez(motion, **{k: rng.normal(0, 0.05, s).astype(np.float32)
                        for k, s in (("translation", (t, 3)),
                                     ("rotation", (t, 3)),
                                     ("neck_pose", (t, 3)),
                                     ("jaw_pose", (t, 3)),
                                     ("eyes_pose", (t, 6)),
                                     ("expr", (t, 100)),
                                     ("dynamic_offset", (t, v, 3)))},
             timestep=np.arange(t), shape=np.zeros(300))
    disable = np.array([0, 5, 17, 9000, thead.num_faces - 1])

    jm = jfg.FlameGaussianModel(1, flame_head=jhead)
    jm.load_ply(ply, motion_path=motion, disable_fid=disable)
    tm = tfg.FlameGaussianModel(1, thead)
    tm.load_ply(ply, motion_path=motion, disable_fid=disable)

    n = jm.n_alive
    assert tm.num_gaussians == n == 2 * (thead.num_faces - len(disable))
    for k in GaussianParams._fields:
        np.testing.assert_array_equal(getattr(tm.params, k).numpy(),
                                      np.asarray(getattr(jm.params, k))[:n],
                                      err_msg=k)
    np.testing.assert_array_equal(tm.binding.numpy(), jm.binding[:n])
    assert not np.isin(tm.binding.numpy(), disable).any()
    assert torch.equal(tm.binding_counter, torch.bincount(
        tm.binding, minlength=thead.num_faces))
    assert tm.num_timesteps == jm.num_timesteps == t
    assert sorted(tm.flame_param) == sorted(jm.flame_param)
    for k, ref in jm.flame_param.items():
        got = tm.flame_param[k]
        assert got.dtype == torch.float32, k
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref),
                                      err_msg=k)
