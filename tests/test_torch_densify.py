"""The port's densification engine and model set-up against the JAX
package's, on the same inputs made with numpy.

  * `densify_and_prune` (bound and unbound; no screen-size prune, the
    "reference" one and the "effective" one) on inputs that clone, split,
    prune by opacity and by world size, and where a face would lose its
    last Gaussians: equal counts, binding and face counters; parameters and
    Adam moments within atol 1e-6 (the split samples go through a rotation
    matrix and an einsum whose float32 sums may round in another order);
  * `reset_opacity`: atol 1e-7;
  * `create_from_pcd`, bound (exact) and unbound (atol 1e-6), and
    `mean_sq_dist_to_3nn` on 2000 random points, rtol 1e-5, against the
    JAX function run op by op (`jax.disable_jit`): jitted, XLA reassociates
    the |a|^2 + |b|^2 - 2 a.b sums, whose float32 cancellation alone moves
    the result by up to ~2e-4 relative (held here at 1e-3);
  * 25 iterations of `training` with densification at 10 and 20 in both
    packages on the same dataset: the port ends with a sorted binding, a
    face counter equal to the binding's counts, no empty face, and a
    Gaussian count within 2% of the JAX package's.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianavatars_tpu.config import ModelConfig as JaxModelConfig
from gaussianavatars_tpu.config import OptimizationConfig as JaxOpt
from gaussianavatars_tpu.config import PipelineConfig as JaxPipeline
from gaussianavatars_tpu.models.gaussians import AdamState as JaxAdam
from gaussianavatars_tpu.models.gaussians import GaussianModel as JaxModel
from gaussianavatars_tpu.models.gaussians import GaussianParams as JaxParams
from gaussianavatars_tpu.ops.knn import mean_sq_dist_to_3nn as jax_knn
from gaussianavatars_tpu.train.loop import training as jax_training
from gaussianavatars_torch.config import (
    ModelConfig,
    OptimizationConfig,
    PipelineConfig,
)
from gaussianavatars_torch.models.gaussians import (
    AdamState,
    GaussianModel,
    GaussianParams,
)
from gaussianavatars_torch.ops.knn import mean_sq_dist_to_3nn
from gaussianavatars_torch.train.loop import training

from .test_torch_blend import one_torch_thread  # noqa: F401
from .torch_fixtures import make_port_avatar_dataset

N, F, SH = 64, 12, 1
FIELDS = GaussianParams._fields


def _inputs(seed=0):
    """Gaussians with small and large scales, high and low screen
    gradients and opacities; face 0 holds one transparent Gaussian and
    face 1 two, all of which the opacity prune would take."""
    rng = np.random.default_rng(seed)
    binding = np.concatenate([np.arange(F), rng.integers(2, F, N - F)])
    opacity = rng.normal(0.0, 1.5, (N, 1))
    opacity[binding < 2] = -7.0                  # below logit(0.005)
    opacity[rng.random(N) < 0.15] = -8.0
    params = dict(
        xyz=rng.normal(0, 0.5, (N, 3)),
        features_dc=rng.normal(0, 0.5, (N, 3)),
        features_rest=rng.normal(0, 0.1, (N, 3 * ((SH + 1) ** 2 - 1))),
        scaling=np.where(rng.random((N, 1)) < 0.5, -6.0, -2.0)
        + rng.normal(0, 0.2, (N, 3)),
        rotation=rng.normal(size=(N, 4)),
        opacity=opacity,
    )
    params = {k: v.astype(np.float32) for k, v in params.items()}
    moments = [{k: rng.normal(0, 1e-3, v.shape).astype(np.float32)
                for k, v in params.items()} for _ in range(2)]
    denom = rng.integers(0, 5, N).astype(np.float32)
    accum = (rng.random(N) * 1e-3 * denom).astype(np.float32)
    stats = dict(max_radii2d=rng.integers(0, 40, N).astype(np.float32),
                 xyz_gradient_accum=accum, denom=denom)
    face_scaling = rng.uniform(0.5, 2.0, (F, 1)).astype(np.float32)
    return params, moments, stats, binding, face_scaling


def _jax_model(params, stats, binding):
    jm = JaxModel(SH, capacity_granularity=128)
    if binding is not None:
        jm.binding = binding.astype(np.int32)
        jm.binding_counter = np.bincount(binding, minlength=F).astype(
            np.int32)
    jm._install(params, N)
    cap = jm.capacity
    for k in ("max_radii2d", "xyz_gradient_accum", "denom"):
        setattr(jm, k, jnp.asarray(np.pad(stats[k], (0, cap - N))))
    return jm


def _jax_adam(moments, cap, count=7):
    def pad(a):
        return jnp.asarray(np.pad(a, ((0, cap - N), (0, 0))))

    mu, nu = ({k: pad(v) for k, v in m.items()} for m in moments)
    return JaxAdam(mu=JaxParams(**mu), nu=JaxParams(**nu),
                   count=jnp.asarray(count))


def _port_model(params, stats, binding):
    tm = GaussianModel(SH, GaussianParams(**{
        k: torch.from_numpy(params[k].copy()) for k in FIELDS}),
        device="cpu")
    if binding is not None:
        tm.binding = torch.from_numpy(binding.astype(np.int64))
        tm.binding_counter = torch.bincount(tm.binding, minlength=F)
    for k, v in stats.items():
        setattr(tm, k, torch.from_numpy(v.copy()))
    return tm


def _port_adam(moments, count=7):
    mu, nu = (GaussianParams(**{k: torch.from_numpy(m[k].copy())
                                for k in FIELDS}) for m in moments)
    return AdamState(mu=mu, nu=nu, count=count)


@pytest.mark.parametrize("bound", [True, False])
@pytest.mark.parametrize("screen", [None, "reference", "effective"])
def test_densify_and_prune_matches_jax(bound, screen):
    params, moments, stats, binding, face_scaling = _inputs()
    binding = binding if bound else None
    max_screen = None if screen is None else 20
    mode = screen or "reference"
    jm = _jax_model(params, stats, binding)
    jout = jm.densify_and_prune(
        _jax_adam(moments, jm.capacity), 2e-4, 0.005, 1.0, max_screen, 0.01,
        face_scaling if bound else None, seed=123, screen_size_prune=mode)
    tm = _port_model(params, stats, binding)
    tout = tm.densify_and_prune(
        _port_adam(moments), 2e-4, 0.005, 1.0, max_screen, 0.01,
        torch.from_numpy(face_scaling) if bound else None, seed=123,
        screen_size_prune=mode)

    n = jm.n_alive
    assert tm.num_gaussians == n != N
    assert tout.count == int(jout.count) == 7
    for k in FIELDS:
        for name, got, ref in (("param", tm.params, jm.params),
                               ("mu", tout.mu, jout.mu),
                               ("nu", tout.nu, jout.nu)):
            np.testing.assert_allclose(
                getattr(got, k).numpy(), np.asarray(getattr(ref, k))[:n],
                atol=1e-6, rtol=0, err_msg=f"{name} {k}")
    for k in ("max_radii2d", "xyz_gradient_accum", "denom"):
        assert not getattr(tm, k).any() and getattr(tm, k).shape == (n,)
    if bound:
        np.testing.assert_array_equal(tm.binding.numpy(), jm.binding[:n])
        np.testing.assert_array_equal(tm.binding_counter.numpy(),
                                      jm.binding_counter)
        counts = torch.bincount(tm.binding, minlength=F)
        assert torch.equal(counts, tm.binding_counter)
        assert (counts > 0).all()                  # faces 0 and 1 kept
        assert (tm.binding[1:] >= tm.binding[:-1]).all()
        # the transparent Gaussians of faces 0 and 1 survived the prune
        assert counts[0] >= 1 and counts[1] >= 2


def test_inputs_reach_every_branch():
    """The parity inputs clone (high gradient, small), split (high
    gradient, large) and prune by opacity, and faces 0 and 1 hold only
    Gaussians the opacity prune would take."""
    params, _, stats, binding, face_scaling = _inputs()
    grads = stats["xyz_gradient_accum"] / np.maximum(stats["denom"], 1e-12)
    large = (np.exp(params["scaling"]) * face_scaling[binding]).max(1) > 0.01
    high = grads >= 2e-4
    assert (high & ~large).any() and (high & large).any()
    transparent = params["opacity"][:, 0] < np.log(0.005 / 0.995)
    assert (transparent & (binding >= 2)).any()
    assert transparent[binding < 2].all()


def test_reset_opacity_matches_jax():
    params, moments, stats, binding, _ = _inputs(seed=3)
    jm = _jax_model(params, stats, binding)
    jout = jm.reset_opacity(_jax_adam(moments, jm.capacity))
    tm = _port_model(params, stats, binding)
    tout = tm.reset_opacity(_port_adam(moments))
    np.testing.assert_allclose(tm.params.opacity.numpy(),
                               np.asarray(jm.params.opacity)[:N],
                               atol=1e-7, rtol=0)
    assert float(torch.sigmoid(tm.params.opacity).max()) <= 0.01 + 1e-7
    assert not tout.mu.opacity.any() and not tout.nu.opacity.any()
    assert not np.asarray(jout.mu.opacity).any()
    assert torch.equal(tout.mu.xyz, torch.from_numpy(moments[0]["xyz"]))


def test_create_from_pcd_bound_matches_jax():
    jm = JaxModel(SH)
    jm.binding = np.arange(F, dtype=np.int32)
    jm.create_from_pcd(None, None, 2.5, seed=0)
    tm = GaussianModel(SH, device="cpu")
    tm.binding = torch.arange(F)
    tm.create_from_pcd(None, None, 2.5, seed=0)
    assert tm.active_sh_degree == jm.active_sh_degree == 0
    assert tm.spatial_lr_scale == 2.5 and tm.num_gaussians == F
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(tm.params, k).numpy(),
                                      np.asarray(getattr(jm.params, k))[:F],
                                      err_msg=k)


def test_create_from_pcd_unbound_matches_jax():
    rng = np.random.default_rng(5)
    points = rng.normal(size=(300, 3)).astype(np.float32)
    colors = rng.random((300, 3)).astype(np.float32)
    jm = JaxModel(SH)
    with jax.disable_jit():
        jm.create_from_pcd(points, colors, 1.0)
    tm = GaussianModel(SH, device="cpu")
    tm.create_from_pcd(points, colors, 1.0)
    for k in FIELDS:
        np.testing.assert_allclose(getattr(tm.params, k).numpy(),
                                   np.asarray(getattr(jm.params, k))[:300],
                                   atol=1e-6, rtol=0, err_msg=k)


def test_knn_matches_jax():
    points = np.random.default_rng(0).random((2000, 3)).astype(np.float32)
    got = mean_sq_dist_to_3nn(torch.from_numpy(points)).numpy()
    with jax.disable_jit():
        ref = np.asarray(jax_knn(jnp.asarray(points)))
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    np.testing.assert_allclose(got, np.asarray(jax_knn(jnp.asarray(points))),
                               rtol=1e-3)
    tiny = mean_sq_dist_to_3nn(torch.tensor([[0.0, 0, 0], [1, 0, 0],
                                             [0, 2, 0]]))
    np.testing.assert_allclose(tiny.numpy(), [2.5, 3.0, 4.5])


@pytest.fixture(scope="module")
def avatar_data(tmp_path_factory):
    return make_port_avatar_dataset(tmp_path_factory.mktemp("avatar"))


def test_training_densifies_like_jax(avatar_data, tmp_path, monkeypatch):
    data, assets = avatar_data
    monkeypatch.setenv("FLAME_ASSET_DIR", assets)
    common = dict(source_path=data, bind_to_mesh=True, eval=True,
                  sh_degree=1)
    sched = dict(iterations=25, densify_from_iter=5,
                 densification_interval=10, densify_until_iter=22,
                 densify_grad_threshold=2e-5, opacity_reset_interval=1000,
                 position_lr_max_steps=25)
    jmodel, _, jinfo = jax_training(
        JaxModelConfig(model_path=str(tmp_path / "jax"), **common),
        JaxOpt(**sched),
        JaxPipeline(backend="jnp", capacity=1 << 18, chunk=16, tile_size=16))
    model, state, info = training(
        ModelConfig(model_path=str(tmp_path / "port"), **common),
        OptimizationConfig(**sched), PipelineConfig(tile_size=16),
        device="cpu")

    faces = model.flame_model.num_faces
    assert info["summary"]["densify"] == 2 == len(info["densify_s"])
    assert jinfo["summary"]["events"]["densify"] == 2
    n = model.num_gaussians
    assert n > faces
    assert abs(n - jmodel.n_alive) <= 0.02 * jmodel.n_alive, \
        (n, jmodel.n_alive)
    counts = torch.bincount(model.binding, minlength=faces)
    assert torch.equal(counts, model.binding_counter)
    assert (counts > 0).all()
    assert (model.binding[1:] >= model.binding[:-1]).all()
    assert state.params.xyz.shape[0] == n == state.mu["gauss"].xyz.shape[0]
    assert state.count == 25
    assert os.path.exists(os.path.join(str(tmp_path / "port"),
                                       "run_summary.json"))
