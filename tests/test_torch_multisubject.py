"""The port's multi-subject training against the JAX package's.

The subjects: the bound bench avatar and a copy with every parameter and
FLAME trainable x 0.9, as JAX `tests/test_stretch_configs.py` makes them.

  * `MultiSubjectTrainer` with both subjects taking turns on one process
    across a densification equals the port's solo runs of each subject at
    atol 1e-6 with the same Gaussian counts (the JAX test's criterion), and
    its first iteration equals JAX's trainer on a (2, 1) mesh (its state
    read back by `convert.from_jax_multisubject`);
  * `python -m gaussianavatars_torch.bench_multisubject` on the CPU.

`test_torch_multisubject_step.py` holds the multi-subject step.
"""

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
from gaussianavatars_tpu.models.gaussians import GaussianParams as JaxParams
from gaussianavatars_tpu.parallel.mesh import make_mesh as jax_make_mesh
from gaussianavatars_tpu.train.multisubject import (
    MultiSubjectTrainer as JaxTrainer,
)
from gaussianavatars_torch import bench_multisubject
from gaussianavatars_torch.config import OptimizationConfig, PipelineConfig
from gaussianavatars_torch.convert import from_jax_multisubject
from gaussianavatars_torch.parallel import make_mesh
from gaussianavatars_torch.train.multisubject import MultiSubjectTrainer

from . import torch_ranks
from .flame_fixtures import make_flame_assets
from .test_torch_blend import one_torch_thread  # noqa: F401
from .test_torch_parallel import W, H, _cam_arrays, _jax_cam_tuple
from .utils import make_camera

SCALES = (1.0, 0.9)


def _subject(jmodel, scale):
    """A JAX subject: the model's parameters and FLAME trainables x
    scale."""
    params = jax.tree.map(lambda x: x * scale, jmodel.params)
    flame_tr = {k: v * scale for k, v in jmodel.flame_trainable().items()}
    return params, flame_tr


@pytest.fixture(scope="module")
def subjects(tmp_path_factory):
    """Both subjects written for the ranks (model0.npz, model1.npz), one
    view each at 64x48."""
    root = tmp_path_factory.mktemp("subjects")
    jmodel = jax_bound_model(sh_degree=3, n_per_face=1, seed=0,
                             num_timesteps=4)
    paths = make_flame_assets(str(root / "flame"), seed=0)
    pairs = [_subject(jmodel, s) for s in SCALES]
    for i, (params, flame_tr) in enumerate(pairs):
        torch_ranks.save_model(
            root / f"model{i}.npz",
            {k: np.asarray(getattr(params, k)) for k in JaxParams._fields},
            np.asarray(jmodel.binding_device()),
            {k: np.asarray(v) for k, v in
             {**jmodel.flame_param, **flame_tr}.items()}, 3, paths,
            jmodel.n_alive)
    cams = [make_camera(width=W, height=H, fovx=0.5, dist=1.0, angle=a)
            for a in (0.0, 0.25)]
    rng = np.random.default_rng(5)
    views = dict(gts=rng.random((2, 3, H, W)).astype(np.float32),
                 bgs=np.ones((2, 3), np.float32),
                 timesteps=np.asarray([0, 1], np.int32))
    for i, cam in enumerate(cams):
        views.update(_cam_arrays(cam, f"c{i}_"))
    np.savez(root / "views.npz", **views)
    return dict(root=root, jmodel=jmodel, pairs=pairs, cams=cams,
                views=views, paths=paths)


def _port_subjects(root, every=1):
    """Both subjects as port models; with `every`, only every such
    Gaussian of each (a smaller avatar, quicker on the CPU)."""
    models = [torch_ranks._carried_model(root / f"model{i}.npz")
              for i in range(2)]
    for m in models:
        m.params = type(m.params)(*[p[::every].clone() for p in m.params])
        m.binding = m.binding[::every].clone()
        m.binding_counter = torch.bincount(
            m.binding, minlength=m.binding_counter.shape[0])
        m.reset_stats()
    return models


def _batch(views):
    def batch_fn(subject, iteration):
        cam = torch_ranks._camera(views, f"c{subject}_")
        return (cam, torch.from_numpy(views["gts"][subject]),
                torch.from_numpy(views["bgs"][subject]),
                int(views["timesteps"][subject]) + iteration % 2)
    return batch_fn


DENSIFY = dict(densify_from_iter=1, densification_interval=2,
               densify_until_iter=100, densify_grad_threshold=1e-12,
               opacity_reset_interval=10_000, percent_dense=0.01)


def test_trainer_matches_solo_runs(subjects):
    """Both subjects (every 8th Gaussian) in turn on the local mesh, across
    the densification at iteration 2, against a trainer of each subject
    alone."""
    root, views = subjects["root"], subjects["views"]
    opt = OptimizationConfig(**DENSIFY)
    mesh = make_mesh(1, 1)
    batched = MultiSubjectTrainer(_port_subjects(root, 8), mesh, opt,
                                  PipelineConfig(), W, H, [1.0, 1.0])
    losses = batched.train(_batch(views), 1, 3)
    assert all(np.isfinite(float(v)) for v in losses.values())
    for i in range(2):
        solo_model = _port_subjects(root, 8)[i]
        solo = MultiSubjectTrainer([solo_model], mesh, opt, PipelineConfig(),
                                   W, H, [1.0])
        fn = _batch(views)
        solo.train(lambda _, it, i=i: fn(i, it), 1, 3)
        mb = batched.models[i]
        assert mb.num_gaussians == solo_model.num_gaussians > 10144 // 8 + 1
        for k in ("xyz", "opacity", "scaling"):
            np.testing.assert_allclose(
                getattr(mb.params, k).numpy(),
                getattr(solo_model.params, k).numpy(), atol=1e-6)
        for k, v in mb.flame_param.items():
            np.testing.assert_allclose(v.numpy(),
                                       solo_model.flame_param[k].numpy(),
                                       atol=1e-6, err_msg=k)


def test_trainer_first_iteration_matches_jax(subjects):
    """One iteration of both trainers; the JAX trainer's stacked state back
    as port models, held at the updated-parameter criterion of
    `check_step_against_jax` and its losses at rtol 1e-5."""
    root, views, jmodel = (subjects["root"], subjects["views"],
                           subjects["jmodel"])
    jmodels = []
    for params, flame_tr in subjects["pairs"]:
        m = jax_bound_model(sh_degree=3, n_per_face=1, seed=0,
                            num_timesteps=4)
        m.params = jax.tree.map(jnp.array, params)
        m.merge_flame_trainable(dict(flame_tr))
        jmodels.append(m)
    pipe = JaxPipeline(backend="jnp", capacity=1 << 16, chunk=16,
                       tile_size=32, binning="dense")
    jtrainer = JaxTrainer(jmodels, jax_make_mesh(n_data=2, n_prim=1),
                          JaxOpt(), pipe, W, H, extents=[1.0, 1.0])

    def jax_batch(subject, iteration):
        return (_jax_cam_tuple(subjects["cams"][subject]),
                views["gts"][subject], views["bgs"][subject],
                int(views["timesteps"][subject]) + iteration % 2)

    jlosses = jtrainer.train(jax_batch, 1, 1, densify=False)
    back = from_jax_multisubject(
        {k: np.asarray(getattr(jtrainer.params_s, k))
         for k in JaxParams._fields},
        np.asarray(jtrainer.binding_s), np.asarray(jtrainer.active_s),
        {k: np.asarray(v) for k, v in {
            **{k: jnp.stack([v] * 2) for k, v in
               jtrainer.flame_fixeds[0].items()},
            **jtrainer.flame_tr_s}.items()},
        sh_degree=3, flame_model_path=subjects["paths"]["model"],
        flame_template_mesh_path=subjects["paths"]["obj"], device="cpu")

    port = MultiSubjectTrainer(_port_subjects(root), make_mesh(1, 1),
                               OptimizationConfig(), PipelineConfig(), W, H,
                               [1.0, 1.0])
    before = [{k: getattr(m.params, k).clone() for k in JaxParams._fields}
              for m in port.models]
    losses = port.train(_batch(views), 1, 1, densify=False)
    for k, v in jlosses.items():
        np.testing.assert_allclose(float(losses[k]), float(v), rtol=1e-5,
                                   err_msg=k)
    lrs = {"xyz": float(port_xyz_lr()), "features_dc": 0.0025,
           "features_rest": 0.0025 / 20, "scaling": 0.017,
           "rotation": 0.001, "opacity": 0.05}
    for i, (mp, mj) in enumerate(zip(port.models, back)):
        assert mp.num_gaussians == mj.num_gaussians == jmodel.n_alive
        for k in JaxParams._fields:
            old = before[i][k].numpy()
            a = getattr(mj.params, k).numpy() - old
            b = getattr(mp.params, k).numpy() - old
            diff = np.abs(a - b)
            assert (diff <= 0.05 * lrs[k]).mean() > 0.995, (i, k)
            assert diff.max() <= 2.1 * lrs[k], (i, k)
        for k in jtrainer.flame_tr_s:
            np.testing.assert_allclose(mp.flame_param[k].numpy(),
                                       mj.flame_param[k].numpy(),
                                       atol=0.05 * 1e-3, err_msg=k)


def port_xyz_lr():
    from gaussianavatars_torch.utils.schedules import expon_lr

    opt = OptimizationConfig()
    return expon_lr(1, opt.position_lr_init, opt.position_lr_final,
                    opt.position_lr_delay_mult, opt.position_lr_max_steps)


def test_bench_multisubject_on_cpu(capsys):
    result = bench_multisubject.main([
        "--device", "cpu", "--subjects", "2", "--iters", "1", "--rounds",
        "1", "--width", "64", "--height", "48", "--n_per_face", "1"])
    assert result["subjects"] == 2 and result["device"] == "cpu"
    assert result["solo_steps_per_s"] > 0
    assert result["total_steps_per_s"] > 0
    assert result["efficiency"] == pytest.approx(
        result["total_steps_per_s"] / result["solo_steps_per_s"])
    assert "interleave efficiency" in capsys.readouterr().out
