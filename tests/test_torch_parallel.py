"""The port's `parallel/*` over gloo CPU ranks against the JAX package's
shard_map versions on the virtual CPU mesh.

The ranks are spawned processes that import torch only
(`tests/torch_ranks.py`); this process runs JAX and compares what they
wrote. Tolerances:
  * the sharded render: atol 2e-5 / rtol 1e-4 against JAX
    `make_sharded_render` (jnp backend), the gate of JAX
    `tests/test_parallel.py`; equal to the port's own `make_render_fn`
    (the gathered set keeps the global order, so the stream is the
    single-device one), also where N is not a multiple of the ranks;
  * one `make_sharded_train_step` on a 2 x 2 world against JAX's on a
    (2, 2) mesh and against JAX's one-device step of each view
    (`check_step_against_jax` lists the gates: the tolerances of
    `test_torch_train_step.py` and the JAX package's own sharded-vs-single
    criterion);

`test_torch_parallel_training.py` holds the training loop on the mesh.
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
from gaussianavatars_tpu.parallel.sharded import (
    make_sharded_render as jax_sharded_render,
    make_sharded_train_step as jax_sharded_step,
)
from gaussianavatars_tpu.train import optim as jax_optim
from gaussianavatars_tpu.train.loop import (
    StepState as JaxStepState,
    binding_arg,
    camera_arrays as jax_camera_arrays,
    lr_pytree as jax_lr_pytree,
    make_train_step as jax_make_train_step,
)
from gaussianavatars_torch.config import PipelineConfig
from gaussianavatars_torch.models.gaussians import GaussianModel, GaussianParams
from gaussianavatars_torch.parallel.mesh import Mesh, make_mesh
from gaussianavatars_torch.train.loop import camera_arrays, make_render_fn
from gaussianavatars_torch.train.optim import B1

from . import torch_ranks
from .flame_fixtures import make_flame_assets
from .test_torch_blend import one_torch_thread  # noqa: F401
from .utils import make_camera, make_scene

GRAD_REL = 2e-4
W, H = 64, 48
JAX_PIPE = JaxPipeline(backend="jnp", capacity=1 << 16, chunk=16,
                       tile_size=32, binning="dense")


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def _cam_arrays(cam, prefix=""):
    return {prefix + k: np.asarray(getattr(cam, k), np.float32)
            for k in ("viewmatrix", "projmatrix", "campos")} | {
        prefix + "tan_fovx": np.float32(cam.tan_fovx),
        prefix + "tan_fovy": np.float32(cam.tan_fovy)}


def _jax_cam_tuple(cam):
    return (cam.viewmatrix, cam.projmatrix, cam.campos,
            jnp.asarray(cam.tan_fovx), jnp.asarray(cam.tan_fovy))


def _scene_params(n, seed):
    """make_scene as GaussianParams arrays (flat channel-major SH)."""
    scene = make_scene(n=n, seed=seed)
    shs = np.asarray(scene["shs"])
    op = np.asarray(scene["opacities"])
    return {"xyz": np.asarray(scene["means3d"]),
            "features_dc": shs[:, 0],
            "features_rest": np.ascontiguousarray(
                shs[:, 1:].transpose(0, 2, 1).reshape(n, -1)),
            "scaling": np.log(np.asarray(scene["scales"])),
            "rotation": np.asarray(scene["quats"]),
            "opacity": np.log(op / (1 - op))[:, None]}


@pytest.mark.parametrize("n,world", [(64, 2), (63, 2), (5, 4)])
def test_sharded_render_matches_jax_and_single(n, world, tmp_path):
    cam = make_camera(width=64, height=64)
    arrays = _scene_params(n, seed=n)
    np.savez(tmp_path / "scene.npz", **arrays, **_cam_arrays(cam))
    torch_ranks.run_ranks(torch_ranks.sharded_render, world, tmp_path,
                          width=64, height=64, sh_degree=2, tile_size=16)
    images = [np.load(tmp_path / f"image_{r}.npy") for r in range(world)]

    model = GaussianModel(2, GaussianParams(**{
        k: torch.from_numpy(v) for k, v in arrays.items()}), device="cpu")
    single = make_render_fn(model, PipelineConfig(tile_size=16), 64, 64, 2)(
        model.params, None, None, camera_arrays(
            torch_ranks._camera(_cam_arrays(cam))), torch.ones(3)
    ).image.numpy()
    for image in images:
        assert image.shape == (3, 64, 64)
        np.testing.assert_array_equal(image, single)
    assert single.std() > 0.01
    if n % world == 0:      # shard_map needs an axis the mesh divides
        render = jax_sharded_render(
            jax_make_mesh(n_data=1, n_prim=world), 64, 64, 2,
            capacity=4096, tile_size=16, chunk=8, backend="jnp",
            bound=False)
        ref = render(JaxParams(**{k: jnp.asarray(v)
                                  for k, v in arrays.items()}), None, None,
                     jnp.ones(n, bool), _jax_cam_tuple(cam), jnp.ones(3))
        for image in images:
            np.testing.assert_allclose(image, np.asarray(ref), atol=2e-5,
                                       rtol=1e-4)


def test_mesh_layout_and_shards():
    mesh = make_mesh(1, 1)
    assert mesh.local and mesh.shape == {"data": 1, "prim": 1}
    with pytest.raises(RuntimeError, match="torch.distributed"):
        make_mesh(1, 2)
    rows = [Mesh(1, 4, 0, p, object(), object()).shard(10)
            for p in range(4)]
    assert rows == [slice(0, 3), slice(3, 6), slice(6, 9), slice(9, 10)]
    assert Mesh(2, 4, 1, 3, object(), object()).shard(5) == slice(5, 5)


@pytest.mark.parametrize("n,world", [(10, 3), (3, 4)])
def test_state_round_trip_and_gather_backward(n, world, tmp_path):
    """Shards of N rows over 3 and 4 ranks (3, 3, 3, 1 and 1, 1, 1, 0)."""
    torch_ranks.run_ranks(torch_ranks.gather_round_trip, world, tmp_path,
                          n=n)
    assert all((tmp_path / f"ok_{r}.npy").exists() for r in range(world))


def test_parallel_entry_points_need_their_world(tmp_path):
    """A render-parallel run without torch.distributed, and a rank without
    torchrun's variables, raise."""
    from gaussianavatars_torch.config import (
        ModelConfig,
        OptimizationConfig,
    )
    from gaussianavatars_torch.parallel.distributed import (
        initialize_distributed,
    )
    from gaussianavatars_torch.train.loop import training

    with pytest.raises(RuntimeError, match="torch.distributed"):
        training(ModelConfig(source_path=str(tmp_path),
                             model_path=str(tmp_path / "o")),
                 OptimizationConfig(iterations=1),
                 PipelineConfig(render_parallel=2), device="cpu")
    with pytest.raises(RuntimeError, match="torchrun"):
        initialize_distributed(device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            initialize_distributed(world_size=1, rank=0)


@pytest.fixture(scope="module")
def carried(tmp_path_factory):
    """The JAX bound bench avatar (1 Gaussian per face, SH 3) written for
    the ranks, two views of it at 64x48 and the JAX model itself."""
    root = tmp_path_factory.mktemp("carried")
    jmodel = jax_bound_model(sh_degree=3, n_per_face=1, seed=0,
                             num_timesteps=4)
    paths = make_flame_assets(str(root / "flame"), seed=0)
    n = jmodel.n_alive
    torch_ranks.save_model(
        root / "model0.npz",
        {k: np.asarray(getattr(jmodel.params, k)) for k in JaxParams._fields},
        np.asarray(jmodel.binding_device()),
        {k: np.asarray(v) for k, v in jmodel.flame_param.items()}, 3, paths,
        n)
    cams = [make_camera(width=W, height=H, fovx=0.5, dist=1.0, angle=a)
            for a in (0.0, 0.3)]
    rng = np.random.default_rng(2)
    views = dict(gts=rng.random((2, 3, H, W)).astype(np.float32),
                 bgs=np.ones((2, 3), np.float32),
                 timesteps=np.asarray([1, 2], np.int32))
    for i, cam in enumerate(cams):
        views.update(_cam_arrays(cam, f"c{i}_"))
    np.savez(root / "views.npz", **views)
    return dict(root=root, jmodel=jmodel, cams=cams, views=views, n=n,
                paths=paths)


def _jax_step_inputs(jmodel, cams, views, subjects=None):
    """The JAX step's arguments for the carried model (or, with
    `subjects`, a list of (params, flame_tr) stacked on a subject axis)."""
    flame_tr = jmodel.flame_trainable()
    fixed = {k: v for k, v in jmodel.flame_param.items() if k not in flame_tr}
    lrs = jax_lr_pytree(JaxOpt(), 1e-3, flame_tr, 1.0)
    cap = jmodel.capacity
    cam_batch = jax.tree.map(lambda *xs: jnp.stack(xs),
                             *[_jax_cam_tuple(c) for c in cams])
    common = (cam_batch, jnp.asarray(views["gts"]), jnp.asarray(views["bgs"]),
              jnp.asarray(views["timesteps"]), lrs)
    if subjects is None:
        mu_g, nu_g, _ = jax_optim.init(jmodel.params)
        mu_f, nu_f, count = jax_optim.init(flame_tr)
        return (jmodel.params, flame_tr, fixed, jmodel.binding_device(),
                jmodel.active_mask()) + common + (
            mu_g, nu_g, mu_f, nu_f, count, jnp.zeros(cap), jnp.zeros(cap),
            jnp.zeros(cap))
    s = len(subjects)

    def stack(trees):
        return jax.tree.map(lambda *xs: jnp.stack(xs), *trees)

    params = stack([p for p, _ in subjects])
    flames = stack([f for _, f in subjects])
    zeros_p = jax.tree.map(jnp.zeros_like, params)
    zeros_f = jax.tree.map(jnp.zeros_like, flames)
    return (params, flames, stack([fixed] * s),
            jnp.broadcast_to(jmodel.binding_device(), (s, cap)),
            jnp.broadcast_to(jmodel.active_mask(), (s, cap))) + common + (
        zeros_p, zeros_p, zeros_f, zeros_f, jnp.int32(0),
        jnp.zeros((s, cap)), jnp.zeros((s, cap)), jnp.zeros((s, cap)))


def _rank_outputs(root, ranks):
    """The ranks' out_<rank>.npz, per-Gaussian arrays joined in rank
    order."""
    outs = [dict(np.load(root / f"out_{r}.npz")) for r in ranks]
    joined = {}
    for k in outs[0]:
        if k.startswith(("mu_", "param_", "before_")) or k in (
                "max_radii2d", "grad_accum", "denom"):
            joined[k] = np.concatenate([o[k] for o in outs])
        else:
            joined[k] = outs[0][k]
            for o in outs[1:]:
                np.testing.assert_array_equal(o[k], outs[0][k], err_msg=k)
    return joined


def jax_single_steps(jmodel, params, flame_tr, cams, views):
    """The JAX package's one-device `make_train_step` from a fresh state,
    once per view: its first moments of the Gaussians and FLAME (as
    gradients) and its densification statistics, each a list over the
    views."""
    flame_all = {**jmodel.flame_param, **flame_tr}
    fixed = {k: v for k, v in flame_all.items() if k not in flame_tr}
    step = jax_make_train_step(jmodel, JaxOpt(), JAX_PIPE, W, H, 3, 4)
    outs = []
    for i, cam in enumerate(cams):
        # copies: the step takes its state's buffers over
        state_in = jax.tree.map(jnp.array, {"gauss": params,
                                            "flame": flame_tr})
        mu, nu, count = jax_optim.init(state_in)
        cap = jmodel.capacity
        state = JaxStepState(params=state_in["gauss"],
                             flame_tr=state_in["flame"], mu=mu, nu=nu,
                             count=count, max_radii2d=jnp.zeros(cap),
                             grad_accum=jnp.zeros(cap), denom=jnp.zeros(cap))
        new, _, _ = step(state, fixed, binding_arg(jmodel),
                         jmodel.active_mask(), jax_camera_arrays(cam),
                         jnp.asarray(views["gts"][i]),
                         jnp.asarray(views["bgs"][i]),
                         jnp.int32(views["timesteps"][i]),
                         jax_lr_pytree(JaxOpt(), 1e-3, flame_tr, 1.0))
        outs.append({"gauss": {k: np.asarray(getattr(new.mu["gauss"], k))
                               / (1.0 - B1) for k in JaxParams._fields},
                     "flame": {k: np.asarray(v) / (1.0 - B1)
                               for k, v in new.mu["flame"].items()},
                     "accum": np.asarray(new.grad_accum),
                     "denom": np.asarray(new.denom),
                     "radii": np.asarray(new.max_radii2d)})
    return outs


def check_step_against_jax(port, jout, singles, n, batch_mean, tag=""):
    """One port step's joined outputs against the JAX sharded (or
    multi-subject) step's `jout` (params, flame, mu_g, nu_g, mu_f, nu_f,
    count, max_radii, accum, denom, losses, instances) and against the
    JAX one-device steps `singles` of the same views (`jax_single_steps`):

      * losses rtol 1e-5, the Adam count, `denom` and `max_radii2d`
        exactly, against the JAX step;
      * the updated parameters against the JAX step by the JAX package's
        own sharded-vs-single criterion (`tests/test_parallel.py`): 99.5%
        of the entries within 0.05 lr, none beyond 2.1 lr (a sign flip of
        Adam's first step at float32 noise), cosine > 0.99;
      * gradients per leaf (the first moment / (1 - B1)) and `grad_accum`
        within 2e-4 of the one-device steps' batch mean (`batch_mean`) or
        sum: the JAX sharded step's own gradients differ from its
        one-device step's by up to 1.7e-3 on this input, the port's by
        under 1e-5.
    """
    (params, _, _, _, _, _, count, max_radii, accum, denom, losses,
     _) = jout
    for k, v in losses.items():
        np.testing.assert_allclose(port[f"loss_{k}"], float(v), rtol=1e-5,
                                   err_msg=tag + k)
    assert int(port["count"]) == int(count) == 1
    np.testing.assert_array_equal(port["denom"], np.asarray(denom)[:n])
    np.testing.assert_array_equal(port["max_radii2d"],
                                  np.asarray(max_radii)[:n])
    lrs = jax_lr_pytree(JaxOpt(), 1e-3, {}, 1.0)["gauss"]._asdict()
    for k in JaxParams._fields:
        old = port[f"before_{k}"]
        a = np.asarray(getattr(params, k))[:n] - old
        b = port[f"param_{k}"] - old
        diff = np.abs(a - b)
        assert (diff <= 0.05 * lrs[k]).mean() > 0.995, (tag, k)
        assert diff.max() <= 2.1 * lrs[k], (tag, k)
        cos = np.dot(a.ravel(), b.ravel()) / (np.linalg.norm(a)
                                              * np.linalg.norm(b))
        assert cos > 0.99, (tag, k, cos)

    def ref(get):
        total = sum(get(s) for s in singles)
        return total / len(singles) if batch_mean else total

    for k in JaxParams._fields:
        want = ref(lambda s: s["gauss"][k])[:n]
        assert np.abs(want).max() > 0, k
        got = port[f"mu_{k}"] / (1.0 - B1)
        assert _rel(got, want) <= GRAD_REL, (tag, k, _rel(got, want))
    for k in singles[0]["flame"]:
        want = ref(lambda s: s["flame"][k])
        assert np.abs(want).max() > 0, k
        assert _rel(port[f"fmu_{k}"] / (1.0 - B1), want) <= GRAD_REL, \
            (tag, k)
    want = sum(s["accum"] for s in singles)[:n]
    assert _rel(port["grad_accum"], want) <= GRAD_REL, tag
    assert port["grad_accum"].max() > 0


def test_sharded_train_step_matches_jax(carried):
    """2 data x 2 prim ranks against JAX's (2, 2) mesh: both cameras of
    the batch averaged, the shards' gradients joined."""
    root, jmodel = carried["root"], carried["jmodel"]
    torch_ranks.run_ranks(torch_ranks.train_step, 4, root, n_data=2,
                          width=W, height=H, tile_size=32, subjects=False)
    step = jax_sharded_step(jax_make_mesh(n_data=2, n_prim=2), jmodel,
                            JaxOpt(), JAX_PIPE, W, H, sh_degree=3)
    jout = step(*_jax_step_inputs(jmodel, carried["cams"], carried["views"]))
    singles = jax_single_steps(jmodel, jmodel.params,
                               jmodel.flame_trainable(), carried["cams"],
                               carried["views"])
    # data group 0 holds every shard; group 1 holds the same values
    port = _rank_outputs(root, [0, 1])
    other = _rank_outputs(root, [2, 3])
    for k in port:
        np.testing.assert_array_equal(other[k], port[k], err_msg=k)
    check_step_against_jax(port, jout, singles, carried["n"], True)
    assert set(k[5:] for k in port if k.startswith("loss_")) == \
        {"l1", "ssim", "xyz", "scale", "total"}
