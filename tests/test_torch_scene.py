"""The port on a 3DGS scene seen from a 360-degree camera ring, on the CPU,
against the JAX package (the port's reference: `project_gaussians`, the
jnp tile `rasterize` with dense binning and `make_train_step`, at the
tolerances of `test_torch_ops.py`, `test_torch_blend.py` and
`test_torch_train_step.py`) and against the benchmark's plain reference
(`avatarbench/reference/`, plain torch and float32, no kernel of the port).

The scene is `avatarbench/scene3dgs.py`'s mixture, the generator of the
configuration `3dgs-mip360-3m`, at 3,000 Gaussians from a seed, viewed at
96x64 (tile 16) by cameras of the traffic `train-orbit-360`'s ring: about
a fifth of the background (9% of the scene) lies behind each camera, and
a third of the scene is culled. A few Gaussians are added
in each camera's own frame where culling decides: behind the camera, on
both sides of the near plane (view z 0.2), and straddling the image's
borders (centres outside the image whose footprint reaches in, and one
whose footprint does not).
"""

import json
import math
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from avatarbench import scene, scene3dgs
from avatarbench.reference import render as ref_render
from avatarbench.reference import train as ref_train
from gaussianavatars_tpu.config import OptimizationConfig as JaxOpt
from gaussianavatars_tpu.config import PipelineConfig as JaxPipeline
from gaussianavatars_tpu.models.gaussians import GaussianModel as JaxModel
from gaussianavatars_tpu.models.gaussians import GaussianParams as JaxParams
from gaussianavatars_tpu.ops import projection as jproj
from gaussianavatars_tpu.ops.rasterize_tiles import rasterize as jrasterize
from gaussianavatars_tpu.train import optim as jax_optim
from gaussianavatars_tpu.train.loop import (
    StepState as JaxStepState,
    camera_arrays as jax_camera_arrays,
    lr_pytree as jax_lr_pytree,
    make_train_step as jax_make_train_step,
)
from gaussianavatars_torch.config import OptimizationConfig, PipelineConfig
from gaussianavatars_torch.models.gaussians import (
    GaussianModel,
    GaussianParams,
)
from gaussianavatars_torch.ops.projection import (
    CameraParams,
    project_gaussians,
)
from gaussianavatars_torch.ops.rasterize_tiles import rasterize
from gaussianavatars_torch.train.loop import (
    CameraArrays,
    initial_state,
    lr_pytree,
    make_train_step,
)

from .test_torch_blend import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H, TILE, N, SEED = 96, 64, 16, 3000, 3_000_000_017
CAMS = (0, 11, 23)           # three of the ring's 32 cameras
KEYS = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
        "opacity")
# camera-frame probes: (x / (z tan_fovx), y / (z tan_fovy), z) and scale
PROBES = {
    "behind": [(0.0, 0.0, -1.0), (0.3, -0.2, -0.3)],
    "near_in_front": [(0.1, 0.0, 0.21), (-0.3, 0.2, 0.25)],
    "near_culled": [(0.0, 0.1, 0.19), (0.2, 0.0, 0.05)],
    "border_in": [(1.04, 0.0, 2.0), (0.0, -1.05, 2.0), (-1.03, 1.03, 3.0)],
    "border_out": [(1.6, 0.0, 2.0)],
}
PROBE_SCALE = 0.05
CAPACITY = 1 << 16           # the JAX stream's slots (a view needs ~3k)
GRAD_REL = 2e-4              # max|d| / max|ref|, as test_torch_train_step


def _load(name):
    with open(os.path.join(ROOT, "avatarbench", name)) as fh:
        return json.load(fh)


@pytest.fixture(scope="module")
def setup():
    cfg = _load("configs/3dgs-mip360-3m.json")
    tr = _load("traffic/train-orbit-360.json")
    rig = scene.rig(tr["cameras"], tr["yaw_deg"], tr["pitch"], tr["dist"])
    cams = [scene.camera(rig[c], W, H, tr["fovx"], "cpu") for c in CAMS]
    params = scene3dgs.scene_params(SEED, N, cfg["scene"], 16, "cpu")
    rows, kinds = [], []
    for c in CAMS:
        tan_x = math.tan(tr["fovx"] / 2)
        tan_y = tan_x * H / W
        for kind, pts in PROBES.items():
            for u, v, z in pts:
                zz = abs(z)
                local = np.array([u * zz * tan_x, v * zz * tan_y, z, 1.0])
                rows.append((rig[c] @ local)[:3])
                kinds.append((c, kind))
    k = len(rows)
    g = torch.Generator().manual_seed(5)
    quat = torch.randn(k, 4, generator=g)
    probes = dict(
        xyz=torch.tensor(np.array(rows), dtype=torch.float32),
        features_dc=torch.full((k, 3), 0.6),
        features_rest=torch.zeros(k, 45),
        scaling=torch.full((k, 3), math.log(PROBE_SCALE)),
        rotation=quat / quat.norm(dim=1, keepdim=True),
        opacity=torch.full((k, 1), 1.5))
    params = {key: torch.cat([params[key], probes[key]]) for key in KEYS}
    gt = scene.smooth_images(SEED, 1, H, W, "cpu")[0]
    return dict(cfg=cfg, cams=cams, params=params, kinds=kinds, gt=gt)


def _port_camera(cam) -> CameraParams:
    return CameraParams(cam["viewmatrix"], cam["projmatrix"], cam["campos"],
                        cam["tan_fovx"], cam["tan_fovy"], W, H)


def _jax_camera(cam) -> jproj.CameraParams:
    return jproj.CameraParams(
        *(jnp.asarray(cam[k].numpy()) for k in
          ("viewmatrix", "projmatrix", "campos")),
        cam["tan_fovx"], cam["tan_fovy"], W, H)


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def _port_inputs(params):
    n = params["xyz"].shape[0]
    sh = torch.cat([params["features_dc"][:, :, None],
                    params["features_rest"].reshape(n, 3, -1)], 2)
    return (params["xyz"], torch.exp(params["scaling"]), params["rotation"],
            torch.sigmoid(params["opacity"][:, 0]), sh.reshape(n, -1))


@pytest.mark.parametrize("i", range(len(CAMS)))
def test_projection_and_culling(setup, i):
    """Visibility equal Gaussian for Gaussian; where visible, positions,
    conics and colours to float32 round-off. The probes land where they
    were put: the ones behind the camera or before the near plane culled,
    the ones just past it kept, the border ones kept with their centres
    outside the image, the far one culled."""
    cam = setup["cams"][i]
    params = setup["params"]
    with torch.no_grad():
        port = project_gaussians(*_port_inputs(params), 3, _port_camera(cam))
        ref = ref_render.project(*ref_render.world_gaussians(params),
                                 ref_render.Camera(**cam))
    assert torch.equal(port.valid, ref.valid)
    v = ref.valid
    assert torch.equal(port.radii[v].float(), ref.radii[v])
    # centres: 1e-4 px at up to ~1e3 px (the probes' off-screen centres):
    # float32 round-off of the reciprocal against the quotient
    torch.testing.assert_close(port.means2d[v], ref.means2d[v], rtol=1e-6,
                               atol=1e-4)
    # conics: the same EWA products in another order, up to 1/(0.3 px)^2
    torch.testing.assert_close(port.conics[v], ref.conics[v], rtol=1e-5,
                               atol=1e-6)
    torch.testing.assert_close(port.colors[v], ref.colors[v], rtol=1e-6,
                               atol=1e-6)
    # a ring camera culls a third of the scene (9% behind it)
    assert 0.2 < float(v[:N].float().mean()) < 0.8
    c = CAMS[i]
    base = N
    for (cc, kind), ok in zip(setup["kinds"], v[N:].tolist()):
        if cc != c:
            continue
        want = kind in ("near_in_front", "border_in")
        assert ok == want, (c, kind)
    probes = [j for j, (cc, kind) in enumerate(setup["kinds"])
              if cc == c and kind == "border_in"]
    m = port.means2d[[base + j for j in probes]]
    assert bool(((m[:, 0] < 0) | (m[:, 0] >= W) | (m[:, 1] < 0)
                 | (m[:, 1] >= H)).all())


@pytest.mark.parametrize("i", range(len(CAMS)))
def test_projection_matches_jax(setup, i):
    """The JAX package's projection on the same Gaussians and probes:
    visibility and radii equal; where visible, depths, conics, colours and
    the blend's bounds at `test_torch_ops.py`'s rtol 1e-5 / atol 1e-6, the
    centres (up to ~1e3 px off screen) within 1e-4 px as against the
    reference. The cut radius squared `r2_max` holds 1e-5 on the scene;
    the probe just past the near plane, a footprint of ~6000 px^2 from a
    nearly singular 2D covariance, reads 4e-5 to 8.4e-5 and holds 1e-4."""
    cam = setup["cams"][i]
    inputs = _port_inputs(setup["params"])
    with torch.no_grad():
        port = project_gaussians(*inputs, 3, _port_camera(cam))
    ref = jproj.project_gaussians(*(jnp.asarray(a.numpy()) for a in inputs),
                                  3, _jax_camera(cam))
    v = np.asarray(ref.valid)
    np.testing.assert_array_equal(port.valid.numpy(), v)
    np.testing.assert_array_equal(port.radii.numpy(), np.asarray(ref.radii))
    assert 0 < v.sum() < len(v)
    for name in ("depths", "conics", "colors", "opacities", "ext_x",
                 "ext_y", "tau"):
        np.testing.assert_allclose(
            getattr(port, name).numpy()[v], np.asarray(getattr(ref, name))[v],
            rtol=1e-5, atol=1e-6, err_msg=name)
    np.testing.assert_allclose(port.means2d.numpy()[v],
                               np.asarray(ref.means2d)[v], rtol=1e-6,
                               atol=1e-4)
    r2, r2_ref = port.r2_max.numpy(), np.asarray(ref.r2_max)
    scene_rows = v.copy()
    scene_rows[N:] = False
    np.testing.assert_allclose(r2[scene_rows], r2_ref[scene_rows],
                               rtol=1e-5)
    np.testing.assert_allclose(r2[v], r2_ref[v], rtol=1e-4)


def test_render_image(setup):
    """One view's image, K1's plain version on the CPU against the
    reference's closed-form blend: max|d| <= 1e-5 (float32 round-off of
    the same front-to-back sums over a few hundred Gaussians a pixel)."""
    cam = setup["cams"][0]
    params = setup["params"]
    bg = torch.zeros(3)
    with torch.no_grad():
        out = rasterize(*_port_inputs(params), 3, _port_camera(cam), bg,
                        tile_size=TILE)
        ref, _ = ref_render.render(params, None, None,
                                   ref_render.Camera(**cam), bg, tile=TILE)
    assert out.instance_total > 0
    assert float(ref.image.abs().max()) > 0.1
    assert float((out.image - ref.image).abs().max()) <= 1e-5


def test_render_matches_jax(setup):
    """The same view through the JAX package's jnp tile rasterizer with
    dense binning: the same number of slots, none clamped, and the image
    within `test_torch_blend.py`'s atol 1e-5 (float32 transmittance,
    carried in log space by JAX and as products by the port)."""
    cam = setup["cams"][0]
    inputs = _port_inputs(setup["params"])
    bg = torch.zeros(3)
    with torch.no_grad():
        out = rasterize(*inputs, 3, _port_camera(cam), bg, tile_size=TILE)
    ref = jrasterize(*(jnp.asarray(a.numpy()) for a in inputs), 3,
                     _jax_camera(cam), jnp.asarray(bg.numpy()),
                     capacity=CAPACITY, tile_size=TILE, chunk=16,
                     backend="jnp", binning_impl="dense")
    assert int(ref.rect_overflow) == 0
    assert out.instance_total == int(ref.instance_total) < CAPACITY
    np.testing.assert_allclose(out.image.numpy(), np.asarray(ref.image),
                               atol=1e-5, rtol=0)


@pytest.fixture(scope="module")
def stepped(setup):
    """One train step of the port on the generated scene (without the
    probes), from camera 11, with the configuration's rates."""
    cfg, cam = setup["cfg"], setup["cams"][1]
    params = {k: v[:N] for k, v in setup["params"].items()}
    opt = OptimizationConfig(**cfg["optimization"])
    model = GaussianModel(cfg["sh_degree"], GaussianParams(
        **{k: v.clone() for k, v in params.items()}))
    model.spatial_lr_scale = cfg["spatial_lr_scale"]
    model.reset_stats()
    step = make_train_step(model, opt, PipelineConfig(tile_size=TILE), W, H,
                           cfg["sh_degree"], 1)
    state = initial_state(model)
    xyz_lr = opt.position_lr_init * cfg["spatial_lr_scale"]
    lrs = lr_pytree(opt, xyz_lr, state.flame_tr, cfg["spatial_lr_scale"])
    arrays = CameraArrays(cam["viewmatrix"], cam["projmatrix"],
                          cam["campos"], cam["tan_fovx"], cam["tan_fovy"])
    state, losses, _ = step(state, {}, None, arrays, setup["gt"],
                            torch.zeros(3), 0, lrs)
    return dict(cfg=cfg, cam=cam, params=params, xyz_lr=xyz_lr,
                state=state, losses=losses)


def test_train_step_matches_jax(setup, stepped):
    """The same step through the JAX package's `make_train_step` (jnp
    backend, dense binning): the loss terms to rtol 1e-5 and each leaf's
    gradient (the first Adam moment over 1 - beta1) and the densification
    statistic within max|d| / max|JAX| <= 2e-4, the tolerances of
    `test_torch_train_step.py`."""
    cfg, cam, params = stepped["cfg"], stepped["cam"], stepped["params"]
    jmodel = JaxModel(cfg["sh_degree"])
    jmodel.params = JaxParams(**{k: jnp.asarray(params[k].numpy())
                                 for k in KEYS})
    jmodel.n_alive = N
    jmodel.active_sh_degree = cfg["sh_degree"]
    jmodel.spatial_lr_scale = cfg["spatial_lr_scale"]
    jmodel.reset_stats()
    mu, nu, count = jax_optim.init({"gauss": jmodel.params, "flame": {}})
    jstate = JaxStepState(
        params=jmodel.params, flame_tr={}, mu=mu, nu=nu, count=count,
        max_radii2d=jmodel.max_radii2d,
        grad_accum=jmodel.xyz_gradient_accum, denom=jmodel.denom)
    opt = JaxOpt(**cfg["optimization"])
    pipe = JaxPipeline(backend="jnp", capacity=CAPACITY, chunk=16,
                       tile_size=TILE, binning="dense")
    jstep = jax_make_train_step(jmodel, opt, pipe, W, H, cfg["sh_degree"],
                                1)
    jout, jl, _ = jstep(
        jstate, {}, None, jmodel.active_mask(),
        jax_camera_arrays(_jax_camera(cam)), jnp.asarray(setup["gt"].numpy()),
        jnp.zeros(3), jnp.int32(0),
        jax_lr_pytree(opt, stepped["xyz_lr"], {}, cfg["spatial_lr_scale"]))
    state, losses = stepped["state"], stepped["losses"]
    assert set(losses) == set(jl)
    for key in jl:
        np.testing.assert_allclose(float(losses[key]), float(jl[key]),
                                   rtol=1e-5, err_msg=key)
    for key in KEYS:
        got = getattr(state.mu["gauss"], key).numpy()
        gap = _rel(got, np.asarray(getattr(jout.mu["gauss"], key)))
        assert gap <= GRAD_REL, (key, gap)
    gap = _rel(state.grad_accum.numpy().reshape(-1),
               np.asarray(jout.grad_accum).reshape(-1))
    assert gap <= GRAD_REL, gap


def test_train_step_loss_and_gradients(setup, stepped):
    """One train step of the unbound model on the generated scene (without
    the probes) with the configuration's rates: the loss terms to 1e-5
    relative, each leaf's gradient (read from the first Adam moment,
    m = (1 - beta1) g) within 2e-4 of the reference's in norm relative to
    it (float32 round-off through the blend's backward), and the
    densification statistic likewise. The probes' screen-filling
    footprints are left out here: a sum over every pixel of the view for
    one Gaussian, their rotation gradients differ by ~3e-4 in float32
    between the port and the reference, each as far from a float64
    reference as from the other."""
    cfg, cam, params = stepped["cfg"], stepped["cam"], stepped["params"]
    state, losses, xyz_lr = (stepped["state"], stepped["losses"],
                             stepped["xyz_lr"])
    opt = OptimizationConfig(**cfg["optimization"])
    bg = torch.zeros(3)
    st = ref_train.init_state(params, {})
    ref_lrs = dict(xyz=xyz_lr, features_dc=opt.feature_lr,
                   features_rest=opt.feature_lr / 20.0,
                   scaling=opt.scaling_lr, rotation=opt.rotation_lr,
                   opacity=opt.opacity_lr)
    terms, grads = ref_train.step(None, st, {}, None,
                                  ref_render.Camera(**cam), setup["gt"], bg,
                                  0, ref_lrs, cfg["optimization"], TILE)
    for key in ("l1", "ssim", "total"):
        assert float(losses[key]) == pytest.approx(terms[key], rel=1e-5)
    for key, g_ref in zip(KEYS, grads):
        g = getattr(state.mu["gauss"], key) / (1.0 - ref_train.B1)
        gap = float((g - g_ref).norm() / g_ref.norm())
        assert gap <= 2e-4, (key, gap)
    gap = float((state.grad_accum - st["grad_accum"]).norm()
                / st["grad_accum"].norm())
    assert gap <= 2e-4
