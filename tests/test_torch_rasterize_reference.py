"""The port's oracle rasterizer (`ops/rasterize_reference.py`).

  * against the JAX package's `rasterize_reference` on the same projected
    Gaussians: image atol 1e-6 / rtol 1e-5, and the gradients of
    sum(image * w) with respect to every scene input, per input max|d| /
    max|JAX| <= 1e-4;
  * as the oracle of the port's tile rasterizer, under both binnings, at
    JAX `tests/test_rasterizer.py`'s tolerances: image atol 2e-5 / rtol
    1e-4 (3e-5 with the early-out), an off-screen scene is the background
    within 1e-6, and the gradients of the scene inputs and of the
    `means2d_offset` within atol 5e-4 of max|oracle| (1e-3 with the
    early-out).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianavatars_tpu.ops.projection import project_gaussians as jproject
from gaussianavatars_tpu.ops.rasterize_jnp import (
    rasterize_reference as jreference,
)
from gaussianavatars_torch.ops.projection import (
    CameraParams,
    project_gaussians,
)
from gaussianavatars_torch.ops.rasterize_reference import rasterize_reference
from gaussianavatars_torch.ops.rasterize_tiles import rasterize

from .utils import make_camera, make_scene
from .test_torch_blend import one_torch_thread  # noqa: F401

KEYS = ("means3d", "scales", "quats", "opacities", "shs")


def _t(a):
    return torch.from_numpy(np.array(a))


def _torch_camera(cam):
    return CameraParams(
        viewmatrix=_t(cam.viewmatrix), projmatrix=_t(cam.projmatrix),
        campos=_t(cam.campos), tan_fovx=cam.tan_fovx,
        tan_fovy=cam.tan_fovy, width=cam.width, height=cam.height)


def _oracle(leaves, cam, offset=None):
    proj = project_gaussians(*leaves, 2, cam, means2d_offset=offset)
    return rasterize_reference(proj, cam, torch.ones(3))


def _tile(leaves, cam, offset=None, **kw):
    return rasterize(*leaves, 2, cam, torch.ones(3), tile_size=16,
                     means2d_offset=offset, **kw).image


@pytest.mark.parametrize("seed,width,height", [(0, 48, 40), (3, 37, 29)])
def test_oracle_matches_jax(seed, width, height):
    cam = make_camera(width=width, height=height)
    scene = make_scene(n=60, seed=seed)
    w = np.random.default_rng(seed).normal(
        size=(3, height, width)).astype(np.float32)

    def jloss(s):
        proj = jproject(*[s[k] for k in KEYS], 2, cam)
        img = jreference(proj, cam, jnp.ones(3))
        return jnp.sum(img * w), img

    (_, jimg), jgrads = jax.value_and_grad(jloss, has_aux=True)(
        {k: jnp.asarray(scene[k]) for k in KEYS})
    leaves = [_t(scene[k]).requires_grad_() for k in KEYS]
    img = _oracle(leaves, _torch_camera(cam))
    grads = torch.autograd.grad(torch.sum(img * torch.from_numpy(w)), leaves)
    assert float(img.detach().std()) > 0.01
    np.testing.assert_allclose(img.detach().numpy(), np.asarray(jimg),
                               atol=1e-6, rtol=1e-5)
    for k, g in zip(KEYS, grads):
        ref = np.asarray(jgrads[k])
        rel = np.abs(g.numpy() - ref).max() / np.abs(ref).max()
        assert rel <= 1e-4, (k, rel)


@pytest.mark.parametrize("binning", ["dense", "sort"])
@pytest.mark.parametrize("case", ["plain", "odd_size", "early_out"])
def test_tile_rasterizer_matches_oracle(case, binning):
    if case == "early_out":   # dense and opaque: T falls below 1e-4
        cam = make_camera(width=32, height=32)
        scene = make_scene(n=128, seed=9, spread=0.2, scale_mean=-1.2)
        scene["opacities"] = np.full(128, 0.995, np.float32)
        img_atol, grad_atol = 3e-5, 1e-3
    else:
        cam = make_camera(width=37, height=29) if case == "odd_size" else \
            make_camera(width=48, height=40)
        scene = make_scene(n=60, seed=7)
        img_atol, grad_atol = 2e-5, 5e-4
    tcam = _torch_camera(cam)
    w = torch.from_numpy(np.random.default_rng(0).normal(
        size=(3, cam.height, cam.width)).astype(np.float32))
    out = {}
    for name in ("oracle", "tile"):
        leaves = [_t(scene[k]).requires_grad_() for k in KEYS]
        offset = torch.zeros((len(scene["opacities"]), 2),
                             requires_grad=True)
        img = (_oracle(leaves, tcam, offset) if name == "oracle" else
               _tile(leaves, tcam, offset, binning=binning))
        out[name] = (img.detach(), torch.autograd.grad(
            torch.sum(img * w), leaves + [offset]))
    np.testing.assert_allclose(out["tile"][0].numpy(),
                               out["oracle"][0].numpy(), atol=img_atol,
                               rtol=1e-4)
    for k, a, b in zip(KEYS + ("means2d_offset",), out["oracle"][1],
                       out["tile"][1]):
        scale = max(float(a.abs().max()), 1e-3)
        np.testing.assert_allclose(a.numpy() / scale, b.numpy() / scale,
                                   atol=grad_atol, err_msg=k)
    if case == "early_out":
        trans = rasterize(*[_t(scene[k]) for k in KEYS], 2, tcam,
                          torch.ones(3), tile_size=16,
                          binning=binning).transmittance
        assert float(trans.min()) < 5e-4


def test_empty_scene_gives_background():
    cam = _torch_camera(make_camera(width=24, height=16))
    scene = make_scene(n=4, seed=5)
    leaves = [_t(scene[k]) for k in KEYS]
    leaves[0] = leaves[0] + 100.0          # push off-screen
    for img in (_oracle(leaves, cam), _tile(leaves, cam),
                _tile(leaves, cam, binning="sort")):
        np.testing.assert_allclose(img.numpy(), 1.0, atol=1e-6)
