"""The port's rasterizer against both checked-in golden renders, at the
tolerances of tests/test_golden.py (48x40: atol 3e-5 / rtol 1e-4;
160x120: atol 5e-5 / rtol 1e-4), plus a slab render against the full one."""

import os

import numpy as np
import torch

from gaussianavatars_torch.ops.projection import CameraParams
from gaussianavatars_torch.ops.rasterize_tiles import rasterize

from .golden.make_goldens import big_scene
from .utils import make_camera, make_scene
from .test_torch_blend import one_torch_thread  # noqa: F401

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")


def _t(a):
    return torch.from_numpy(np.array(a))


def _render(scene, cam, **kw):
    camera = CameraParams(
        viewmatrix=_t(cam.viewmatrix), projmatrix=_t(cam.projmatrix),
        campos=_t(cam.campos), tan_fovx=cam.tan_fovx, tan_fovy=cam.tan_fovy,
        width=cam.width, height=cam.height)
    return rasterize(
        _t(scene["means3d"]), _t(scene["scales"]), _t(scene["quats"]),
        _t(scene["opacities"]), _t(scene["shs"]), 2, camera, torch.ones(3),
        tile_size=32, **kw)


def test_port_matches_golden_48x40():
    out = _render(make_scene(n=80, seed=0), make_camera(width=48, height=40))
    golden = np.load(os.path.join(GOLDEN_DIR, "render_48x40_seed0.npz"))
    np.testing.assert_allclose(out.image.numpy(), golden["image"],
                               atol=3e-5, rtol=1e-4)
    assert out.instance_total > 0
    assert out.radii.dtype == torch.int32 and out.visibility.dtype == torch.bool


def test_port_matches_golden_160x120():
    out = _render(big_scene(), make_camera(width=160, height=120, fovx=0.6,
                                           dist=1.2))
    golden = np.load(os.path.join(GOLDEN_DIR, "render_160x120_seed3.npz"))
    np.testing.assert_allclose(out.image.numpy(), golden["image"],
                               atol=5e-5, rtol=1e-4)


def test_port_slab_matches_full_render():
    scene = make_scene(n=120, seed=5)
    cam = make_camera(width=80, height=72)
    full = _render(scene, cam)
    slab = _render(scene, cam, tile_row_start=1, tile_rows=2)
    # the slab covers pixel rows 32..95, cropped by the image bottom at 72
    assert slab.image.shape == (3, 64, 80)
    torch.testing.assert_close(slab.image[:, :40], full.image[:, 32:72],
                               atol=1e-6, rtol=0)
