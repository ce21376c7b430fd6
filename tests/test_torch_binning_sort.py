"""Port parity of the sort binning (`--binning sort`).

  * `ops/binning.py::bin_gaussians` against the JAX package's
    `bin_gaussians` on the same projected Gaussians: the streams must be
    identical, slot for slot (gaussian ids, tile starts and ends). JAX's
    stream is its `instance_valid` prefix; its `total` counts the rect slots
    before the cull and is not compared with the port's stream length;
  * `compute_tile_rects` equal to JAX's;
  * the port's `rasterize(binning="sort")` against JAX `rasterize(
    binning_impl="sort", backend="jnp")`, image atol 5e-5;
  * the port's sort path against its dense path: image atol 1e-5,
    gradients atol 1e-4 / rtol 1e-4 (JAX `tests/test_rasterizer.py::
    TestDenseBinning`'s tolerances).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianavatars_tpu.ops.binning import bin_gaussians as jbin
from gaussianavatars_tpu.ops.binning import compute_tile_rects as jrects
from gaussianavatars_tpu.ops.projection import project_gaussians as jproject
from gaussianavatars_tpu.ops.rasterize_tiles import rasterize as jrasterize
from gaussianavatars_torch.ops.binning import bin_gaussians as tbin
from gaussianavatars_torch.ops.binning import compute_tile_rects as trects
from gaussianavatars_torch.ops.projection import CameraParams
from gaussianavatars_torch.ops.rasterize_tiles import rasterize

from .utils import make_camera, make_scene
from .test_torch_blend import one_torch_thread  # noqa: F401

CAPACITY = 1 << 16      # at or above every case's JAX `total`
KEYS = ("means3d", "scales", "quats", "opacities", "shs")


def _t(a):
    return torch.from_numpy(np.array(a))


def _torch_camera(cam):
    return CameraParams(
        viewmatrix=_t(cam.viewmatrix), projmatrix=_t(cam.projmatrix),
        campos=_t(cam.campos), tan_fovx=cam.tan_fovx,
        tan_fovy=cam.tan_fovy, width=cam.width, height=cam.height)


def _projected(seed, n, width, height, spread, scale_mean):
    cam = make_camera(width=width, height=height, fovx=0.9, dist=3.0)
    scene = make_scene(n=n, seed=seed, spread=spread, scale_mean=scale_mean)
    return jproject(*[scene[k] for k in KEYS], 2, cam)


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4))
def _jax_binning(proj, width, height, tile_size, window):
    row0, rows = window if window else (0, None)
    return jbin(proj.means2d, proj.depths, proj.radii, proj.valid, width,
                height, tile_size, CAPACITY, tile_row_start=row0,
                tile_rows=rows, means2d_cull=proj.means2d,
                r2_max=proj.r2_max)


@pytest.mark.parametrize("seed,tile_size,spread,scale_mean,window", [
    (0, 16, 1.0, -2.3, None),
    (1, 32, 1.0, -2.3, None),
    (2, 16, 0.5, -2.0, None),
    (3, 32, 1.5, -1.6, None),
    (4, 16, 0.8, -2.3, (1, 2)),
    (5, 32, 1.0, -1.8, (1, 1)),
])
def test_stream_matches_jax(seed, tile_size, spread, scale_mean, window):
    width, height = 96, 72
    proj = _projected(seed, 400, width, height, spread, scale_mean)
    row0, rows = window if window else (0, None)
    ref = _jax_binning(proj, width, height, tile_size, window)
    assert int(ref.total) <= CAPACITY
    out = tbin(_t(proj.means2d), _t(proj.depths), _t(proj.radii),
               _t(proj.valid), _t(proj.r2_max), width, height, tile_size,
               row0, rows)
    kept = int(np.sum(np.asarray(ref.instance_valid)))
    assert 0 < kept < int(ref.total)        # the disc cull dropped slots
    assert out.total == kept
    assert (out.num_tiles_x, out.num_tiles_y) == (ref.num_tiles_x,
                                                  ref.num_tiles_y)
    np.testing.assert_array_equal(out.tile_starts.numpy(),
                                  np.asarray(ref.tile_starts))
    np.testing.assert_array_equal(out.tile_ends.numpy(),
                                  np.asarray(ref.tile_ends))
    np.testing.assert_array_equal(out.gaussian_ids.numpy(),
                                  np.asarray(ref.gaussian_ids)[:kept])


@pytest.mark.parametrize("tile_size", [16, 32])
def test_tile_rects_match_jax(tile_size):
    proj = _projected(6, 300, 80, 56, 1.2, -1.8)
    ref = jrects(proj.means2d, proj.radii, 80, 56, tile_size)
    out = trects(_t(proj.means2d), _t(proj.radii), 80, 56, tile_size)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _port_render(scene, cam, **kw):
    return rasterize(*[_t(scene[k]) for k in KEYS], 2, _torch_camera(cam),
                     torch.ones(3), **kw)


@pytest.mark.parametrize("tile_size,seed,width,height", [
    (16, 0, 48, 40), (32, 1, 48, 40), (16, 3, 37, 29)])
def test_sort_render_matches_jax(tile_size, seed, width, height):
    cam = make_camera(width=width, height=height)
    scene = make_scene(n=80, seed=seed)
    ref = jrasterize(*[jnp.asarray(scene[k]) for k in KEYS], 2, cam,
                     jnp.ones(3), capacity=1 << 14, tile_size=tile_size,
                     chunk=16, backend="jnp", binning_impl="sort")
    out = _port_render(scene, cam, tile_size=tile_size, binning="sort")
    assert out.instance_total > 0
    np.testing.assert_allclose(out.image.numpy(), np.asarray(ref.image),
                               atol=5e-5, rtol=0)


def test_sort_matches_dense_image():
    cam = make_camera(width=48, height=32, fovx=0.8, dist=3.5)
    scene = make_scene(n=80, seed=5, sh_degree=2, spread=1.2)
    dense = _port_render(scene, cam, tile_size=16)
    sort = _port_render(scene, cam, tile_size=16, binning="sort")
    assert sort.instance_total > dense.instance_total
    torch.testing.assert_close(sort.image, dense.image, atol=1e-5, rtol=0)
    assert torch.equal(sort.radii, dense.radii)
    assert torch.equal(sort.visibility, dense.visibility)


def test_sort_matches_dense_grads():
    cam = make_camera(width=48, height=32, fovx=0.8, dist=3.5)
    scene = make_scene(n=60, seed=7, sh_degree=2, spread=1.2)
    w = torch.from_numpy(np.random.default_rng(0).normal(
        size=(3, 32, 48)).astype(np.float32))
    grads = {}
    for binning in ("sort", "dense"):
        leaves = [_t(scene[k]).requires_grad_() for k in KEYS]
        offset = torch.zeros((60, 2), requires_grad=True)
        out = rasterize(*leaves, 2, _torch_camera(cam), torch.ones(3),
                        tile_size=16, binning=binning,
                        means2d_offset=offset)
        grads[binning] = torch.autograd.grad(
            torch.sum(out.image * w), leaves + [offset])
    for name, a, b in zip(KEYS + ("means2d_offset",), grads["sort"],
                          grads["dense"]):
        assert float(b.abs().max()) > 0, name
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4, msg=name)


def test_unknown_binning_raises():
    cam = make_camera(width=32, height=32)
    with pytest.raises(ValueError, match="binning"):
        _port_render(make_scene(n=8, seed=0), cam, binning="chunked")
