"""Port parity: the duplicated-key-sort binning of `gaussianavatars_torch`
against the JAX package's `bin_gaussians_dense` on the same projected
gaussians. The streams must be identical: `total`, every tile's
[start, end) and the gaussian-id order of the stream."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianavatars_tpu.ops.binning_dense import bin_gaussians_dense as jbin
from gaussianavatars_tpu.ops.projection import project_gaussians as jproject
from gaussianavatars_torch.ops.binning_dense import bin_gaussians_dense as tbin

from .utils import make_camera, make_scene
from .test_torch_blend import one_torch_thread  # noqa: F401


def _projected(seed, n, width, height, spread, scale_mean):
    cam = make_camera(width=width, height=height, fovx=0.9, dist=3.0)
    scene = make_scene(n=n, seed=seed, spread=spread, scale_mean=scale_mean)
    return jproject(scene["means3d"], scene["scales"], scene["quats"],
                    scene["opacities"], scene["shs"], 2, cam)


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4))
def _jax_binning(proj, width, height, tile_size, window):
    row0, rows = window if window else (0, None)
    return jbin(proj.means2d, proj.depths, proj.radii, proj.valid, width,
                height, tile_size, tile_row_start=row0, tile_rows=rows,
                means2d_cull=proj.means2d, r2_max=proj.r2_max,
                ext_x=proj.ext_x, ext_y=proj.ext_y, conics=proj.conics,
                tau=proj.tau)


@pytest.mark.parametrize("seed,tile_size,spread,scale_mean,window", [
    (0, 16, 1.0, -2.3, None),
    (1, 32, 1.0, -2.3, None),
    (2, 16, 0.5, -2.0, None),
    (3, 32, 1.5, -1.6, None),
    (4, 16, 0.8, -2.3, (1, 2)),
])
def test_stream_matches_jax(seed, tile_size, spread, scale_mean, window):
    width, height = 96, 72
    proj = _projected(seed, 400, width, height, spread, scale_mean)
    row0, rows = window if window else (0, None)
    ref = _jax_binning(proj, width, height, tile_size, window)
    assert int(jnp.max(ref.level_overflow, initial=0)) == 0

    def t(a):
        return torch.from_numpy(np.array(a))

    out = tbin(t(proj.means2d), t(proj.depths), t(proj.radii), t(proj.valid),
               t(proj.conics), t(proj.tau), t(proj.ext_x), t(proj.ext_y),
               width, height, tile_size, row0, rows)
    total = int(ref.total)
    assert total > 0
    assert out.total == total
    assert (out.num_tiles_x, out.num_tiles_y) == (ref.num_tiles_x,
                                                  ref.num_tiles_y)
    np.testing.assert_array_equal(out.tile_starts.numpy(),
                                  np.asarray(ref.tile_starts))
    np.testing.assert_array_equal(out.tile_ends.numpy(),
                                  np.asarray(ref.tile_ends))
    np.testing.assert_array_equal(out.gaussian_ids.numpy(),
                                  np.asarray(ref.gaussian_ids)[:total])
