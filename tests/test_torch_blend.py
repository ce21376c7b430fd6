"""Port parity: the plain forward tile blend of `gaussianavatars_torch`
against the JAX package's jnp blend and its Pallas kernel
`blend_image_fwd_pallas` (interpret mode on the CPU, chunk 8 as
tests/test_blend_pallas.py runs it), on the same instance stream.
Tolerance atol 1e-5 (float32 transmittance products in another order).
Kernel K1 itself is held against the plain version on the card by
chip_smoke.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianavatars_tpu.ops import blend_pallas
from gaussianavatars_tpu.ops import tile_blend as jblend
from gaussianavatars_tpu.ops.binning_dense import bin_gaussians_dense
from gaussianavatars_tpu.ops.instance_pack import gather_instances, pack_projected
from gaussianavatars_tpu.ops.projection import project_gaussians
from gaussianavatars_torch.ops import tile_blend as tblend

from .utils import make_camera, make_scene

ATOL = 1e-5
WIDTH, HEIGHT = 48, 40

# (tile_size, seed, spread, scale_mean, opacity, tile-row window)
CASES = {
    "tile16": (16, 0, 1.0, -2.3, None, None),
    "tile32": (32, 4, 1.0, -2.3, None, None),
    "early_out": (16, 9, 0.2, -1.2, 0.995, None),
    "slab": (16, 2, 1.0, -2.0, None, (1, 2)),
}


@functools.partial(jax.jit, static_argnums=(1, 2))
def _jax_stream(scene, tile_size, window):
    """JAX projection -> dense binning -> (16, K) stream + float ranges."""
    cam = make_camera(width=WIDTH, height=HEIGHT)
    proj = project_gaussians(scene["means3d"], scene["scales"],
                             scene["quats"], scene["opacities"],
                             scene["shs"], 2, cam)
    row0, rows = window if window else (0, None)
    b = bin_gaussians_dense(
        proj.means2d, proj.depths, proj.radii, proj.valid, WIDTH, HEIGHT,
        tile_size, tile_row_start=row0, tile_rows=rows,
        means2d_cull=proj.means2d, r2_max=proj.r2_max, ext_x=proj.ext_x,
        ext_y=proj.ext_y, conics=proj.conics, tau=proj.tau)
    pack = pack_projected(proj.means2d, proj.conics, proj.colors,
                          proj.opacities)
    inst = gather_instances(pack, b.gaussian_ids, b.instance_valid)
    ranges = jnp.stack([b.tile_starts, b.tile_ends], -1).astype(jnp.float32)
    return inst, ranges, b.total


def _case(name):
    tile_size, seed, spread, scale_mean, opacity, window = CASES[name]
    scene = make_scene(n=128, seed=seed, spread=spread, scale_mean=scale_mean)
    if opacity is not None:
        scene["opacities"] = jnp.full_like(scene["opacities"], opacity)
    inst, ranges, total = _jax_stream(scene, tile_size, window)
    total = int(total)
    row0, rows = window if window else (0, None)
    height = HEIGHT if rows is None else rows * tile_size
    port_inst = torch.from_numpy(np.ascontiguousarray(
        np.asarray(inst)[:9, :total].T))
    port_ranges = torch.from_numpy(np.asarray(ranges).astype(np.int32))
    return dict(inst=inst, ranges=ranges, total=total, tile_size=tile_size,
                py_offset=row0 * tile_size, height=height,
                port_inst=port_inst, port_ranges=port_ranges)


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_jax(name):
    c = _case(name)
    assert c["total"] > 0
    color, trans = tblend.blend_image(
        c["port_inst"], c["port_ranges"], c["py_offset"], WIDTH, c["height"],
        c["tile_size"])
    assert color.shape == (3, c["height"], WIDTH)
    ref_jnp = jblend.blend_image(
        c["inst"], c["ranges"], jnp.int32(c["py_offset"]), WIDTH, c["height"],
        c["tile_size"], 8, "jnp")
    ref_pallas = blend_pallas.blend_image_fwd_pallas(
        c["inst"], c["ranges"], WIDTH, c["height"], c["tile_size"], 8,
        jnp.int32(c["py_offset"]))
    for ref, backend in ((ref_jnp, "jnp"), (ref_pallas, "pallas")):
        np.testing.assert_allclose(color.numpy(), np.asarray(ref[0]),
                                   atol=ATOL, rtol=0, err_msg=backend)
        np.testing.assert_allclose(trans.numpy(), np.asarray(ref[1]),
                                   atol=ATOL, rtol=0, err_msg=backend)
    if name == "early_out":
        assert float(trans.min()) < 1e-3     # the T < 1e-4 stop was reached


def test_plain_counts_work():
    c = _case("early_out")
    (color, trans), work = tblend.blend_image_plain(
        c["port_inst"], c["port_ranges"], 0, WIDTH, HEIGHT, c["tile_size"],
        count_work=True)
    ref = tblend.blend_image_plain(c["port_inst"], c["port_ranges"], 0,
                                   WIDTH, HEIGHT, c["tile_size"])
    assert torch.equal(color, ref[0]) and torch.equal(trans, ref[1])
    counts = (c["port_ranges"][:, 1] - c["port_ranges"][:, 0]).long()
    no_early_out = int((counts * c["tile_size"] ** 2).sum())
    assert 0 < work["blended"] <= work["exps"] <= work["pairs"] < no_early_out


def test_blend_rejects_unknown_device():
    inst = torch.zeros((0, 9), device="meta")
    with pytest.raises(ValueError):
        tblend.blend_image(inst, torch.zeros((1, 2), dtype=torch.int32,
                                             device="meta"), 0, 16, 16, 16)


def test_kernel_wrapper_refuses_cpu_tensors():
    c = _case("tile16")
    with pytest.raises(ValueError):
        tblend.blend_image_cuda(c["port_inst"], c["port_ranges"], 0, WIDTH,
                                HEIGHT, 16)
    assert tblend.blend_image_cuda.launches == 0
