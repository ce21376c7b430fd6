"""Port parity of the tile blend's backward: `blend_image_bwd_plain` (and
`blend_image` through its autograd function) against `jax.vjp` of the JAX
package's `blend_image` with the jnp backend and with the Pallas kernel
`blend_image_bwd_pallas` (interpret mode on the CPU, chunk 8, as
tests/test_blend_pallas.py runs it), on the same instance stream and the
same random cotangents. Gate: max|d| / max|ref| <= 1e-4 per gradient
column, the JAX package's own backward gate between its backends
(tests/test_blend_pallas.py). Kernel K2 itself is held against the plain
version on the card by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianavatars_tpu.ops import tile_blend as jblend
from gaussianavatars_torch.benchmark import make_camera as port_camera
from gaussianavatars_torch.ops import tile_blend as tblend
from gaussianavatars_torch.ops.rasterize_tiles import rasterize

from .test_torch_blend import (  # noqa: F401
    CASES, HEIGHT, WIDTH, _case, one_torch_thread,
)
from .utils import make_scene

REL = 1e-4
COLUMNS = ("mean_x", "mean_y", "conic_xx", "conic_xy", "conic_yy",
           "color_r", "color_g", "color_b", "opacity")


def _cotangents(height, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(3, height, WIDTH)).astype(np.float32),
            rng.normal(size=(height, WIDTH)).astype(np.float32))


def _jax_vjp(c, g_color, g_trans, backend):
    def f(inst):
        return jblend.blend_image(inst, c["ranges"], jnp.int32(c["py_offset"]),
                                  WIDTH, c["height"], c["tile_size"], 8,
                                  backend)

    _, vjp = jax.vjp(f, c["inst"])
    (d_inst,) = vjp((jnp.asarray(g_color), jnp.asarray(g_trans)))
    return np.asarray(d_inst)[:9, :c["total"]].T


def _assert_columns_close(got, ref, what):
    for j, name in enumerate(COLUMNS):
        scale = max(float(np.abs(ref[:, j]).max()), 1e-12)
        rel = float(np.abs(got[:, j] - ref[:, j]).max()) / scale
        assert rel <= REL, f"{what} {name}: max|d|/max|ref| {rel:.2e}"


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_bwd_matches_jax(name):
    c = _case(name)
    g_color, g_trans = _cotangents(c["height"], seed=len(name))
    inst = c["port_inst"].clone().requires_grad_()
    color, trans = tblend.blend_image(
        inst, c["port_ranges"], c["py_offset"], WIDTH, c["height"],
        c["tile_size"])
    (torch.sum(color * torch.from_numpy(g_color))
     + torch.sum(trans * torch.from_numpy(g_trans))).backward()
    got = inst.grad.numpy()
    direct = tblend.blend_image_bwd_plain(
        c["port_inst"], c["port_ranges"], c["py_offset"], WIDTH, c["height"],
        c["tile_size"], color.detach(), trans.detach(),
        torch.from_numpy(g_color), torch.from_numpy(g_trans))
    np.testing.assert_array_equal(got, direct.numpy())
    assert np.abs(got).max() > 0
    for backend in ("jnp", "pallas"):
        _assert_columns_close(got, _jax_vjp(c, g_color, g_trans, backend),
                              f"{name} vs {backend}")


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_bwd_matches_autograd_of_plain_fwd(name):
    """An independent derivation: autograd through the plain forward's
    sequential walk (its decisions fixed, its T products differentiated)."""
    c = _case(name)
    g_color, g_trans = _cotangents(c["height"], seed=7 + len(name))
    inst = c["port_inst"].clone().requires_grad_()
    color, trans = tblend.blend_image_plain(
        inst, c["port_ranges"], c["py_offset"], WIDTH, c["height"],
        c["tile_size"])
    (torch.sum(color * torch.from_numpy(g_color))
     + torch.sum(trans * torch.from_numpy(g_trans))).backward()
    got = tblend.blend_image_bwd_plain(
        c["port_inst"], c["port_ranges"], c["py_offset"], WIDTH, c["height"],
        c["tile_size"], color.detach(), trans.detach(),
        torch.from_numpy(g_color), torch.from_numpy(g_trans))
    _assert_columns_close(got.numpy(), inst.grad.numpy(), name)


def test_bwd_zero_past_the_stop_and_counts_work():
    c = _case("early_out")
    color, trans = tblend.blend_image_plain(
        c["port_inst"], c["port_ranges"], 0, WIDTH, HEIGHT, c["tile_size"])
    g_color, g_trans = _cotangents(HEIGHT, seed=3)
    grad, work = tblend.blend_image_bwd_plain(
        c["port_inst"], c["port_ranges"], 0, WIDTH, HEIGHT, c["tile_size"],
        color, trans, torch.from_numpy(g_color), torch.from_numpy(g_trans),
        count_work=True)
    _, fwd_work = tblend.blend_image_plain(
        c["port_inst"], c["port_ranges"], 0, WIDTH, HEIGHT, c["tile_size"],
        count_work=True)
    assert work == fwd_work
    # opacity 0.995 saturates every covered pixel: the deep slots of each
    # tile are never walked and keep a zero gradient
    zero_rows = (grad == 0).all(dim=1)
    assert 0 < int(zero_rows.sum()) < grad.shape[0]


def test_bwd_wrapper_refuses_cpu_tensors():
    c = _case("tile16")
    color = torch.zeros(3, HEIGHT, WIDTH)
    trans = torch.ones(HEIGHT, WIDTH)
    with pytest.raises(ValueError):
        tblend.blend_image_bwd_cuda(c["port_inst"], c["port_ranges"], 0,
                                    WIDTH, HEIGHT, 16, color, trans, color,
                                    trans)
    assert tblend.blend_image_bwd_cuda.launches == 0


@pytest.mark.parametrize("tile_size", [16, 32])
def test_gradients_finite_behind_camera_and_degenerate(tile_size):
    """Gaussians behind the camera (culled, z <= 0.2) and with degenerate
    (zero-area) covariances take finite, zero-or-real gradients through
    the whole rasterizer."""
    scene = {k: np.array(v) for k, v in make_scene(n=96, seed=5).items()}
    scene["means3d"][:12, 2] = -5.0          # behind the camera at z = -4
    scene["scales"][12:24] = 1e-12           # collapsed covariance
    scene["scales"][24:30, 0] = 1e-12        # one flat axis
    cam = port_camera(width=WIDTH, height=HEIGHT, device="cpu")
    t = {k: torch.from_numpy(np.ascontiguousarray(v)).requires_grad_()
         for k, v in scene.items()}
    offset = torch.zeros((96, 2), requires_grad=True)
    out = rasterize(t["means3d"], t["scales"], t["quats"], t["opacities"],
                    t["shs"], 2, cam, torch.ones(3), tile_size=tile_size,
                    means2d_offset=offset)
    assert out.instance_total > 0
    w = torch.from_numpy(np.random.default_rng(0).normal(
        size=(3, HEIGHT, WIDTH)).astype(np.float32))
    (torch.sum(out.image * w) + torch.sum(out.transmittance ** 2)).backward()
    for k, v in t.items():
        assert torch.isfinite(v.grad).all(), k
    assert torch.isfinite(offset.grad).all()
    assert not out.visibility[:12].any()
    assert (offset.grad[:12] == 0).all()
    assert (t["means3d"].grad[:12] == 0).all()
    assert float(offset.grad.abs().max()) > 0
