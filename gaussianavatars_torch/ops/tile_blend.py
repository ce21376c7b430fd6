"""Per-tile front-to-back alpha blending and its VJP (port of
`gaussianavatars_tpu/ops/tile_blend.py`).

`blend_image` takes the (K, 9) instance stream of ops/instance_pack.py and
the per-tile [start, end) ranges of ops/binning_dense.py, through the
autograd function `BlendImage`. On a CUDA tensor the forward is kernel K1
(`csrc/blend_fwd.cu`, the port of `blend_pallas.py::blend_image_fwd_pallas`)
and the backward kernel K2 (`csrc/blend_bwd.cu`, the port of
`blend_pallas.py::blend_image_bwd_pallas`); on a CPU tensor both are the
plain PyTorch versions below. Nothing falls back from one to the other.

Semantics (the reference CUDA rasterizer's, as `_blend_tile_fwd` in the
JAX package): pixel coordinates are integer pixel indices (no +0.5);
power = -1/2 (cxx dx^2 + cyy dy^2) - cxy dx dy with d = mean2d - pixel;
an instance is skipped when power > 0 or e = opacity exp(power) < 1/255;
alpha = min(0.99, e); a pixel stops before the instance that would take
its transmittance T below 1e-4 (the reference's `done` flag).

Gradient semantics (the blueprint's `_blend_tile_bwd`): the backward walks
each tile front to back again with the forward's carries. With G the color
cotangent, C_out and T_out the forward outputs, g_T the T cotangent and
S_incl the inclusive prefix of (c . G) w over the blended instances,
  d_alpha = (c . G) T_before - (G . C_out + g_T T_out - S_incl) / (1 - alpha)
(the suffix sum of the back-to-front walk is G . C_out minus the forward
prefix). d_alpha is zero where the 0.99 clamp is active and for instances
that are rejected or come after the pixel stops; d_opacity = d_alpha
exp(power), and mean2d and conic take d_power = d_alpha alpha times the
partials of the quadratic. The gradient is one (K, 9) row per stream slot,
in the stream's column layout.

Below the tile, both kernels cull per warp: each warp owns a patch of the
tile (`PATCH_SHAPE`) and skips the instances that the exact ellipse-box
test of the binning, widened by `CULL_ABS` and `CULL_REL`, shows no pixel
of the patch can accept. `patch_cull_plain` is that test in PyTorch, and
`cull=True` applies it in the plain versions: it changes no bit of their
results.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from gaussianavatars_torch import kernels
from gaussianavatars_torch.ops.binning_dense import _box_qmin, tile_grid
from gaussianavatars_torch.ops.instance_pack import PACK_COLS

ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4
# The kernels' cull (csrc/blend_common.cuh): a warp skips an instance when
# the least q = d^T conic d over its patch's box exceeds
# tau + CULL_ABS + CULL_REL * mag, tau = 2 ln(255 opacity) and mag the
# largest value the quadratic's terms take in the box.
CULL_ABS = 1e-4
CULL_REL = 1e-5
PATCH_SHAPE = (8, 4)    # a warp's patch of the tile: width, height


def blend_image(inst, ranges, py_offset: int, width: int, height: int,
                tile_size: int):
    """Blend the sorted instance stream into an image (differentiable in
    `inst`; `ranges` and `py_offset` get no gradient).

    Args:
      inst: (K, 9) float32 instance stream (ops/instance_pack.py layout).
      ranges: (T, 2) int32 [start, end) per tile, T = ntx * nty over the
        slab, tiles row-major.
      py_offset: global pixel row of the slab's first row.
      width/height: slab size in pixels; tile_size: 16 or 32.

    Returns:
      (color [3, height, width] without background, T [height, width]).
    """
    return BlendImage.apply(inst, ranges, py_offset, width, height,
                            tile_size)


def _route(inst, cuda_fn, plain_fn):
    if inst.device.type == "cuda":
        return cuda_fn
    if inst.device.type == "cpu":
        return plain_fn
    raise ValueError(f"no blend for device {inst.device}")


class BlendImage(torch.autograd.Function):
    """K1 forward and K2 backward on CUDA tensors, the plain versions on
    CPU tensors."""

    @staticmethod
    def forward(ctx, inst, ranges, py_offset, width, height, tile_size):
        fwd = _route(inst, blend_image_cuda, blend_image_plain)
        color, trans = fwd(inst, ranges, py_offset, width, height, tile_size)
        ctx.save_for_backward(inst, ranges, color, trans)
        ctx.static = (py_offset, width, height, tile_size)
        return color, trans

    @staticmethod
    def backward(ctx, g_color, g_trans):
        inst, ranges, color, trans = ctx.saved_tensors
        bwd = _route(inst, blend_image_bwd_cuda, blend_image_bwd_plain)
        # autograd may hand over expanded cotangents (g_T of the
        # `trans * bg` composite)
        g_inst = bwd(inst, ranges, *ctx.static, color, trans,
                     g_color.contiguous(), g_trans.contiguous())
        return g_inst, None, None, None, None, None


# ----------------------------------------------------------------------------
# Kernel K1
# ----------------------------------------------------------------------------

def _check_stream(inst, ranges, width, height, tile_size):
    """Raise unless the kernels can take this stream; returns the grid."""
    ntx, nty = tile_grid(width, height, tile_size)
    if not (inst.is_cuda and ranges.device == inst.device):
        raise ValueError("inst and ranges must be CUDA tensors on one device")
    if inst.dtype != torch.float32 or inst.ndim != 2 \
            or inst.shape[1] != PACK_COLS or not inst.is_contiguous():
        raise ValueError(f"inst must be contiguous float32 (K, {PACK_COLS}), "
                         f"got {inst.dtype} {tuple(inst.shape)}")
    if ranges.dtype != torch.int32 or tuple(ranges.shape) != (ntx * nty, 2) \
            or not ranges.is_contiguous():
        raise ValueError(f"ranges must be contiguous int32 ({ntx * nty}, 2), "
                         f"got {ranges.dtype} {tuple(ranges.shape)}")
    if tile_size not in (16, 32):
        raise ValueError(f"tile_size must be 16 or 32, got {tile_size}")
    if inst.data_ptr() % 16:
        raise ValueError("inst must be 16-byte aligned (the kernels stage "
                         "it by bulk copies)")
    return ntx, nty


def _blend_fwd_fn(lib):
    fn = (lib or kernels.load("blend_fwd")).blend_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def blend_image_cuda(inst, ranges, py_offset: int, width: int, height: int,
                     tile_size: int, *, lib=None):
    """`blend_image` on the GPU through kernel K1 (one launch).

    `lib` is another build of the kernel library (the counting build,
    another source directory's); the render path passes none.
    `blend_image_cuda.launches` counts the launches.
    """
    ntx, nty = _check_stream(inst, ranges, width, height, tile_size)
    fn = _blend_fwd_fn(lib)
    color = torch.empty((3, height, width), dtype=torch.float32,
                        device=inst.device)
    trans = torch.empty((height, width), dtype=torch.float32,
                        device=inst.device)
    with torch.cuda.device(inst.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(inst.data_ptr(), ranges.data_ptr(), ntx * nty, ntx, width,
                 height, tile_size, int(py_offset), color.data_ptr(),
                 trans.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"blend_fwd kernel launch failed: CUDA error {err}")
    blend_image_cuda.launches += 1
    return color, trans


blend_image_cuda.launches = 0


# ----------------------------------------------------------------------------
# Kernel K2
# ----------------------------------------------------------------------------

def _blend_bwd_fn(lib):
    fn = (lib or kernels.load("blend_bwd")).blend_bwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def blend_image_bwd_cuda(inst, ranges, py_offset: int, width: int,
                         height: int, tile_size: int, color, trans, g_color,
                         g_trans, *, lib=None):
    """`blend_image`'s VJP on the GPU through kernel K2 (one launch).

    Returns the (K, 9) per-slot gradient; slots no pixel blended stay 0.
    `lib` as in `blend_image_cuda`.
    `blend_image_bwd_cuda.launches` counts the launches.
    """
    ntx, nty = _check_stream(inst, ranges, width, height, tile_size)
    for name, t, shape in (("color", color, (3, height, width)),
                           ("trans", trans, (height, width)),
                           ("g_color", g_color, (3, height, width)),
                           ("g_trans", g_trans, (height, width))):
        if t.device != inst.device or t.dtype != torch.float32 \
                or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32 {shape} on "
                             f"{inst.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    fn = _blend_bwd_fn(lib)
    grad = torch.zeros_like(inst)
    with torch.cuda.device(inst.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(inst.data_ptr(), ranges.data_ptr(), ntx * nty, ntx, width,
                 height, tile_size, int(py_offset), color.data_ptr(),
                 trans.data_ptr(), g_color.data_ptr(), g_trans.data_ptr(),
                 grad.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"blend_bwd kernel launch failed: CUDA error {err}")
    blend_image_bwd_cuda.launches += 1
    return grad


blend_image_bwd_cuda.launches = 0


# ----------------------------------------------------------------------------
# Plain version
# ----------------------------------------------------------------------------

def blend_image_plain(inst, ranges, py_offset: int, width: int, height: int,
                      tile_size: int, count_work: bool = False,
                      cull: bool = False):
    """`blend_image` in plain PyTorch on any device, batched over tiles.

    Walks instance position j = 0, 1, ... of every tile's range at once
    ([T, P] tensors), in the same order and with the same rounding as
    kernel K1 (sequential transmittance products, no fused multiply-add in
    the quadratic). With `count_work` it also returns the work these
    inputs need, for the kernel's roofline bound: pixel-instance pairs
    evaluated before each pixel stops (`pairs`), those with power <= 0 that
    need an exp (`exps`) and those blended (`blended`). With `cull` the
    pixels of a patch skip the instances `patch_cull_plain` drops for it,
    as the kernels' warps do; the result is the same bit for bit.
    """
    g = _TileGrid(inst, ranges, py_offset, width, height, tile_size)
    trans = torch.ones((g.num_tiles, g.p), dtype=torch.float32,
                       device=inst.device)
    color = torch.zeros((g.num_tiles, 3, g.p), dtype=torch.float32,
                        device=inst.device)
    done = g.outside.clone()
    work = {"pairs": 0, "exps": 0, "blended": 0}
    for j in range(g.max_count):
        if j % 64 == 0 and bool(done.all()):
            break
        s = g.step(j, trans, done, cull)
        color = color + s.rows[:, 5:8, None] * s.w[:, None, :]
        trans = torch.where(s.blend, s.test_t, trans)
        done = done | s.stop
        if count_work:
            _count(work, s)

    out = (g.untile(color), g.untile(trans[:, None])[0])
    return (out, work) if count_work else out


def blend_image_bwd_plain(inst, ranges, py_offset: int, width: int,
                          height: int, tile_size: int, color, trans, g_color,
                          g_trans, count_work: bool = False,
                          cull: bool = False):
    """`blend_image`'s VJP in plain PyTorch on any device: the (K, 9)
    per-slot gradient (port of the blueprint's `_blend_image_bwd`).

    Walks instance position j of every tile's range at once, front to
    back, re-deciding every accept, reject and stop as the forward did (so
    the same rounding as kernels K1 and K2), carrying T and the inclusive
    prefix S_incl. `count_work` also returns the work these inputs need,
    and `cull` applies the kernels' patch cull, as in `blend_image_plain`.
    """
    g = _TileGrid(inst, ranges, py_offset, width, height, tile_size)
    out_c, out_t = g.retile(color), g.retile(trans[None])[:, 0]
    g_c, g_t = g.retile(g_color), g.retile(g_trans[None])[:, 0]
    s_rest = (g_c * out_c).sum(1) + g_t * out_t        # G . C_out + g_T T_out
    grad = torch.zeros_like(inst)
    trans_t = torch.ones_like(out_t)
    s_incl = torch.zeros_like(out_t)
    done = g.outside.clone()
    work = {"pairs": 0, "exps": 0, "blended": 0}
    for j in range(g.max_count):
        if j % 64 == 0 and bool(done.all()):
            break
        s = g.step(j, trans_t, done, cull)
        r = s.rows
        cg = (r[:, 5:8, None] * g_c).sum(1)                       # [T, P]
        s_incl = s_incl + cg * s.w
        d_alpha = torch.where(
            s.blend & (s.e < ALPHA_MAX),
            cg * trans_t - (s_rest - s_incl) / (1.0 - s.alpha),
            torch.zeros_like(trans_t))
        d_power = d_alpha * s.alpha
        dx, dy = s.dx, s.dy
        cxx, cxy, cyy = r[:, 2:3], r[:, 3:4], r[:, 4:5]
        rows_grad = torch.stack([
            (d_power * -(cxx * dx + cxy * dy)).sum(1),
            (d_power * -(cyy * dy + cxy * dx)).sum(1),
            (d_power * (-0.5 * dx * dx)).sum(1),
            (d_power * (-dx * dy)).sum(1),
            (d_power * (-0.5 * dy * dy)).sum(1),
            *(s.w[:, None, :] * g_c).sum(2).unbind(1),
            (d_alpha * s.ex).sum(1),
        ], dim=1)                                                  # [T, 9]
        walked = j < g.counts
        grad[(g.starts + j)[walked]] = rows_grad[walked]
        trans_t = torch.where(s.blend, s.test_t, trans_t)
        done = done | s.stop
        if count_work:
            _count(work, s)
    return (grad, work) if count_work else grad


def patch_cull_plain(inst, ranges, py_offset: int, width: int, height: int,
                     tile_size: int, patch_w: int | None = None,
                     patch_h: int | None = None):
    """The kernels' per-warp cull in plain PyTorch (float32, the formula
    and margin of `csrc/blend_common.cuh::patch_culled`).

    Returns bool [T, patches, max_count]: True where the patch (patches
    row-major over the tile, `PATCH_SHAPE` unless given) keeps
    position j of the tile's range, False where it culls it and past the
    range's end.
    """
    g = _TileGrid(inst, ranges, py_offset, width, height, tile_size,
                  patch_w, patch_h)
    keep = [g.patch_keep(g.rows(j)) & (j < g.counts)[:, None]
            for j in range(g.max_count)]
    if not keep:
        return torch.zeros((g.num_tiles, g.num_patches, 0), dtype=torch.bool,
                           device=inst.device)
    return torch.stack(keep, dim=-1)


class _Step(NamedTuple):
    """Instance position j of every tile against the tile's pixels."""

    rows: torch.Tensor    # [T, 9] the instance (clamped past the range)
    dx: torch.Tensor      # [T, P] mean2d - pixel
    dy: torch.Tensor
    power: torch.Tensor
    ex: torch.Tensor      # exp(min(power, 0))
    e: torch.Tensor       # opacity * ex
    alpha: torch.Tensor   # min(0.99, e)
    live: torch.Tensor    # in range and the pixel not stopped
    test_t: torch.Tensor  # T (1 - alpha)
    stop: torch.Tensor    # accepted, and would take T below 1e-4
    blend: torch.Tensor   # accepted and blended
    w: torch.Tensor       # alpha T where blended, else 0


class _TileGrid:
    """Pixel coordinates and ranges of every tile, [T, P] batched."""

    def __init__(self, inst, ranges, py_offset, width, height, tile_size,
                 patch_w=None, patch_h=None):
        dev = inst.device
        self.inst = inst
        self.width, self.height, self.ts = width, height, tile_size
        self.ntx, self.nty = tile_grid(width, height, tile_size)
        self.num_tiles, self.p = self.ntx * self.nty, tile_size * tile_size
        ly, lx = torch.meshgrid(torch.arange(tile_size, device=dev),
                                torch.arange(tile_size, device=dev),
                                indexing="ij")
        tiles = torch.arange(self.num_tiles, device=dev)
        xs = (tiles % self.ntx * tile_size)[:, None] + lx.reshape(1, self.p)
        ys = (tiles // self.ntx * tile_size)[:, None] + ly.reshape(1, self.p)
        self.px = xs.to(torch.float32)
        self.py = (ys + py_offset).to(torch.float32)
        self.outside = ~((xs < width) & (ys < height))
        self.starts = ranges[:, 0].long()
        self.counts = (ranges[:, 1] - ranges[:, 0]).long()
        self.max_count = int(self.counts.max()) if self.num_tiles else 0
        # the patches of a tile, row-major; their boxes are pixel centres,
        # inclusive, and are not clipped to the image
        pw, ph = patch_w or PATCH_SHAPE[0], patch_h or PATCH_SHAPE[1]
        self.num_patches = (tile_size // pw) * (tile_size // ph)
        self.patch_of_pixel = ((ly // ph) * (tile_size // pw)
                               + lx // pw).reshape(self.p)
        first = torch.stack([torch.argmax((self.patch_of_pixel == k).int())
                             for k in range(self.num_patches)])
        self.box_x_lo, self.box_y_lo = self.px[:, first], self.py[:, first]
        self.box_x_hi = self.box_x_lo + (pw - 1)
        self.box_y_hi = self.box_y_lo + (ph - 1)

    def rows(self, j):
        """[T, 9] position j of every tile's range (clamped past it)."""
        return self.inst[torch.clamp(self.starts + j,
                                     max=self.inst.shape[0] - 1)]

    def patch_keep(self, rows):
        """[T, patches] False where a patch's box holds no pixel the
        decision path could accept for the tile's instance `rows`."""
        mx, my = rows[:, 0:1], rows[:, 1:2]
        cxx, cxy, cyy = rows[:, 2:3], rows[:, 3:4], rows[:, 4:5]
        ax, bx = self.box_x_lo - mx, self.box_x_hi - mx
        ay, by = self.box_y_lo - my, self.box_y_hi - my
        tau = 2.0 * torch.log(255.0 * rows[:, 8:9])
        ex = torch.maximum(ax.abs(), bx.abs())
        ey = torch.maximum(ay.abs(), by.abs())
        mag = cxx * ex * ex + cyy * ey * ey + 2.0 * cxy.abs() * ex * ey
        limit = tau + CULL_ABS + CULL_REL * mag
        rx = -cxy / torch.clamp(cyy, min=1e-12)
        ry = -cxy / torch.clamp(cxx, min=1e-12)
        qmin = _box_qmin(ax, bx, ay, by, cxx, cxy, cyy, rx, ry)
        return ~((cxx > 0.0) & (cyy > 0.0) & (qmin > limit))

    def step(self, j, trans, done, cull=False) -> _Step:
        live = (j < self.counts)[:, None] & ~done
        rows = self.rows(j)
        if cull:
            live = live & self.patch_keep(rows)[:, self.patch_of_pixel]
        mx, my = rows[:, 0:1], rows[:, 1:2]
        cxx, cxy, cyy = rows[:, 2:3], rows[:, 3:4], rows[:, 4:5]
        dx = mx - self.px
        dy = my - self.py
        power = -0.5 * (cxx * dx * dx + cyy * dy * dy) - cxy * dx * dy
        ex = torch.exp(torch.clamp(power, max=0.0))
        e = rows[:, 8:9] * ex
        alpha = torch.clamp(e, max=ALPHA_MAX)
        ok = live & (power <= 0.0) & (e >= ALPHA_MIN)
        test_t = trans * (1.0 - alpha)
        stop = ok & (test_t < T_EPS)
        blend = ok & ~stop
        w = torch.where(blend, alpha * trans, torch.zeros_like(trans))
        return _Step(rows, dx, dy, power, ex, e, alpha, live, test_t, stop,
                     blend, w)

    def untile(self, x):
        """[T, c, P] -> [c, height, width]."""
        c, ts = x.shape[1], self.ts
        img = x.reshape(self.nty, self.ntx, c, ts, ts).permute(
            2, 0, 3, 1, 4).reshape(c, self.nty * ts, self.ntx * ts)
        return img[:, :self.height, :self.width].contiguous()

    def retile(self, img):
        """[c, height, width] -> [T, c, P], zero past the image edges."""
        c, ts = img.shape[0], self.ts
        img = torch.nn.functional.pad(
            img, (0, self.ntx * ts - self.width, 0, self.nty * ts - self.height))
        return img.reshape(c, self.nty, ts, self.ntx, ts).permute(
            1, 3, 0, 2, 4).reshape(self.num_tiles, c, self.p)


def _count(work, s: _Step):
    work["pairs"] += int(s.live.sum())
    work["exps"] += int((s.live & (s.power <= 0.0)).sum())
    work["blended"] += int(s.blend.sum())
