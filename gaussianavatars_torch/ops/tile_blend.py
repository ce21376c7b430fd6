"""Per-tile front-to-back alpha blending, forward (port of
`gaussianavatars_tpu/ops/tile_blend.py`; its backward comes with the
training path).

`blend_image` takes the (K, 9) instance stream of ops/instance_pack.py and
the per-tile [start, end) ranges of ops/binning_dense.py. A CUDA tensor
goes to kernel K1 (`csrc/blend_fwd.cu`, the port of
`blend_pallas.py::blend_image_fwd_pallas`); a CPU tensor goes to the plain
PyTorch version below. Nothing falls back from one to the other.

Semantics (the reference CUDA rasterizer's, as `_blend_tile_fwd` in the
JAX package): pixel coordinates are integer pixel indices (no +0.5);
power = -1/2 (cxx dx^2 + cyy dy^2) - cxy dx dy with d = mean2d - pixel;
an instance is skipped when power > 0 or e = opacity exp(power) < 1/255;
alpha = min(0.99, e); a pixel stops before the instance that would take
its transmittance T below 1e-4 (the reference's `done` flag).
"""

from __future__ import annotations

import ctypes

import torch

from gaussianavatars_torch import kernels
from gaussianavatars_torch.ops.binning_dense import tile_grid
from gaussianavatars_torch.ops.instance_pack import PACK_COLS

ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4


def blend_image(inst, ranges, py_offset: int, width: int, height: int,
                tile_size: int):
    """Blend the sorted instance stream into an image.

    Args:
      inst: (K, 9) float32 instance stream (ops/instance_pack.py layout).
      ranges: (T, 2) int32 [start, end) per tile, T = ntx * nty over the
        slab, tiles row-major.
      py_offset: global pixel row of the slab's first row.
      width/height: slab size in pixels; tile_size: 16 or 32.

    Returns:
      (color [3, height, width] without background, T [height, width]).
    """
    if inst.device.type == "cuda":
        return blend_image_cuda(inst, ranges, py_offset, width, height,
                                tile_size)
    if inst.device.type == "cpu":
        return blend_image_plain(inst, ranges, py_offset, width, height,
                                 tile_size)
    raise ValueError(f"no blend for device {inst.device}")


# ----------------------------------------------------------------------------
# Kernel K1
# ----------------------------------------------------------------------------

def _blend_fwd_lib():
    lib = kernels.load("blend_fwd")
    fn = lib.blend_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def blend_image_cuda(inst, ranges, py_offset: int, width: int, height: int,
                     tile_size: int):
    """`blend_image` on the GPU through kernel K1 (one launch).

    `blend_image_cuda.launches` counts the launches.
    """
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
    fn = _blend_fwd_lib()
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
# Plain version
# ----------------------------------------------------------------------------

def blend_image_plain(inst, ranges, py_offset: int, width: int, height: int,
                      tile_size: int, count_work: bool = False):
    """`blend_image` in plain PyTorch on any device, batched over tiles.

    Walks instance position j = 0, 1, ... of every tile's range at once
    ([T, P] tensors), in the same order and with the same rounding as
    kernel K1 (sequential transmittance products, no fused multiply-add in
    the quadratic). With `count_work` it also returns the work these
    inputs need, for the kernel's roofline bound: pixel-instance pairs
    evaluated before each pixel stops (`pairs`), those with power <= 0 that
    need an exp (`exps`) and those blended (`blended`).
    """
    dev = inst.device
    ntx, nty = tile_grid(width, height, tile_size)
    num_tiles, p = ntx * nty, tile_size * tile_size
    ly, lx = torch.meshgrid(torch.arange(tile_size, device=dev),
                            torch.arange(tile_size, device=dev),
                            indexing="ij")
    tiles = torch.arange(num_tiles, device=dev)
    xs = (tiles % ntx * tile_size)[:, None] + lx.reshape(1, p)
    ys = (tiles // ntx * tile_size)[:, None] + ly.reshape(1, p)
    px = xs.to(torch.float32)
    py = (ys + py_offset).to(torch.float32)

    starts = ranges[:, 0].long()
    counts = (ranges[:, 1] - ranges[:, 0]).long()
    max_count = int(counts.max()) if num_tiles else 0

    trans = torch.ones((num_tiles, p), dtype=torch.float32, device=dev)
    color = torch.zeros((num_tiles, 3, p), dtype=torch.float32, device=dev)
    done = ~((xs < width) & (ys < height))
    work = {"pairs": 0, "exps": 0, "blended": 0}
    for j in range(max_count):
        if j % 64 == 0 and bool(done.all()):
            break
        live = (j < counts)[:, None] & ~done                      # [T, P]
        rows = inst[torch.clamp(starts + j, max=inst.shape[0] - 1)]  # [T, 9]
        mx, my = rows[:, 0:1], rows[:, 1:2]
        cxx, cxy, cyy = rows[:, 2:3], rows[:, 3:4], rows[:, 4:5]
        dx = mx - px
        dy = my - py
        power = -0.5 * (cxx * dx * dx + cyy * dy * dy) - cxy * dx * dy
        e = rows[:, 8:9] * torch.exp(torch.clamp(power, max=0.0))
        alpha = torch.clamp(e, max=ALPHA_MAX)
        ok = live & (power <= 0.0) & (e >= ALPHA_MIN)
        test_t = trans * (1.0 - alpha)
        stop = ok & (test_t < T_EPS)
        blend = ok & ~stop
        w = torch.where(blend, alpha * trans, torch.zeros_like(trans))
        color = color + rows[:, 5:8, None] * w[:, None, :]
        trans = torch.where(blend, test_t, trans)
        done = done | stop
        if count_work:
            work["pairs"] += int(live.sum())
            work["exps"] += int((live & (power <= 0.0)).sum())
            work["blended"] += int(blend.sum())

    img = color.reshape(nty, ntx, 3, tile_size, tile_size).permute(
        2, 0, 3, 1, 4).reshape(3, nty * tile_size, ntx * tile_size)
    t_img = trans.reshape(nty, ntx, tile_size, tile_size).permute(
        0, 2, 1, 3).reshape(nty * tile_size, ntx * tile_size)
    out = (img[:, :height, :width].contiguous(),
           t_img[:height, :width].contiguous())
    return (out, work) if count_work else out
