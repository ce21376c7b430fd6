"""Oracle splat rasterizer: naive O(N x pixels), exact, differentiable
(port of `gaussianavatars_tpu/ops/rasterize_jnp.py`; `jnp` there is JAX's
numpy).

The executable specification of the renderer: the per-pixel front-to-back
blend of the reference CUDA rasterizer (the tile kernel behind
gaussian_renderer/__init__.py:86-94) in closed form,

  for gaussians sorted by view depth (front first):
    power = -0.5 (d^T conic d);        skip if power > 0
    alpha = min(0.99, opacity * exp(power));  skip if alpha < 1/255
    test_T = T * (1 - alpha);          stop pixel if test_T < 1e-4
    C += color * alpha * T;  T = test_T
  out = C + T * bg

with the recurrence as a cumulative product of (1 - alpha) along the
depth-sorted axis and the early-out latch as a monotone mask on the
inclusive product (T is non-increasing, so the latch is the pixel's own
test). The constants are the blend's (`ops/tile_blend.py`). A test oracle
on any device; nothing on the render or training path calls it.
"""

from __future__ import annotations

import torch

from gaussianavatars_torch.ops.binning import compute_tile_rects
from gaussianavatars_torch.ops.projection import (
    CameraParams,
    ProjectedGaussians,
)
from gaussianavatars_torch.ops.tile_blend import ALPHA_MAX, ALPHA_MIN, T_EPS


def blend_pixels_reference(pix_xy, means2d, conics, colors, opacities,
                           active, bg):
    """Blend N depth-sorted gaussians (front first) into P pixels.

    pix_xy [P, 2] pixel centres, means2d [N, 2], conics [N, 3], colors
    [N, 3], opacities [N], active [P, N] or [N] bool (whether a gaussian
    takes part at a pixel: the CUDA tile-rect culling), bg [3]. Returns
    ([P, 3] colour, [P] final transmittance).
    """
    if active.dim() == 1:
        active = active[None, :].expand(pix_xy.shape[0], -1)
    d = means2d[None, :, :] - pix_xy[:, None, :]              # [P, N, 2]
    power = -0.5 * (conics[None, :, 0] * d[..., 0] ** 2
                    + conics[None, :, 2] * d[..., 1] ** 2) \
        - conics[None, :, 1] * d[..., 0] * d[..., 1]          # [P, N]
    # clamp before exp so the power > 0 branch makes no inf (which would
    # poison the gradients through the where)
    alpha = torch.clamp(
        opacities[None, :] * torch.exp(torch.clamp(power, max=0.0)),
        max=ALPHA_MAX)
    contributes = (power <= 0.0) & (alpha >= ALPHA_MIN) & active
    alpha = torch.where(contributes, alpha, torch.zeros_like(alpha))

    # inclusive / exclusive transmittance along the sorted axis
    log_one_minus = torch.log1p(-alpha)
    incl = torch.exp(torch.cumsum(log_one_minus, dim=1))      # T after i
    excl = incl / (1.0 - alpha)                               # T before i
    mask = incl >= T_EPS
    weight = alpha * excl * mask                              # [P, N]
    color = weight @ colors                                   # [P, 3]
    t_final = torch.exp(torch.sum(log_one_minus * mask, dim=1))
    return color + t_final[:, None] * bg[None, :], t_final


def rasterize_reference(proj: ProjectedGaussians, camera: CameraParams,
                        bg: torch.Tensor, tile_size: int = 16) -> torch.Tensor:
    """Rasterize projected gaussians to a [3, H, W] image: a gaussian
    takes part at a pixel only when its square tile rect
    (`ops/binning.py::compute_tile_rects`) covers that pixel's tile."""
    h, w = camera.height, camera.width
    dev = proj.means2d.device
    order = torch.argsort(proj.depths, stable=True)
    means2d = proj.means2d[order]

    ys, xs = torch.meshgrid(
        torch.arange(h, dtype=means2d.dtype, device=dev),
        torch.arange(w, dtype=means2d.dtype, device=dev), indexing="ij")
    pix = torch.stack([xs.reshape(-1), ys.reshape(-1)], dim=-1)  # [P, 2]

    x0, y0, x1, y1 = compute_tile_rects(means2d, proj.radii[order], w, h,
                                        tile_size)
    ptx = torch.div(pix[:, 0], tile_size, rounding_mode="floor").long()
    pty = torch.div(pix[:, 1], tile_size, rounding_mode="floor").long()
    active = ((ptx[:, None] >= x0[None, :]) & (ptx[:, None] < x1[None, :])
              & (pty[:, None] >= y0[None, :]) & (pty[:, None] < y1[None, :])
              & proj.valid[order][None, :])
    color, _ = blend_pixels_reference(
        pix, means2d, proj.conics[order], proj.colors[order],
        proj.opacities[order], active, bg)
    return color.reshape(h, w, 3).permute(2, 0, 1)
