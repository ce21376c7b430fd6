"""Tile rasterizer: project -> bin -> gather -> blend -> composite (port of
`gaussianavatars_tpu/ops/rasterize_tiles.py::rasterize`), differentiable
through autograd.

  projection  ops/projection.py     per-gaussian elementwise torch
  binning     ops/binning_dense.py  duplicated-key sort, exact shapes; its
                                    inputs are detached (no gradient)
  gather      ops/instance_pack.py  one (K, 9) row gather by gaussian id;
                                    its transpose is autograd's index_add_
  blend       ops/tile_blend.py     kernels K1 / K2 on CUDA, plain torch on
                                    CPU, through the autograd `BlendImage`
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from gaussianavatars_torch.ops.binning_dense import bin_gaussians_dense
from gaussianavatars_torch.ops.instance_pack import (
    gather_instances,
    pack_projected,
)
from gaussianavatars_torch.ops.projection import CameraParams, project_gaussians
from gaussianavatars_torch.ops.tile_blend import blend_image


class RenderOutput(NamedTuple):
    image: torch.Tensor          # [3, H, W] final composited image
    transmittance: torch.Tensor  # [H, W] residual T (background weight)
    radii: torch.Tensor          # [N] int32 screen radii (0 = culled)
    visibility: torch.Tensor     # [N] bool
    instance_total: int          # instance-stream length


def rasterize(
    means3d, scales, quats, opacities, shs, sh_degree: int,
    camera: CameraParams, bg: torch.Tensor, *,
    tile_size: int = 32,
    tile_row_start: int = 0,
    tile_rows: Optional[int] = None,
    scaling_modifier: float = 1.0,
    means2d_offset: Optional[torch.Tensor] = None,
    colors_precomp: Optional[torch.Tensor] = None,
    cov3d_precomp: Optional[torch.Tensor] = None,
    mark: Optional[Callable[[str], None]] = None,
) -> RenderOutput:
    """Tile-based splat render (reference gaussian_renderer/__init__.py:86-94).

    `tile_row_start` / `tile_rows` render a window of tile rows (a slab of
    `tile_rows * tile_size` pixel rows starting at pixel row
    `tile_row_start * tile_size`, possibly running past the image bottom;
    callers crop). `means2d_offset` ([N, 2] zeros) is added to the NDC
    centers; its gradient is the densification signal.
    `scaling_modifier`, `colors_precomp` ([N, 3]) and `cov3d_precomp`
    ([N, 3, 3]) are those of `project_gaussians`. `mark`, if
    given, is called with each stage's name as the stage is issued
    ("projection", "binning", "pack_gather", "blend", "composite"); the
    chip smoke test records CUDA events there.
    """
    proj = project_gaussians(
        means3d, scales, quats, opacities, shs, sh_degree, camera,
        scaling_modifier=scaling_modifier, means2d_offset=means2d_offset,
        colors_precomp=colors_precomp, cov3d_precomp=cov3d_precomp)
    if mark:
        mark("projection")
    binning = bin_gaussians_dense(
        proj.means2d.detach(), proj.depths.detach(), proj.radii, proj.valid,
        proj.conics.detach(), proj.tau.detach(), proj.ext_x.detach(),
        proj.ext_y.detach(), camera.width, camera.height, tile_size,
        tile_row_start, tile_rows)
    ranges = torch.stack([binning.tile_starts, binning.tile_ends], dim=-1)
    if mark:
        mark("binning")
    inst = gather_instances(
        pack_projected(proj.means2d, proj.conics, proj.colors,
                       proj.opacities),
        binning.gaussian_ids)
    if mark:
        mark("pack_gather")
    slab_h = camera.height if tile_rows is None else tile_rows * tile_size
    color, trans = blend_image(inst, ranges, tile_row_start * tile_size,
                               camera.width, slab_h, tile_size)
    if mark:
        mark("blend")
    image = color + trans[None, :, :] * bg[:, None, None]
    if mark:
        mark("composite")
    return RenderOutput(image=image, transmittance=trans, radii=proj.radii,
                        visibility=proj.valid,
                        instance_total=binning.total)
