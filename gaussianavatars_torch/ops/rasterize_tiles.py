"""Tile rasterizer: project -> bin -> gather -> blend -> composite (port of
`gaussianavatars_tpu/ops/rasterize_tiles.py::rasterize`), differentiable
through autograd.

  projection  ops/projection.py     kernels project_fwd / project_bwd
                                    (csrc/project.cu) on CUDA, plain torch
                                    on CPU, through `ProjectGaussians`
  binning     ops/binning_dense.py  duplicated-key sort, exact shapes
              ops/binning.py        (`binning="sort"`) rect expansion and one
                                    stable sort by tile; the inputs of both
                                    are detached (no gradient)
  gather      ops/instance_pack.py  one (K, 9) row gather by gaussian id;
                                    its transpose is autograd's index_add_
  blend       ops/tile_blend.py     kernels K1 / K2 on CUDA, plain torch on
                                    CPU, through the autograd `BlendImage`
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from gaussianavatars_torch.ops.binning import bin_gaussians
from gaussianavatars_torch.ops.binning_dense import bin_gaussians_dense
from gaussianavatars_torch.ops.instance_pack import (
    gather_instances,
    pack_projected,
)
from gaussianavatars_torch.ops.projection import (
    CameraParams,
    ProjectedGaussians,
    project_gaussians,
)
from gaussianavatars_torch.ops.tile_blend import blend_image
from gaussianavatars_torch.utils.trace import span


def bin_projected(proj: ProjectedGaussians, width: int, height: int,
                  tile_size: int, tile_row_start: int = 0,
                  tile_rows: Optional[int] = None, binning: str = "dense"):
    """The instance stream of projected Gaussians: `bin_gaussians_dense`
    ("dense") or `bin_gaussians` ("sort") of their detached inputs."""
    if binning == "sort":
        return bin_gaussians(
            proj.means2d.detach(), proj.depths.detach(), proj.radii,
            proj.valid, proj.r2_max.detach(), width, height, tile_size,
            tile_row_start, tile_rows)
    if binning == "dense":
        return bin_gaussians_dense(
            proj.means2d.detach(), proj.depths.detach(), proj.radii,
            proj.valid, proj.conics.detach(), proj.tau.detach(),
            proj.ext_x.detach(), proj.ext_y.detach(), width, height,
            tile_size, tile_row_start, tile_rows)
    raise ValueError(f"binning must be 'dense' or 'sort', not {binning!r}")


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
    projected: Optional[ProjectedGaussians] = None,
    binning: str = "dense",
) -> RenderOutput:
    """Tile-based splat render (reference gaussian_renderer/__init__.py:86-94).

    `tile_row_start` / `tile_rows` render a window of tile rows (a slab of
    `tile_rows * tile_size` pixel rows starting at pixel row
    `tile_row_start * tile_size`, possibly running past the image bottom;
    callers crop). `means2d_offset` ([N, 2] zeros) is added to the NDC
    centers; its gradient is the densification signal.
    `scaling_modifier`, `colors_precomp` ([N, 3]) and `cov3d_precomp`
    ([N, 3, 3]) are those of `project_gaussians`. Each stage is a span of
    `utils/trace.py` under "rasterize"; `mark`, if given, is called with
    each stage's name as the stage is issued ("projection", "binning",
    "pack_gather", "blend", "composite"); the chip smoke test records CUDA
    events there.

    `projected` hands in Gaussians that are already projected (the
    render-parallel path of `parallel/sharded.py` projects each shard where
    it lives and gathers the set); the first five arguments, the
    projection options and `means2d_offset` are then not read, nor is
    `projected.r2_max` under the dense binning.

    `binning` picks the instance stream: "dense" (`bin_gaussians_dense`,
    the exact ellipse-box cull) or "sort" (`bin_gaussians`, the square
    rect and the r2_max disc cull; a longer stream, the same image). The
    JAX signature defaults to "sort"; every caller of the port relies on
    the dense stream, so "dense" is the default here.
    """
    with span("rasterize"):
        with span("projection", mark):
            proj = projected
            if proj is None:
                proj = project_gaussians(
                    means3d, scales, quats, opacities, shs, sh_degree,
                    camera, scaling_modifier=scaling_modifier,
                    means2d_offset=means2d_offset,
                    colors_precomp=colors_precomp,
                    cov3d_precomp=cov3d_precomp)
        with span("binning", mark):
            bins = bin_projected(proj, camera.width, camera.height,
                                 tile_size, tile_row_start, tile_rows,
                                 binning)
            ranges = torch.stack([bins.tile_starts, bins.tile_ends], dim=-1)
        with span("pack_gather", mark):
            inst = gather_instances(
                pack_projected(proj.means2d, proj.conics, proj.colors,
                               proj.opacities),
                bins.gaussian_ids)
        with span("blend", mark):
            slab_h = (camera.height if tile_rows is None
                      else tile_rows * tile_size)
            color, trans = blend_image(inst, ranges,
                                       tile_row_start * tile_size,
                                       camera.width, slab_h, tile_size)
        with span("composite", mark):
            image = color + trans[None, :, :] * bg[:, None, None]
    return RenderOutput(image=image, transmittance=trans, radii=proj.radii,
                        visibility=proj.valid,
                        instance_total=bins.total)
