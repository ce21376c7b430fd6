"""Render (serving) entry of the training driver (port of
`gaussianavatars_tpu/train/loop.py::make_render_fn` and its camera
inputs). The training step lands here with the backward kernels."""

from __future__ import annotations

from typing import NamedTuple

import torch

from gaussianavatars_torch.config import PipelineConfig
from gaussianavatars_torch.models.gaussians import world_space_gaussians
from gaussianavatars_torch.ops.projection import CameraParams
from gaussianavatars_torch.ops.rasterize_tiles import RenderOutput, rasterize


class CameraArrays(NamedTuple):
    """Per-view camera inputs (width/height are fixed per render fn)."""

    viewmatrix: torch.Tensor
    projmatrix: torch.Tensor
    campos: torch.Tensor
    tan_fovx: float
    tan_fovy: float


def camera_arrays(params: CameraParams) -> CameraArrays:
    return CameraArrays(
        viewmatrix=params.viewmatrix, projmatrix=params.projmatrix,
        campos=params.campos, tan_fovx=float(params.tan_fovx),
        tan_fovy=float(params.tan_fovy))


def make_render_fn(model, pipe_cfg: PipelineConfig, width: int, height: int,
                   sh_degree: int):
    """Inference render of `model` at width x height.

    Returns render(params, flame_param, binding, cam, bg, timestep,
    mark=None) -> RenderOutput. For a FLAME-bound model every call drives
    the mesh at `timestep` (FLAME forward, per-face frames), carries the
    Gaussians into world space through their bound faces, and rasterizes;
    an unbound model (binding None) renders its parameters as they are.
    `mark` is the per-stage hook of `rasterize`, also called after
    "flame_frames" and "binding".
    """
    if pipe_cfg.binning != "dense":
        raise NotImplementedError(
            f"binning {pipe_cfg.binning!r} is not ported; use 'dense'")
    bound = model.binding is not None

    @torch.no_grad()
    def render(params, flame_param, binding, cam: CameraArrays,
               bg: torch.Tensor, timestep: int = 0,
               mark=None) -> RenderOutput:
        camera = CameraParams(
            viewmatrix=cam.viewmatrix, projmatrix=cam.projmatrix,
            campos=cam.campos, tan_fovx=cam.tan_fovx, tan_fovy=cam.tan_fovy,
            width=width, height=height)
        frames = None
        if bound:
            frames = model.face_frames_at(flame_param, timestep)
            if mark:
                mark("flame_frames")
        means3d, scales, quats, opac, shs = world_space_gaussians(
            params, binding if bound else None, frames)
        if mark:
            mark("binding")
        return rasterize(means3d, scales, quats, opac, shs, sh_degree,
                         camera, bg, tile_size=pipe_cfg.tile_size, mark=mark)

    return render
