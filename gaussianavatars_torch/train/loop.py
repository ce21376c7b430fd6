"""The render and the train step of the training driver (port of
`gaussianavatars_tpu/train/loop.py::make_render_fn`, `make_train_step`,
`StepState` and `lr_pytree`). The host loop (densification, data,
checkpoints) is not ported yet."""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from gaussianavatars_torch.config import OptimizationConfig, PipelineConfig
from gaussianavatars_torch.models.gaussians import (
    GaussianParams,
    world_space_gaussians,
)
from gaussianavatars_torch.ops.projection import CameraParams
from gaussianavatars_torch.ops.rasterize_tiles import RenderOutput, rasterize
from gaussianavatars_torch.train import optim
from gaussianavatars_torch.train.losses import compute_losses


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


def _camera(cam: CameraArrays, width: int, height: int) -> CameraParams:
    return CameraParams(
        viewmatrix=cam.viewmatrix, projmatrix=cam.projmatrix,
        campos=cam.campos, tan_fovx=cam.tan_fovx, tan_fovy=cam.tan_fovy,
        width=width, height=height)


def _check_pipeline(pipe_cfg: PipelineConfig):
    if pipe_cfg.binning != "dense":
        raise NotImplementedError(
            f"binning {pipe_cfg.binning!r} is not ported; use 'dense'")


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
    _check_pipeline(pipe_cfg)
    bound = model.binding is not None

    @torch.no_grad()
    def render(params, flame_param, binding, cam: CameraArrays,
               bg: torch.Tensor, timestep: int = 0,
               mark=None) -> RenderOutput:
        camera = _camera(cam, width, height)
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


class StepState(NamedTuple):
    """Training state threaded through the train step."""

    params: GaussianParams
    flame_tr: dict            # trainable FLAME subset (may be empty)
    mu: dict                  # Adam moments, {"gauss": ..., "flame": ...}
    nu: dict
    count: int                # Adam step count
    max_radii2d: torch.Tensor  # [N] densification statistics
    grad_accum: torch.Tensor   # [N]
    denom: torch.Tensor        # [N]


def initial_state(model) -> StepState:
    """The step state of `model`: its parameters, its FLAME trainables, its
    densification statistics and its carried Adam state, or a fresh one."""
    flame_tr = model.flame_trainable() if model.binding is not None else {}
    if model.opt_state is not None:
        mu, nu, count = model.opt_state
    else:
        mu, nu, count = optim.init({"gauss": model.params, "flame": flame_tr})
    return StepState(params=model.params, flame_tr=flame_tr, mu=mu, nu=nu,
                     count=count, max_radii2d=model.max_radii2d,
                     grad_accum=model.xyz_gradient_accum, denom=model.denom)


def lr_pytree(opt_cfg: OptimizationConfig, xyz_lr: float, flame_tr: dict,
              spatial_lr_scale: float) -> dict:
    """Learning rates in the tree of {"gauss": params, "flame": flame_tr}.
    (`spatial_lr_scale` is the caller's to fold into `xyz_lr`, as in the
    JAX package.)"""
    gauss = GaussianParams(
        xyz=xyz_lr,
        features_dc=opt_cfg.feature_lr,
        features_rest=opt_cfg.feature_lr / 20.0,
        scaling=opt_cfg.scaling_lr,
        rotation=opt_cfg.rotation_lr,
        opacity=opt_cfg.opacity_lr,
    )
    flame_lrs = {}
    for k in flame_tr:
        if k in ("rotation", "neck_pose", "jaw_pose", "eyes_pose"):
            flame_lrs[k] = opt_cfg.flame_pose_lr
        elif k == "translation":
            flame_lrs[k] = opt_cfg.flame_trans_lr
        elif k == "expr":
            flame_lrs[k] = opt_cfg.flame_expr_lr
    return {"gauss": gauss, "flame": flame_lrs}


def make_train_step(model, opt_cfg: OptimizationConfig,
                    pipe_cfg: PipelineConfig, width: int, height: int,
                    sh_degree: int, num_timesteps: int):
    """The train step of `model` at width x height.

    Returns step(state, flame_fixed, binding, cam, gt_image, bg, timestep,
    lrs, mark=None) -> (new_state, losses, instance_total). One call drives
    FLAME at `timestep` with {**flame_fixed, **state.flame_tr}, builds the
    face frames and the binding chain, rasterizes with a zeros
    `means2d_offset`, computes the loss stack of `compute_losses`, takes
    the gradients of the Gaussian parameters, the FLAME trainables and the
    offset, applies one Adam step and updates the densification statistics
    (reference train.py:127-210). An unbound model (binding None) trains
    its parameters as they are.

    The state's tensors are updated IN PLACE (parameters, moments and
    statistics) and returned in the new state; the state passed in must
    not be reused. `mark`, if given, is called with "flame_frames" (bound
    only), "binding", the rasterizer's stages, "forward" (the loss),
    "backward", "adam" and "stats" as each phase is issued.
    """
    _check_pipeline(pipe_cfg)
    for name in ("lambda_dynamic_offset", "lambda_laplacian",
                 "lambda_dynamic_offset_std"):
        if getattr(opt_cfg, name) != 0.0:
            raise NotImplementedError(
                f"{name} needs the FLAME masks and laplacian, not ported yet")
    bound = model.binding is not None
    del num_timesteps       # timesteps index the FLAME tensors directly

    def step(state: StepState, flame_fixed: dict, binding,
             cam: CameraArrays, gt_image: torch.Tensor, bg: torch.Tensor,
             timestep: int, lrs: dict,
             mark: Optional[Callable[[str], None]] = None):
        camera = _camera(cam, width, height)
        params = GaussianParams(*[p.detach().requires_grad_()
                                  for p in state.params])
        flame_tr = {k: v.detach().requires_grad_()
                    for k, v in state.flame_tr.items()}
        offset = torch.zeros((params.xyz.shape[0], 2), dtype=torch.float32,
                             device=params.xyz.device, requires_grad=True)
        with torch.enable_grad():
            frames = None
            if bound:
                frames = model.face_frames_at({**flame_fixed, **flame_tr},
                                              timestep)
                if mark:
                    mark("flame_frames")
            means3d, scales, quats, opac, shs, face_scale = \
                world_space_gaussians(params, binding if bound else None,
                                      frames, return_face_scale=True)
            if mark:
                mark("binding")
            out = rasterize(means3d, scales, quats, opac, shs, sh_degree,
                            camera, bg, tile_size=pipe_cfg.tile_size,
                            means2d_offset=offset, mark=mark)
            total, losses = compute_losses(
                out.image, gt_image, out.visibility, params.xyz,
                params.scaling, face_scale, opt_cfg, bound)
            losses["total"] = total
            if mark:
                mark("forward")
            leaves = [*params, *flame_tr.values(), offset]
            grads = torch.autograd.grad(total, leaves, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g
                 for x, g in zip(leaves, grads)]
        n_p = len(params)
        g_params = GaussianParams(*grads[:n_p])
        g_flame = dict(zip(flame_tr, grads[n_p:-1]))
        g_offset = grads[-1]
        if mark:
            mark("backward")

        combined = {"gauss": state.params, "flame": state.flame_tr}
        combined_g = {"gauss": g_params, "flame": g_flame}
        new_p, mu, nu, count = optim.apply(combined, combined_g, state.mu,
                                           state.nu, state.count, lrs)
        if mark:
            mark("adam")

        # densification statistics (reference train.py:196-198), in place
        with torch.no_grad():
            vis = out.visibility
            grad_norm = torch.linalg.norm(g_offset, dim=-1)
            state.grad_accum.add_(torch.where(vis, grad_norm, 0.0))
            state.denom.add_(vis.to(torch.float32))
            torch.maximum(state.max_radii2d,
                          torch.where(vis, out.radii.to(torch.float32), 0.0),
                          out=state.max_radii2d)
        if mark:
            mark("stats")
        new_state = StepState(
            params=new_p["gauss"], flame_tr=new_p["flame"], mu=mu, nu=nu,
            count=count, max_radii2d=state.max_radii2d,
            grad_accum=state.grad_accum, denom=state.denom)
        losses = {k: v.detach() for k, v in losses.items()}
        return new_state, losses, out.instance_total

    return step
