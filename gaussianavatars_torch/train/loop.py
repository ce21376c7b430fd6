"""The training driver (port of `gaussianavatars_tpu/train/loop.py`;
reference train.py:35-314): the render and the train step, and the host
loop around them (`training`: data, the xyz schedule, the SH warmup,
densification, opacity resets, evaluation, saving and checkpoints).

`training` serves the network viewer between steps (`gui_poll`, a
`viewer/network_gui.py` server) and logs to a tensorboard writer
(`utils/tensorboard.py`) as the JAX loop does. With
`PipelineConfig.data_parallel` / `render_parallel` (or under
`torch.distributed`) it trains over the process mesh of `parallel/`
(`make_parallel_train_step`). Left out, as TPU devices: capacity and
level-bucket growth, the overflow probes and the asynchronous
precompilation.
"""

from __future__ import annotations

import json
import os
import time
import traceback
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from gaussianavatars_torch.config import (
    ModelConfig,
    OptimizationConfig,
    PipelineConfig,
    save_config,
)
from gaussianavatars_torch.device import resolve_device
from gaussianavatars_torch.models.flame_gaussians import (
    FlameGaussianModel,
    face_frames_from_verts,
)
from gaussianavatars_torch.models.gaussians import (
    AdamState,
    GaussianModel,
    GaussianParams,
    world_space_gaussians,
)
from gaussianavatars_torch.ops.covariance import build_covariance_3d
from gaussianavatars_torch.ops.projection import CameraParams
from gaussianavatars_torch.ops.rasterize_tiles import RenderOutput, rasterize
from gaussianavatars_torch.ops.sh import eval_sh
from gaussianavatars_torch.ops.ssim import ssim
from gaussianavatars_torch.train import optim
from gaussianavatars_torch.train.losses import compute_losses
from gaussianavatars_torch.utils import trace
from gaussianavatars_torch.utils.image import l1_loss, psnr
from gaussianavatars_torch.utils.schedules import expon_lr
from gaussianavatars_torch.utils.system import safe_state
from gaussianavatars_torch.utils.trace import span

PRINT_EVERY = 100          # iterations between progress lines
# device-resident ground-truth images (bytes)
GT_DEV_CACHE_BUDGET = int(float(os.environ.get("GA_GT_DEVICE_CACHE_GB", "2"))
                          * (1 << 30))


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
    if pipe_cfg.binning not in ("dense", "sort"):
        raise ValueError(f"binning must be 'dense' or 'sort', not "
                         f"{pipe_cfg.binning!r}")


def _precomputed(pipe_cfg: PipelineConfig, camera: CameraParams, means3d,
                 scales, quats, shs, sh_degree: int) -> dict:
    """The `colors_precomp` / `cov3d_precomp` arguments of `rasterize` that
    the pipeline options ask for (reference gaussian_renderer/__init__.py:
    63-81): the SH colours evaluated by `eval_sh` on the coefficients as
    [N, 3, K], and the covariance built from the scales and rotations."""
    out = {}
    if pipe_cfg.convert_SHs_python:
        dirs = means3d - camera.campos
        dirs = dirs / torch.clamp(
            torch.linalg.norm(dirs, dim=-1, keepdim=True), min=1e-12)
        # flat channel-major [N, 3*K] -> [N, 3, K]: the channel axis at -2
        out["colors_precomp"] = torch.clamp(
            eval_sh(sh_degree, shs.reshape(shs.shape[0], 3, -1), dirs) + 0.5,
            min=0.0)
    if pipe_cfg.compute_cov3D_python:
        out["cov3d_precomp"] = build_covariance_3d(scales, quats)
    return out


def make_render_fn(model, pipe_cfg: PipelineConfig, width: int, height: int,
                   sh_degree: int, differentiable: bool = False):
    """Inference render of `model` at width x height.

    Returns render(params, flame_param, binding, cam, bg, timestep,
    mark=None, scaling_modifier=1.0) -> RenderOutput. For a FLAME-bound
    model every call drives the mesh at `timestep` (FLAME forward, per-face
    frames), carries the Gaussians into world space through their bound
    faces, and rasterizes; an unbound model (binding None) renders its
    parameters as they are. `pipe_cfg.convert_SHs_python` and
    `compute_cov3D_python` precompute the colours and covariances outside
    the rasterizer. The call is the span "render" of `utils/trace.py`;
    `mark` is the per-stage hook of `rasterize`, also called after
    "flame_frames" and "binding". The render runs without
    autograd unless `differentiable` (the parity tool's probe gradients).
    """
    _check_pipeline(pipe_cfg)
    bound = model.binding is not None

    def render(params, flame_param, binding, cam: CameraArrays,
               bg: torch.Tensor, timestep: int = 0, mark=None,
               scaling_modifier: float = 1.0) -> RenderOutput:
        with span("render"):
            camera = _camera(cam, width, height)
            frames = None
            if bound:
                with span("flame_frames", mark):
                    frames = model.face_frames_at(flame_param, timestep)
            with span("binding", mark):
                means3d, scales, quats, opac, shs = world_space_gaussians(
                    params, binding if bound else None, frames)
            return rasterize(means3d, scales, quats, opac, shs, sh_degree,
                             camera, bg, tile_size=pipe_cfg.tile_size,
                             binning=pipe_cfg.binning,
                             scaling_modifier=scaling_modifier, mark=mark,
                             **_precomputed(pipe_cfg, camera, means3d,
                                            scales, quats, shs, sh_degree))

    return render if differentiable else torch.no_grad()(render)


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
    its parameters as they are. The pipeline options precompute the
    colours and covariances as `make_render_fn` does; their gradients
    reach the parameters through autograd.

    The state's tensors are updated IN PLACE (parameters, moments and
    statistics) and returned in the new state; the state passed in must
    not be reused. The call is the span "train_step" of `utils/trace.py`
    and each phase a span under it; `mark`, if given, is called with
    "flame_frames" (bound only), "binding", the rasterizer's stages,
    "forward" (the loss), "backward", "adam" and "stats" as each phase is
    issued.
    """
    _check_pipeline(pipe_cfg)
    bound = model.binding is not None
    del num_timesteps       # timesteps index the FLAME tensors directly

    def step(state: StepState, flame_fixed: dict, binding,
             cam: CameraArrays, gt_image: torch.Tensor, bg: torch.Tensor,
             timestep: int, lrs: dict,
             mark: Optional[Callable[[str], None]] = None):
        with span("train_step"):
            camera = _camera(cam, width, height)
            params = GaussianParams(*[p.detach().requires_grad_()
                                      for p in state.params])
            flame_tr = {k: v.detach().requires_grad_()
                        for k, v in state.flame_tr.items()}
            offset = torch.zeros((params.xyz.shape[0], 2),
                                 dtype=torch.float32,
                                 device=params.xyz.device, requires_grad=True)
            with torch.enable_grad():
                frames = None
                if bound:
                    with span("flame_frames", mark):
                        flame_full = {**flame_fixed, **flame_tr}
                        verts, verts_cano = model.verts_at(
                            flame_full, timestep, return_verts_cano=True)
                        frames = face_frames_from_verts(
                            verts[0], model.flame_model.faces)
                with span("binding", mark):
                    means3d, scales, quats, opac, shs, face_scale = \
                        world_space_gaussians(
                            params, binding if bound else None, frames,
                            return_face_scale=True)
                out = rasterize(means3d, scales, quats, opac, shs, sh_degree,
                                camera, bg, tile_size=pipe_cfg.tile_size,
                                binning=pipe_cfg.binning,
                                means2d_offset=offset, mark=mark,
                                **_precomputed(pipe_cfg, camera, means3d,
                                               scales, quats, shs, sh_degree))
                with span("forward", mark):
                    total, losses = compute_losses(
                        out.image, gt_image, out.visibility, params.xyz,
                        params.scaling, face_scale, opt_cfg, bound)
                    if bound:
                        total = _flame_regularizers(
                            model, opt_cfg, flame_full, timestep, verts_cano,
                            total, losses)
                    losses["total"] = total
                with span("backward", mark):
                    leaves = [*params, *flame_tr.values(), offset]
                    grads = torch.autograd.grad(total, leaves,
                                                allow_unused=True)
                    grads = [torch.zeros_like(x) if g is None else g
                             for x, g in zip(leaves, grads)]
                    n_p = len(params)
                    g_params = GaussianParams(*grads[:n_p])
                    g_flame = dict(zip(flame_tr, grads[n_p:-1]))
                    g_offset = grads[-1]

            with span("adam", mark):
                combined = {"gauss": state.params, "flame": state.flame_tr}
                combined_g = {"gauss": g_params, "flame": g_flame}
                new_p, mu, nu, count = optim.apply(combined, combined_g,
                                                   state.mu, state.nu,
                                                   state.count, lrs)

            # densification statistics (reference train.py:196-198), in place
            with span("stats", mark), torch.no_grad():
                vis = out.visibility
                grad_norm = torch.linalg.norm(g_offset, dim=-1)
                state.grad_accum.add_(torch.where(vis, grad_norm, 0.0))
                state.denom.add_(vis.to(torch.float32))
                torch.maximum(
                    state.max_radii2d,
                    torch.where(vis, out.radii.to(torch.float32), 0.0),
                    out=state.max_radii2d)
            new_state = StepState(
                params=new_p["gauss"], flame_tr=new_p["flame"], mu=mu, nu=nu,
                count=count, max_radii2d=state.max_radii2d,
                grad_accum=state.grad_accum, denom=state.denom)
            losses = {k: v.detach() for k, v in losses.items()}
            return new_state, losses, out.instance_total

    return step


def make_parallel_train_step(mesh, model, opt_cfg: OptimizationConfig,
                             pipe_cfg: PipelineConfig, width: int,
                             height: int, sh_degree: int):
    """The train step of `training`'s parallel branch: the contract of
    `make_train_step` (without `mark`) around
    `parallel/sharded.py::make_sharded_train_step`, on this rank's part.
    `state` is the rank's prim shard (`parallel/sharded.py::shard_state`),
    `binding` the model's full binding (the step takes the shard's rows)
    and the view is this rank's data group's camera of the batch; one
    optimizer step consumes the batch of `mesh.shape["data"]` views.
    `model.num_gaussians` is the total the shards add up to.
    """
    from gaussianavatars_torch.parallel.sharded import make_sharded_train_step

    raw = make_sharded_train_step(mesh, model, opt_cfg, pipe_cfg, width,
                                  height, sh_degree)

    def step(state: StepState, flame_fixed: dict, binding,
             cam: CameraArrays, gt_image, bg, timestep: int, lrs: dict):
        n = model.num_gaussians
        if binding is not None:
            binding = binding[mesh.shard(n)]
        return raw(state, flame_fixed, binding, cam, gt_image, bg, timestep,
                   lrs, n)

    return step


def _flame_regularizers(model, opt_cfg: OptimizationConfig,
                        flame_full: dict, timestep: int,
                        verts_cano: torch.Tensor, total, losses: dict):
    """Add the weighted FLAME regularizers whose weights are non-zero to
    `losses` (`dy_off`, `dynamic_offset_std`, `lap`, in that order) and
    return `total` with them."""
    with span("flame_reg"):
        if opt_cfg.lambda_dynamic_offset != 0.0:
            losses["dy_off"] = model.compute_dynamic_offset_loss(
                flame_full, timestep) * opt_cfg.lambda_dynamic_offset
            total = total + losses["dy_off"]
        if opt_cfg.lambda_dynamic_offset_std != 0.0:
            # the population standard deviation over timesteps (jnp.std)
            std = flame_full["dynamic_offset"].std(dim=0, correction=0).mean()
            losses["dynamic_offset_std"] = \
                std * opt_cfg.lambda_dynamic_offset_std
            total = total + losses["dynamic_offset_std"]
        if opt_cfg.lambda_laplacian != 0.0:
            losses["lap"] = model.compute_laplacian_loss(
                flame_full, timestep, verts_cano) * opt_cfg.lambda_laplacian
            total = total + losses["lap"]
    return total


# ----------------------------------------------------------------------------
# Host loop
# ----------------------------------------------------------------------------

def _adam(state: StepState) -> AdamState:
    return AdamState(mu=state.mu["gauss"], nu=state.nu["gauss"],
                     count=state.count)


def _after_surgery(model, state: StepState, adam_g: AdamState) -> StepState:
    """The step state rebuilt from the model after a surgery replaced its
    tensors (densification, opacity reset): nothing from before it stays
    in the state."""
    return StepState(
        params=model.params, flame_tr=state.flame_tr,
        mu={"gauss": adam_g.mu, "flame": state.mu["flame"]},
        nu={"gauss": adam_g.nu, "flame": state.nu["flame"]},
        count=adam_g.count, max_radii2d=model.max_radii2d,
        grad_accum=model.xyz_gradient_accum, denom=model.denom)


def gui_poll(gui, model, state: StepState, flame_fixed: dict,
             pipe_cfg: PipelineConfig, iteration: int, total_iterations: int,
             render_fns: dict) -> None:
    """Serve the network viewer between two steps (reference train.py:
    62-102, the JAX package's `gui_poll`): accept a waiting client, then
    answer its requests until it lets training go on (`do_training`, and
    the run not at its end unless it asks to leave, `keep_alive` false).

    A request with a camera is rendered by `make_render_fn` from `state`
    at the client's size and timestep on a white background, with the
    dataset's FLAME parameters if it asks for `use_original_mesh`; with
    `show_mesh` the mesh of `render/mesh_renderer.py::rasterize_mesh` is
    blended over it at `mesh_opacity`. The frame goes to the host once,
    as the wire's uint8, with the stats `num_timesteps` and `num_points`.
    An error is printed with its traceback and the connection dropped;
    training goes on."""
    if gui.conn is None:
        gui.try_connect()
    bound = model.binding is not None
    dev = model.device
    while gui.conn is not None:
        try:
            cam, msg = gui.receive()
            if cam is not None:
                params = cam.to_params(device=dev)
                key = ("gui", cam.width, cam.height, model.active_sh_degree)
                if key not in render_fns:
                    render_fns[key] = make_render_fn(
                        model, pipe_cfg, cam.width, cam.height,
                        model.active_sh_degree)
                flame_full = ({**flame_fixed, **state.flame_tr} if bound
                              else {})
                if bound and msg.get("use_original_mesh") and \
                        model.flame_param_orig is not None:
                    flame_full = {k: torch.as_tensor(
                        np.asarray(v, np.float32), device=dev)
                        for k, v in model.flame_param_orig.items()}
                timestep = int(cam.timestep)
                image = None
                if msg.get("show_splatting", True):
                    image = render_fns[key](
                        state.params, flame_full, model.binding,
                        camera_arrays(params),
                        torch.ones(3, dtype=torch.float32, device=dev),
                        timestep).image.clamp(0.0, 1.0)
                if bound and msg.get("show_mesh"):
                    from gaussianavatars_torch.render.mesh_renderer import (
                        rasterize_mesh,
                    )

                    with torch.no_grad():
                        verts = model.verts_at(flame_full, timestep)
                    rgb, alpha, _, _ = rasterize_mesh(
                        verts[0], model.flame_model.faces, params)
                    rgb, alpha = rgb.permute(2, 0, 1), alpha[None]
                    op = float(msg.get("mesh_opacity", 0.5))
                    image = rgb if image is None else (
                        rgb * alpha * op
                        + image * (alpha * (1 - op) + (1 - alpha)))
                gui.send(image, {"num_timesteps": model.num_timesteps,
                                 "num_points": model.num_gaussians})
            if msg["do_training"] and (iteration < total_iterations
                                       or not msg["keep_alive"]):
                break
        except Exception as exc:        # the viewer must not stop training
            print(f"[gui] dropping viewer connection after error: {exc!r}")
            traceback.print_exc()
            gui.drop()


def training(model_cfg: ModelConfig, opt_cfg: OptimizationConfig,
             pipe_cfg: PipelineConfig, testing_iterations=(),
             saving_iterations=(), checkpoint_iterations=(),
             start_checkpoint: Optional[str] = None, log_every: int = 10,
             tb_writer=None, gui=None, debug_from: int = -1, seed: int = 0,
             device: str | torch.device = "cuda"):
    """Train an avatar on the dataset of `model_cfg.source_path` (reference
    train.py:35-214, the JAX package's `training`).

    One iteration takes the next camera of the shuffled epoch, runs the
    train step at its resolution and timestep (the xyz learning rate from
    `expon_lr` times the scene's `spatial_lr_scale`; one more SH degree
    every 1000 iterations, one step function per degree), then, on the
    schedule of `opt_cfg`, densifies (with the face scaling of this
    camera's timestep) and resets opacities; saves the PLY at
    `saving_iterations`, evaluates the val and test splits at
    `testing_iterations` and writes `chkpnt<N>.npz` at
    `checkpoint_iterations`. `start_checkpoint` resumes from a checkpoint
    of either package. `gui` (a `viewer/network_gui.py::NetworkGUI` that
    is listening) is polled at the top of every iteration (`gui_poll`).
    `tb_writer` (`utils/tensorboard.py::SummaryWriter` or tensorboardX's)
    receives the losses and the number of Gaussians at every log point,
    and at each evaluation its metrics, render and error images and the
    opacity histogram, under the JAX loop's tags; at every log point also
    the reference's `iter_time`, the mean host ms an iteration since the
    last log point, and, while the tracer of `utils/trace.py` runs (train
    --profile_dir), `timing/<span>_ms` and `timing/host_syncs` an
    iteration. From iteration `debug_from` on (reference
    train.py --debug_from) `pipe_cfg.debug` is set; with it set, a
    non-finite loss read at a log point writes the state to
    `snapshot_fw_<iteration>.npz` in the model directory and raises
    FloatingPointError.

    The loss is read on the host only every `log_every` iterations (the
    previous iteration's, which the device has finished, as the JAX loop
    reads it; the last iteration's own at the end) into an EMA, printed
    every PRINT_EVERY iterations. The model (FLAME-bound with
    `bind_to_mesh`, its FLAME head from $FLAME_ASSET_DIR) lives on
    `device`.

    With `pipe_cfg.data_parallel` x `render_parallel` > 1, or whenever
    `torch.distributed` is initialized, every rank of the world (one
    process per rank, e.g. `train --distributed` under torchrun) runs this
    function on the ('data', 'prim') mesh of `parallel/mesh.py`, whose size
    must be the world's. Each rank holds its prim shard of the Gaussians,
    their moments and statistics; one optimizer step consumes
    `data_parallel` cameras of one resolution, drawn alike on every rank
    from the identically seeded loader, each rank taking its data group's
    (`make_parallel_train_step`). Densification, opacity resets, saving,
    checkpoints, evaluation and the viewer gather the full model to every
    rank; the surgery runs alike on each (same seed) and the state is
    sharded again. Rank 0 alone prints, writes the PLY, checkpoints, the
    event file and the summary (the files of a one-device run), evaluates
    and serves the viewer; the model and state returned are full on every
    rank.

    Returns (model, state, info); info holds "ema_loss", "elapsed",
    "history" [(iteration, ema)], "timeline" [(iteration, wall time)],
    "metrics" {iteration: evaluate_splits result}, "densify_s" [seconds of
    each densification] and "summary" (written to run_summary.json).
    """
    from gaussianavatars_torch.convert import load_checkpoint
    from gaussianavatars_torch.data.loader import CameraLoader
    from gaussianavatars_torch.data.scene import Scene

    dev = resolve_device(device)
    mesh = None
    n_data = max(1, pipe_cfg.data_parallel)
    if n_data * max(1, pipe_cfg.render_parallel) > 1 or dist.is_initialized():
        from gaussianavatars_torch.parallel.mesh import make_mesh, mesh_device
        from gaussianavatars_torch.parallel.sharded import (
            gather_state,
            shard_state,
        )

        mesh = make_mesh(n_data, max(1, pipe_cfg.render_parallel))
        if mesh.size != dist.get_world_size():
            raise ValueError(
                f"a {n_data} x {pipe_cfg.render_parallel} mesh trains on "
                f"{mesh.size} ranks; the world has {dist.get_world_size()}")
        dev = mesh_device(dev)
    lead = mesh is None or dist.get_rank() == 0
    log = print if lead else (lambda *args, **kwargs: None)
    if not lead:
        tb_writer = gui = None
    os.makedirs(model_cfg.model_path, exist_ok=True)
    if lead:
        save_config(model_cfg.model_path, model_cfg)
    # reference safe_state: the camera shuffle uses the global `random`
    safe_state(seed)

    if model_cfg.bind_to_mesh:
        model = FlameGaussianModel.from_assets(
            model_cfg.sh_degree, device=dev,
            not_finetune_flame_params=model_cfg.not_finetune_flame_params,
            disable_flame_static_offset=model_cfg.disable_flame_static_offset)
    else:
        model = GaussianModel(model_cfg.sh_degree, device=dev)
    scene = Scene(model_cfg, model)
    bound = model.binding is not None

    first_iter = 0
    flame_tr = model.flame_trainable() if bound else {}
    mu, nu, count = optim.init({"gauss": model.params, "flame": flame_tr})
    if start_checkpoint:
        first_iter, adam_g, flame_tr = load_checkpoint(start_checkpoint,
                                                       model)
        # the FLAME moments are not checkpointed (as in the JAX package)
        mu = {"gauss": adam_g.mu,
              "flame": optim.tree_map(torch.zeros_like, flame_tr)}
        nu = {"gauss": adam_g.nu,
              "flame": optim.tree_map(torch.zeros_like, flame_tr)}
        count = adam_g.count
    flame_fixed = ({k: v for k, v in model.flame_param.items()
                    if k not in flame_tr} if bound else {})

    loader = CameraLoader(scene.get_train_cameras(),
                          resolution_arg=model_cfg.resolution, device=dev)
    state = StepState(params=model.params, flame_tr=flame_tr, mu=mu, nu=nu,
                      count=count, max_radii2d=model.max_radii2d,
                      grad_accum=model.xyz_gradient_accum, denom=model.denom)
    if mesh is not None:
        state = shard_state(state, mesh)
        # whether rank 0 serves the viewer, known to every rank
        serving = torch.tensor([int(gui is not None)], device=dev)
        dist.broadcast(serving, 0)
        serving = bool(serving.item())

    def full_state() -> StepState:
        """The full state, written back into `model` for the host code
        (the step updated the tensors in place; the assignments only name
        them); under a mesh a gather of the shards."""
        full = state if mesh is None else gather_state(
            state, mesh, model.num_gaussians)
        model.params = full.params
        model.max_radii2d = full.max_radii2d
        model.xyz_gradient_accum = full.grad_accum
        model.denom = full.denom
        return full

    step_fns, gui_fns = {}, {}
    gt_cache, gt_bytes = {}, 0     # device-resident ground truth
    bg_cache = {}
    ema_loss, prev_losses = None, None
    history, timeline, metrics, densify_s = [], [], {}, []
    events = {"densify": 0, "opacity_reset": 0}
    t_start = time.time()
    last_log = (first_iter, time.perf_counter())

    try:
        for iteration in range(first_iter + 1, opt_cfg.iterations + 1):
            if mesh is None and gui is not None:
                gui_poll(gui, model, state, flame_fixed, pipe_cfg, iteration,
                         opt_cfg.iterations, gui_fns)
            elif mesh is not None and serving:
                # a gather only while a client is connected to rank 0
                if gui is not None and gui.conn is None:
                    gui.try_connect()
                busy = torch.tensor([int(gui is not None and
                                         gui.conn is not None)], device=dev)
                dist.broadcast(busy, 0)
                if busy.item():
                    full = gather_state(state, mesh, model.num_gaussians)
                    if gui is not None:
                        gui_poll(gui, model, full, flame_fixed, pipe_cfg,
                                 iteration, opt_cfg.iterations, gui_fns)
            if debug_from >= 0 and iteration >= debug_from:
                pipe_cfg.debug = True
            xyz_lr = float(expon_lr(
                iteration,
                opt_cfg.position_lr_init * model.spatial_lr_scale,
                opt_cfg.position_lr_final * model.spatial_lr_scale,
                lr_delay_mult=opt_cfg.position_lr_delay_mult,
                max_steps=opt_cfg.position_lr_max_steps))
            if iteration % 1000 == 0:           # SH warmup
                model.one_up_sh_degree()

            if mesh is None:
                cam, gt = next(loader)
                batch = [cam]
            else:
                # every rank draws the whole batch; each takes its group's
                views = [next(loader) for _ in range(n_data)]
                batch = [c for c, _ in views]
                sizes = {c.resolution(model_cfg.resolution) for c in batch}
                if len(sizes) != 1:
                    raise ValueError("a data-parallel batch needs one "
                                     f"resolution, got {sorted(sizes)}")
                cam, gt = views[mesh.data_index]
            w, h = cam.resolution(model_cfg.resolution)
            key = (w, h, model.active_sh_degree)
            if key not in step_fns:
                step_fns[key] = make_train_step(
                    model, opt_cfg, pipe_cfg, w, h, model.active_sh_degree,
                    model.num_timesteps) if mesh is None else \
                    make_parallel_train_step(
                        mesh, model, opt_cfg, pipe_cfg, w, h,
                        model.active_sh_degree)
            gt_key = (cam.image_path or (cam.camera_id, cam.timestep), w, h)
            gt_dev = gt_cache.get(gt_key)
            if gt_dev is None:
                gt_dev = torch.tensor(gt, device=dev)
                nbytes = gt_dev.element_size() * gt_dev.nelement()
                if gt_bytes + nbytes <= GT_DEV_CACHE_BUDGET:
                    gt_cache[gt_key] = gt_dev
                    gt_bytes += nbytes
            bg = bg_cache.get(cam.bg.tobytes())
            if bg is None:
                bg = bg_cache[cam.bg.tobytes()] = torch.tensor(
                    cam.bg, dtype=torch.float32, device=dev)
            lrs = lr_pytree(opt_cfg, xyz_lr, state.flame_tr,
                            model.spatial_lr_scale)
            state, losses, _ = step_fns[key](
                state, flame_fixed, model.binding,
                camera_arrays(cam.to_params(w, h, device=dev)), gt_dev, bg,
                cam.timestep or 0, lrs)

            if iteration % log_every == 0 or iteration == opt_cfg.iterations:
                src = (losses if iteration == opt_cfg.iterations
                       or prev_losses is None else prev_losses)
                total = src["total"].item()
                n_iter = iteration - last_log[0]
                iter_ms = 1e3 * (time.perf_counter() - last_log[1]) / n_iter
                last_log = (iteration, time.perf_counter())
                spans = trace.totals(trace.drain())
                if pipe_cfg.debug and not np.isfinite(total):
                    snap = os.path.join(model_cfg.model_path,
                                        f"snapshot_fw_{iteration}.npz")
                    full = full_state()
                    if lead:
                        save_checkpoint(model, full, iteration, snap)
                    raise FloatingPointError(
                        f"non-finite loss at iteration {iteration}; state "
                        f"written to {snap}")
                ema_loss = (total if ema_loss is None
                            else 0.4 * total + 0.6 * ema_loss)
                history.append((iteration, ema_loss))
                timeline.append((iteration, time.time()))
                if tb_writer is not None:
                    values = torch.stack([v.reshape(()) for v in
                                          src.values()]).tolist()
                    for k, v in zip(src, values):
                        tb_writer.add_scalar(f"train_loss_patches/{k}_loss",
                                             v, iteration)
                    tb_writer.add_scalar("total_points",
                                         model.num_gaussians, iteration)
                    tb_writer.add_scalar("iter_time", iter_ms, iteration)
                    for name, t in spans.items():
                        tb_writer.add_scalar(f"timing/{name}_ms",
                                             t["ms"] / n_iter, iteration)
                    if spans:
                        tb_writer.add_scalar("timing/host_syncs", sum(
                            t.get(trace.HOST_SYNCS, 0)
                            for t in spans.values()) / n_iter, iteration)
            if iteration % PRINT_EVERY == 0 or iteration == opt_cfg.iterations:
                log(f"[ITER {iteration}] loss {ema_loss:.7f}, "
                    f"{model.num_gaussians} Gaussians")
            prev_losses = losses

            densify_now = iteration < opt_cfg.densify_until_iter and (
                iteration > opt_cfg.densify_from_iter and
                iteration % opt_cfg.densification_interval == 0)
            reset_now = iteration < opt_cfg.densify_until_iter and (
                iteration % opt_cfg.opacity_reset_interval == 0 or (
                    model_cfg.white_background
                    and iteration == opt_cfg.densify_from_iter))
            host_work = (densify_now or reset_now
                         or iteration in saving_iterations
                         or iteration in testing_iterations
                         or iteration in checkpoint_iterations)
            # under a mesh the host code works on the gathered full state,
            # sharded again at the end of the iteration
            if mesh is None or host_work:
                state = full_state()
            if bound:
                model.merge_flame_trainable(state.flame_tr)

            if iteration in saving_iterations and lead:
                print(f"[ITER {iteration}] Saving Gaussians")
                scene.save(iteration)

            if densify_now or reset_now:
                if densify_now:
                    t0 = time.perf_counter()
                    size_threshold = (
                        20 if iteration > opt_cfg.opacity_reset_interval
                        else None)
                    face_scaling = None
                    if bound:
                        # the batch's first view, as in the JAX package
                        with torch.no_grad():
                            face_scaling = model.face_frames_at(
                                model.flame_param,
                                batch[0].timestep or 0).scaling
                    adam_g = model.densify_and_prune(
                        _adam(state), opt_cfg.densify_grad_threshold, 0.005,
                        scene.cameras_extent, size_threshold,
                        opt_cfg.percent_dense, face_scaling, seed=iteration,
                        screen_size_prune=opt_cfg.screen_size_prune)
                    state = _after_surgery(model, state, adam_g)
                    events["densify"] += 1
                    if dev.type == "cuda":
                        torch.cuda.synchronize(dev)
                    densify_s.append(time.perf_counter() - t0)
                if reset_now:
                    state = _after_surgery(model, state,
                                           model.reset_opacity(_adam(state)))
                    events["opacity_reset"] += 1

            if iteration in testing_iterations and lead:
                metrics[iteration] = evaluate_splits(
                    model, scene, model_cfg, pipe_cfg, state, flame_fixed,
                    tb_writer=tb_writer, iteration=iteration)
                for split, m in metrics[iteration].items():
                    print(f"[ITER {iteration}] Evaluating {split}: "
                          + " ".join(f"{k} {v:.4f}" for k, v in m.items()))
                    if tb_writer is not None:
                        for k, v in m.items():
                            tb_writer.add_scalar(
                                f"{split}/loss_viewpoint - {k}", v, iteration)
                if tb_writer is not None:
                    tb_writer.add_histogram(
                        "scene/opacity_histogram",
                        torch.sigmoid(state.params.opacity[:, 0]).cpu()
                        .numpy(), iteration)

            if iteration in checkpoint_iterations and lead:
                print(f"[ITER {iteration}] Saving Checkpoint")
                save_checkpoint(model, state, iteration, os.path.join(
                    model_cfg.model_path, f"chkpnt{iteration}.npz"))
            if mesh is not None and host_work:
                state = shard_state(state, mesh)
    finally:
        loader.stop()
    state = full_state()

    elapsed = time.time() - t_start
    summary = {
        "iterations": int(opt_cfg.iterations),
        "elapsed_s": round(elapsed, 2),
        "final_ema_loss": float(ema_loss or 0.0),
        "n_alive": int(model.num_gaussians),
        "densify": events["densify"],
        "opacity_reset": events["opacity_reset"],
    }
    if lead:
        with open(os.path.join(model_cfg.model_path, "run_summary.json"),
                  "w") as f:
            json.dump(summary, f, indent=2)
    return model, state, {"ema_loss": ema_loss or 0.0, "elapsed": elapsed,
                          "history": history, "timeline": timeline,
                          "metrics": metrics, "densify_s": densify_s,
                          "summary": summary}


def save_checkpoint(model, state: StepState, iteration: int, path: str):
    """`chkpnt<N>.npz` under the JAX package's keys: `g_*` the model's
    `capture`, `f_*` the FLAME trainables, `iteration`."""
    data = {f"g_{k}": v for k, v in model.capture(_adam(state)).items()}
    for k, v in state.flame_tr.items():
        data[f"f_{k}"] = v.detach().cpu().numpy()
    data["iteration"] = iteration
    np.savez(path, **data)


_EVAL_LPIPS: dict = {}    # (weights path, device) -> LPIPS or None


def _eval_lpips(device: torch.device):
    """The evaluation's LPIPS on `device`, built once per weights file
    (reference train.py:286-296); None, with one warning line, when the
    weights are not there (they are a user download, like the FLAME
    pickles)."""
    from gaussianavatars_torch.metrics_lib.lpips import (
        LPIPS,
        default_weights_path,
        lpips_available,
    )

    key = (default_weights_path(), str(device))
    if key not in _EVAL_LPIPS:
        if lpips_available(key[0]):
            _EVAL_LPIPS[key] = LPIPS(key[0], device=device)
        else:
            print(f"[warn] no LPIPS weights at {key[0]}; evaluating without "
                  "LPIPS")
            _EVAL_LPIPS[key] = None
    return _EVAL_LPIPS[key]


@torch.no_grad()
def evaluate_splits(model, scene, model_cfg: ModelConfig,
                    pipe_cfg: PipelineConfig, state: StepState,
                    flame_fixed: dict, tb_writer=None, iteration: int = 0,
                    num_vis_img: int = 10) -> dict:
    """Mean L1, PSNR, SSIM and, when the LPIPS weights exist, LPIPS of the
    val (novel view) and test (self-reenactment) splits, rendered with the
    state's parameters against the clamped ground truth (reference
    train.py:256-314). Returns {split: {"l1_loss", "psnr", "ssim"[,
    "lpips"]}} for the splits that have cameras.

    With `tb_writer`, every (len(cameras) // num_vis_img)-th view's render
    and error map (`utils/image.py::error_map`) are written as images
    `<split>_<k>/render` and `<split>_<k>/error` at step `iteration`."""
    from gaussianavatars_torch.data.loader import iterate_once
    from gaussianavatars_torch.utils.image import error_map

    bound = model.binding is not None
    flame_full = {**flame_fixed, **state.flame_tr} if bound else {}
    dev = model.device
    results = {}
    for split, cameras in (("val", scene.get_val_cameras()),
                           ("test", scene.get_test_cameras())):
        if not cameras:
            continue
        lpips_fn = _eval_lpips(dev)
        render_fns = {}
        l1s, psnrs, ssims, lpipses = [], [], [], []
        vis_every, vis_ct = max(len(cameras) // num_vis_img, 1), 0
        for idx, (cam, gt) in enumerate(
                iterate_once(cameras, model_cfg.resolution, device=dev)):
            w, h = cam.resolution(model_cfg.resolution)
            if (w, h) not in render_fns:
                render_fns[w, h] = make_render_fn(model, pipe_cfg, w, h,
                                                  model.active_sh_degree)
            img = render_fns[w, h](
                state.params, flame_full, model.binding,
                camera_arrays(cam.to_params(w, h, device=dev)),
                torch.tensor(cam.bg, dtype=torch.float32, device=dev),
                cam.timestep or 0).image.clamp(0.0, 1.0)
            gt_t = torch.tensor(gt, device=dev).clamp(0.0, 1.0)
            l1s.append(l1_loss(img, gt_t))
            psnrs.append(psnr(img, gt_t)[0])
            ssims.append(ssim(img, gt_t))
            if lpips_fn is not None:
                lpipses.append(lpips_fn(img, gt_t)[0])
            if tb_writer is not None and idx % vis_every == 0:
                img_h, gt_h = img.cpu().numpy(), gt_t.cpu().numpy()
                tb_writer.add_images(f"{split}_{vis_ct}/render", img_h[None],
                                     global_step=iteration)
                tb_writer.add_images(f"{split}_{vis_ct}/error",
                                     error_map(img_h, gt_h)[None],
                                     global_step=iteration)
                vis_ct += 1
        results[split] = {
            "l1_loss": float(torch.stack(l1s).mean()),
            "psnr": float(torch.stack(psnrs).mean()),
            "ssim": float(torch.stack(ssims).mean()),
        }
        if lpipses:
            results[split]["lpips"] = float(torch.stack(lpipses).mean())
    return results
