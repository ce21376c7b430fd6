"""Render-parallel render and the data x render-parallel train steps over
the ('data', 'prim') process mesh (port of
`gaussianavatars_tpu/parallel/sharded.py`).

The splatting pipeline splits across the `prim` axis in two phases, as in
the JAX package:

  phase 1 (Gaussian-sharded): the binding chain and the EWA projection run
      on each rank's contiguous shard of the Gaussians
  exchange: an all-gather of the projected Gaussians (`GatherRows`) in rank
      order, so the gathered set keeps the global order and the dense
      binning's stable depth sort breaks ties as on one device
  phase 2 (tile-sharded): each rank bins and blends only its window of
      ceil(nty / n_prim) tile rows (kernel K1 on a slab with a row offset,
      K2 in the step's backward); the slabs are gathered into the image

The gather's backward is a reduce-scatter: the per-Gaussian gradients of
every rank's slab are summed onto the rank that owns the Gaussians, where
their Adam state lives.

Loss weighting under replication: every prim rank computes the image loss
on the same gathered image, so each weights it by 1/n_prim, and the
reduce-scatter of the image gather's backward sums the n_prim cotangents
back to one full gradient. The xyz and scale regularizers are partial sums
over the shard divided by the global visible count; the FLAME regularizers
(computed on the replicated FLAME parameters) carry 1/n_prim, and the
FLAME gradients are summed over prim.

The shards are exact: rank p holds rows [p r, min((p + 1) r, N)) of the N
Gaussians, r = ceil(N / n_prim). The last shards may hold fewer rows (or
none); the gather pads them with rows that are invalid and of radius 0, so
the binning skips them and the backward drops them. The JAX package's
`gather_chunks` (a device of XLA's latency-hiding scheduler with one
gather's forward and backward) is not ported.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from gaussianavatars_torch.models.flame_gaussians import (
    face_frames_from_verts,
)
from gaussianavatars_torch.models.gaussians import (
    GaussianParams,
    world_space_gaussians,
)
from gaussianavatars_torch.ops.binning_dense import tile_grid
from gaussianavatars_torch.ops.projection import (
    ProjectedGaussians,
    project_gaussians,
)
from gaussianavatars_torch.ops.rasterize_tiles import rasterize
from gaussianavatars_torch.ops.ssim import ssim
from gaussianavatars_torch.parallel.mesh import Mesh
from gaussianavatars_torch.train import optim
from gaussianavatars_torch.train.loop import (
    StepState,
    _camera,
    _check_pipeline,
    _flame_regularizers,
)
from gaussianavatars_torch.train.losses import safe_norm
from gaussianavatars_torch.utils.image import l1_loss


class GatherRows(torch.autograd.Function):
    """All-gather of one block of `rows` rows from every rank of `group`,
    concatenated in rank order; a block of n < rows rows is padded with
    zero rows. The backward sums the cotangents over the group and keeps
    this rank's n rows (`reduce_scatter_tensor`; gloo takes CUDA tensors
    for both collectives, as NCCL does)."""

    @staticmethod
    def forward(ctx, x, rows, group):
        n = x.shape[0]
        if n < rows:
            x = torch.cat([x, x.new_zeros((rows - n,) + x.shape[1:])])
        size = dist.get_world_size(group)
        out = x.new_empty((size * rows,) + x.shape[1:])
        dist.all_gather_into_tensor(out, x.contiguous(), group=group)
        ctx.meta = (n, rows, group)
        return out

    @staticmethod
    def backward(ctx, grad):
        n, rows, group = ctx.meta
        out = grad.new_empty((rows,) + grad.shape[1:])
        dist.reduce_scatter_tensor(out, grad.contiguous(), group=group)
        return out[:n], None, None


def gather_rows(x: torch.Tensor, rows: int, mesh: Mesh,
                axis: str = "prim") -> torch.Tensor:
    """`GatherRows` over the mesh axis (differentiable); the identity on the
    local mesh."""
    if mesh.local:
        return x
    return GatherRows.apply(x, rows, mesh.group(axis))


def all_reduce(tensors: list, mesh: Mesh, axis: str, op: str = "sum"):
    """Reduce the tensors over the mesh axis ("sum", "mean" or "max") in one
    collective; returns new tensors (the inputs where the axis has one
    rank, which runs no collective)."""
    if mesh.local or mesh.shape[axis] == 1 or not tensors:
        return list(tensors)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.MAX if op == "max"
                    else dist.ReduceOp.SUM, group=mesh.group(axis))
    if op == "mean":
        flat = flat / mesh.shape[axis]
    parts = torch.split(flat, [t.numel() for t in tensors])
    return [p.reshape(t.shape) for p, t in zip(parts, tensors)]


def _gather_projected(proj: ProjectedGaussians, rows: int,
                      mesh: Mesh) -> ProjectedGaussians:
    """Every rank's projected shard, in rank order: the differentiable
    (means2d, conics, colors, opacities) in one gather, the binning's
    inputs (depths, tau, extents, radii, valid) in another. Padding rows
    come out invalid with radius 0. `r2_max` is not gathered (None)."""
    diff = torch.cat([proj.means2d, proj.conics, proj.colors,
                      proj.opacities[:, None]], dim=1)
    with torch.no_grad():
        aux = torch.stack([proj.depths, proj.tau, proj.ext_x, proj.ext_y,
                           proj.radii.to(torch.float32),
                           proj.valid.to(torch.float32)], dim=1)
        aux = gather_rows(aux, rows, mesh)
    diff = gather_rows(diff, rows, mesh)
    return ProjectedGaussians(
        means2d=diff[:, 0:2], depths=aux[:, 0], conics=diff[:, 2:5],
        colors=diff[:, 5:8], opacities=diff[:, 8],
        radii=aux[:, 4].to(torch.int32), valid=aux[:, 5] > 0.5,
        r2_max=None, ext_x=aux[:, 2], ext_y=aux[:, 3], tau=aux[:, 1])


def _gathered_render(mesh: Mesh, params: GaussianParams, binding, frames,
                     camera, bg, sh_degree: int, tile_size: int,
                     rows_per: int, rows: int, means2d_offset=None):
    """Project the local shard, gather the projected set, bin and blend this
    rank's window of `rows_per` tile rows. Returns (slab [3, rows_per *
    tile_size, W], the local ProjectedGaussians, the slab's instance total,
    the local [n, 1] face scale or None)."""
    means3d, scales, quats, opac, shs, face_scale = world_space_gaussians(
        params, binding, frames, return_face_scale=True)
    proj = project_gaussians(means3d, scales, quats, opac, shs, sh_degree,
                             camera, means2d_offset=means2d_offset)
    out = rasterize(None, None, None, None, None, sh_degree, camera, bg,
                    tile_size=tile_size,
                    tile_row_start=mesh.prim_index * rows_per,
                    tile_rows=rows_per,
                    projected=_gather_projected(proj, rows, mesh))
    return out.image, proj, out.instance_total, face_scale


def _gather_image(slab, mesh: Mesh, height: int) -> torch.Tensor:
    """The prim ranks' slabs [3, h, W] as one [3, height, W] image (rows
    past the image cropped), differentiable."""
    rows = gather_rows(slab.permute(1, 2, 0), slab.shape[1], mesh)
    return rows[:height].permute(2, 0, 1)


def _rows_per(width: int, height: int, tile_size: int, mesh: Mesh) -> int:
    return -(-tile_grid(width, height, tile_size)[1] // mesh.shape["prim"])


def make_sharded_render(mesh: Mesh, width: int, height: int, sh_degree: int,
                        tile_size: int = 32, bound: bool = True):
    """Single-camera render sharded over the 'prim' axis.

    Returns render(params, binding, frames, cam, bg) -> [3, H, W], the same
    image on every rank: `params` (GaussianParams) and `binding` are the
    full, replicated model (binding None when not `bound`); each rank
    projects its shard of them. `frames` are the driven mesh's FaceFrames
    (None unbound), `cam` a `train/loop.py::CameraArrays`.
    """
    rows_per = _rows_per(width, height, tile_size, mesh)

    @torch.no_grad()
    def render(params, binding, frames, cam, bg) -> torch.Tensor:
        n = params.xyz.shape[0]
        rows = mesh.shard(n)
        slab, _, _, _ = _gathered_render(
            mesh, GaussianParams(*[p[rows] for p in params]),
            binding[rows] if bound else None, frames if bound else None,
            _camera(cam, width, height), bg, sh_degree, tile_size, rows_per,
            mesh.shard_rows(n))
        return _gather_image(slab, mesh, height).contiguous()

    return render


def _make_step(mesh: Mesh, model, opt_cfg, pipe_cfg, width: int,
               height: int, sh_degree: int, subjects: bool):
    _check_pipeline(pipe_cfg)
    if pipe_cfg.convert_SHs_python or pipe_cfg.compute_cov3D_python:
        raise NotImplementedError(
            "the sharded train steps take no pipeline options (nor do the "
            "JAX package's)")
    bound = model.binding is not None
    n_prim = mesh.shape["prim"]
    tile_size = pipe_cfg.tile_size
    rows_per = _rows_per(width, height, tile_size, mesh)
    opt = opt_cfg

    def step(state: StepState, flame_fixed: dict, binding, cam, gt_image,
             bg, timestep: int, lrs: dict, num_gaussians: int):
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
                flame_full = {**flame_fixed, **flame_tr}
                verts, verts_cano = model.verts_at(flame_full, timestep,
                                                   return_verts_cano=True)
                frames = face_frames_from_verts(verts[0],
                                                model.flame_model.faces)
            slab, proj, instances, face_scale = _gathered_render(
                mesh, params, binding if bound else None, frames, camera,
                bg, sh_degree, tile_size, rows_per,
                mesh.shard_rows(num_gaussians), means2d_offset=offset)
            image = _gather_image(slab, mesh, height)

            # replication-weighted image terms (module docstring)
            losses = {
                "l1": l1_loss(image, gt_image)
                * (1.0 - opt.lambda_dssim) / n_prim,
                "ssim": (1.0 - ssim(image, gt_image))
                * opt.lambda_dssim / n_prim,
            }
            if bound:
                vis = proj.valid.to(torch.float32)
                visible, = all_reduce([vis.sum()], mesh, "prim")
                visible = torch.clamp(visible, min=1.0)
                if opt.metric_xyz:
                    val = safe_norm(torch.relu(
                        params.xyz * face_scale - opt.threshold_xyz), dim=1)
                else:
                    val = torch.relu(safe_norm(params.xyz, dim=1)
                                     - opt.threshold_xyz)
                losses["xyz"] = (torch.sum(val * vis) / visible
                                 * opt.lambda_xyz)
                if opt.lambda_scale != 0.0:
                    scale = torch.exp(params.scaling)
                    if opt.metric_scale:
                        scale = scale * face_scale
                    val = safe_norm(torch.relu(scale - opt.threshold_scale),
                                    dim=1)
                    losses["scale"] = (torch.sum(val * vis) / visible
                                       * opt.lambda_scale)
                if not subjects:
                    regs = {}
                    _flame_regularizers(model, opt, flame_full, timestep,
                                        verts_cano, 0.0, regs)
                    losses.update({k: v / n_prim for k, v in regs.items()})
            total = sum(losses.values())
            leaves = [*params, *flame_tr.values(), offset]
            grads = torch.autograd.grad(total, leaves, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g
                 for x, g in zip(leaves, grads)]
        n_p = len(params)
        g_params, g_flame, g_offset = grads[:n_p], grads[n_p:-1], grads[-1]
        if not subjects:
            # the loss is the mean over the camera batch: average every
            # gradient over 'data' (FLAME's before its sum over 'prim')
            mean = all_reduce([*g_params, *g_flame], mesh, "data", "mean")
            g_params, g_flame = mean[:n_p], mean[n_p:]
        g_flame = all_reduce(g_flame, mesh, "prim")

        new_p, mu, nu, count = optim.apply(
            {"gauss": state.params, "flame": state.flame_tr},
            {"gauss": GaussianParams(*g_params),
             "flame": dict(zip(flame_tr, g_flame))},
            state.mu, state.nu, state.count, lrs)

        with torch.no_grad():
            vis = proj.valid
            accum = torch.where(vis, torch.linalg.norm(g_offset, dim=-1), 0.0)
            denom = vis.to(torch.float32)
            radii = torch.where(vis, proj.radii.to(torch.float32), 0.0)
            if not subjects:
                # every data group saw another camera of the batch
                accum, denom = all_reduce([accum, denom], mesh, "data")
                radii, = all_reduce([radii], mesh, "data", "max")
            state.grad_accum.add_(accum)
            state.denom.add_(denom)
            torch.maximum(state.max_radii2d, radii, out=state.max_radii2d)

            # the true totals: sum over prim, mean over data (the subjects)
            names = list(losses)
            values = torch.stack([losses[k].detach().reshape(())
                                  for k in names])
            values, = all_reduce([values], mesh, "prim")
            values, = all_reduce([values], mesh, "data", "mean")
            losses = dict(zip(names, values.unbind()))
            losses["total"] = sum(losses.values())
            if not mesh.local:
                worst = torch.tensor([instances], device=values.device)
                worst, = all_reduce([worst], mesh, "prim", "max")
                worst, = all_reduce([worst], mesh, "data", "max")
                instances = int(worst.item())
        new_state = StepState(
            params=new_p["gauss"], flame_tr=new_p["flame"], mu=mu, nu=nu,
            count=count, max_radii2d=state.max_radii2d,
            grad_accum=state.grad_accum, denom=state.denom)
        return new_state, losses, instances

    return step


def make_sharded_train_step(mesh: Mesh, model, opt_cfg, pipe_cfg,
                            width: int, height: int, sh_degree: int):
    """Data x render-parallel train step (module docstring).

    Returns step(state, flame_fixed, binding, cam, gt_image, bg, timestep,
    lrs, num_gaussians) -> (state, losses, instance_total), the contract of
    `train/loop.py::make_train_step` on this rank's part: `state` holds the
    rank's prim shard of the Gaussian parameters, their Adam moments and
    statistics (updated in place) and the replicated FLAME trainables and
    moments; `binding` is the shard's binding; `cam`, `gt_image`, `bg` and
    `timestep` are this data group's view of the batch; `num_gaussians` is
    the model's total. The loss is the mean over 'data'; Gaussian gradients
    are averaged over 'data', FLAME gradients averaged over 'data' and
    summed over 'prim'; Adam runs on the shard with the shared count;
    `grad_accum` and `denom` sum over 'data' and `max_radii2d` takes the
    max. The losses are the true totals on every rank; instance_total is
    the largest slab's.
    """
    return _make_step(mesh, model, opt_cfg, pipe_cfg, width, height,
                      sh_degree, subjects=False)


def make_multisubject_train_step(mesh: Mesh, model, opt_cfg, pipe_cfg,
                                 width: int, height: int, sh_degree: int):
    """Multi-subject step: one avatar per 'data' group (port of the JAX
    package's batched multi-subject step).

    The contract of `make_sharded_train_step`, with `state` (and the view)
    this data group's subject: subjects share the FLAME topology (`model`'s
    head) and own their Gaussians, FLAME trainables, moments and
    statistics, so nothing is averaged over 'data' and the FLAME gradients
    are summed over the subject's prim ranks only. The loss is L1 + D-SSIM
    + xyz + scale: no FLAME regularizers. The losses are the mean over the
    subjects of this step.
    """
    return _make_step(mesh, model, opt_cfg, pipe_cfg, width, height,
                      sh_degree, subjects=True)


def shard_state(state: StepState, mesh: Mesh) -> StepState:
    """This rank's prim shard of a full step state (copies of its rows of
    the Gaussian parameters, moments and statistics; the FLAME parts as
    they are)."""
    if mesh.local:
        return state
    rows = mesh.shard(state.params.xyz.shape[0])

    def cut(tree):
        return optim.tree_map(lambda t: t[rows].clone(), tree)

    return StepState(
        params=cut(state.params), flame_tr=state.flame_tr,
        mu={"gauss": cut(state.mu["gauss"]), "flame": state.mu["flame"]},
        nu={"gauss": cut(state.nu["gauss"]), "flame": state.nu["flame"]},
        count=state.count, max_radii2d=cut(state.max_radii2d),
        grad_accum=cut(state.grad_accum), denom=cut(state.denom))


@torch.no_grad()
def gather_state(state: StepState, mesh: Mesh, num_gaussians: int
                 ) -> StepState:
    """The full step state on every rank from the prim shards (one gather of
    every per-Gaussian column)."""
    if mesh.local:
        return state
    leaves = [*state.params, *state.mu["gauss"], *state.nu["gauss"],
              state.max_radii2d, state.grad_accum, state.denom]
    n_local = state.params.xyz.shape[0]
    cols = [t.reshape(n_local, math.prod(t.shape[1:])) for t in leaves]
    full = gather_rows(torch.cat(cols, dim=1), mesh.shard_rows(num_gaussians),
                       mesh)[:num_gaussians]
    parts = torch.split(full, [c.shape[1] for c in cols], dim=1)
    out = [p.reshape((num_gaussians,) + t.shape[1:]).contiguous()
           for p, t in zip(parts, leaves)]
    n_p = len(GaussianParams._fields)
    return StepState(
        params=GaussianParams(*out[:n_p]), flame_tr=state.flame_tr,
        mu={"gauss": GaussianParams(*out[n_p:2 * n_p]),
            "flame": state.mu["flame"]},
        nu={"gauss": GaussianParams(*out[2 * n_p:3 * n_p]),
            "flame": state.nu["flame"]},
        count=state.count, max_radii2d=out[-3], grad_accum=out[-2],
        denom=out[-1])
