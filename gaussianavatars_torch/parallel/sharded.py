"""Render-parallel rasterization and the train step's collectives over the
('data', 'prim') process mesh (port of `gaussianavatars_tpu/parallel/
sharded.py`).

The train step is `train/loop.py::make_train_step` on every mesh; what it
does differently on a mesh of several ranks lives here, each piece the
identity where its axis has one rank.

The splatting pipeline splits across the `prim` axis in two phases, as in
the JAX package:

  phase 1 (Gaussian-sharded): the binding chain and the EWA projection run
      on each rank's contiguous shard of the Gaussians
  exchange: an all-gather of the projected Gaussians (`GatherRows`) in rank
      order, so the gathered set keeps the global order and either
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
over the shard divided by the global visible count
(`train/losses.py::compute_losses`); the FLAME regularizers (computed on
the replicated FLAME parameters) carry 1/n_prim, and the FLAME gradients
are summed over prim.

The shards are exact: rank p holds rows [p r, min((p + 1) r, N)) of the N
Gaussians, r = ceil(N / n_prim). The last shards may hold fewer rows (or
none); the gather pads them with rows that are invalid and of radius 0, so
the binning skips them and the backward drops them. The JAX package's
`gather_chunks` (a device of XLA's latency-hiding scheduler with one
gather's forward and backward) is not ported.

`make_sharded_train_step` and `make_multisubject_train_step` keep the JAX
package's names for that step; nothing else here reaches into `train/`.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from gaussianavatars_torch.models.gaussians import (
    GaussianParams,
    world_space_gaussians,
)
from gaussianavatars_torch.ops.binning_dense import tile_grid
from gaussianavatars_torch.ops.projection import (
    CameraParams,
    ProjectedGaussians,
    project_gaussians,
)
from gaussianavatars_torch.ops.rasterize_tiles import RenderOutput, rasterize
from gaussianavatars_torch.parallel.mesh import Mesh


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
    """`GatherRows` over the mesh axis (differentiable); the identity where
    the axis has one rank."""
    if mesh.shape[axis] == 1:
        return x
    return GatherRows.apply(x, rows, mesh.group(axis))


def all_reduce(tensors: list, mesh: Mesh, axis: str, op: str = "sum"):
    """Reduce the tensors over the mesh axis ("sum", "mean" or "max") in one
    collective; returns new tensors (the inputs where the axis has one
    rank, which runs no collective)."""
    if mesh.shape[axis] == 1 or not tensors:
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
    (means2d, conics, colors, opacities) in one gather, the binnings'
    inputs (depths, tau, extents, radii, valid, r2_max) in another.
    Padding rows come out invalid with radius 0."""
    diff = torch.cat([proj.means2d, proj.conics, proj.colors,
                      proj.opacities[:, None]], dim=1)
    with torch.no_grad():
        aux = torch.stack([proj.depths, proj.tau, proj.ext_x, proj.ext_y,
                           proj.radii.to(torch.float32),
                           proj.valid.to(torch.float32), proj.r2_max], dim=1)
        aux = gather_rows(aux, rows, mesh)
    diff = gather_rows(diff, rows, mesh)
    return ProjectedGaussians(
        means2d=diff[:, 0:2], depths=aux[:, 0], conics=diff[:, 2:5],
        colors=diff[:, 5:8], opacities=diff[:, 8],
        radii=aux[:, 4].to(torch.int32), valid=aux[:, 5] > 0.5,
        r2_max=aux[:, 6], ext_x=aux[:, 2], ext_y=aux[:, 3], tau=aux[:, 1])


def rasterize_on(mesh: Mesh, means3d, scales, quats, opacities, shs,
                 sh_degree: int, camera: CameraParams, bg, *,
                 num_gaussians: int, tile_size: int = 32,
                 binning: str = "dense", mark=None, **options) -> RenderOutput:
    """`rasterize` of this rank's shard of `num_gaussians` world-space
    Gaussians over the mesh's prim axis (module docstring).

    Where the axis has one rank this is `rasterize` itself. Otherwise the
    shard is projected (`options` are `project_gaussians`'), the projected
    set gathered, binned (`binning`) and blended on this rank's slab of
    tile rows, and the slabs gathered into the image: the full image on
    every rank, the slab's transmittance and instance total, the shard's
    radii and visibility. `mark` is `rasterize`'s.
    """
    if mesh.shape["prim"] == 1:
        return rasterize(means3d, scales, quats, opacities, shs, sh_degree,
                         camera, bg, tile_size=tile_size, binning=binning,
                         mark=mark, **options)
    proj = project_gaussians(means3d, scales, quats, opacities, shs,
                             sh_degree, camera, **options)
    rows_per = -(-tile_grid(camera.width, camera.height, tile_size)[1]
                 // mesh.shape["prim"])
    out = rasterize(None, None, None, None, None, sh_degree, camera, bg,
                    tile_size=tile_size,
                    tile_row_start=mesh.prim_index * rows_per,
                    tile_rows=rows_per, binning=binning, mark=mark,
                    projected=_gather_projected(
                        proj, mesh.shard_rows(num_gaussians), mesh))
    return out._replace(image=_gather_image(out.image, mesh, camera.height),
                        radii=proj.radii, visibility=proj.valid)


def _gather_image(slab, mesh: Mesh, height: int) -> torch.Tensor:
    """The prim ranks' slabs [3, h, W] as one [3, height, W] image (rows
    past the image cropped), differentiable."""
    rows = gather_rows(slab.permute(1, 2, 0), slab.shape[1], mesh)
    return rows[:height].permute(2, 0, 1)


def make_sharded_render(mesh: Mesh, width: int, height: int, sh_degree: int,
                        tile_size: int = 32, bound: bool = True,
                        binning: str = "dense"):
    """Single-camera render sharded over the 'prim' axis.

    Returns render(params, binding, frames, cam, bg) -> [3, H, W], the same
    image on every rank: `params` (GaussianParams) and `binding` are the
    full, replicated model (binding None when not `bound`); each rank
    projects its shard of them. `frames` are the driven mesh's FaceFrames
    (None unbound), `cam` a `train/loop.py::CameraArrays`. `binning`
    ("dense" or "sort") picks the slab's instance stream, as in `rasterize`.
    """

    @torch.no_grad()
    def render(params, binding, frames, cam, bg) -> torch.Tensor:
        n = params.xyz.shape[0]
        rows = mesh.shard(n)
        gaussians = world_space_gaussians(
            GaussianParams(*[p[rows] for p in params]),
            binding[rows] if bound else None, frames if bound else None)
        camera = CameraParams(**cam._asdict(), width=width, height=height)
        return rasterize_on(mesh, *gaussians, sh_degree, camera, bg,
                            num_gaussians=n, tile_size=tile_size,
                            binning=binning).image.contiguous()

    return render


def mesh_totals(losses: dict, instance_total: int, mesh: Mesh):
    """The train step's losses and instance total over the mesh: each term
    summed over prim (each rank holds its part) and averaged over data
    (the batch's cameras, or the subjects), "total" their sum; the largest
    slab's instance total. The arguments as they are on a mesh of one
    rank."""
    if mesh.size == 1:
        return losses, instance_total
    names = [k for k in losses if k != "total"]
    values = torch.stack([losses[k].reshape(()) for k in names])
    values, = all_reduce([values], mesh, "prim")
    values, = all_reduce([values], mesh, "data", "mean")
    losses = dict(zip(names, values.unbind()))
    losses["total"] = sum(losses.values())
    worst = torch.tensor([instance_total], device=values.device)
    worst, = all_reduce([worst], mesh, "prim", "max")
    worst, = all_reduce([worst], mesh, "data", "max")
    return losses, int(worst.item())


def broadcast_flag(flag: bool, mesh: Mesh, device) -> bool:
    """Rank 0's `flag` on every rank of the mesh; `flag` itself on the
    local mesh."""
    if mesh.local:
        return flag
    out = torch.tensor([int(flag)], device=device)
    dist.broadcast(out, 0)
    return bool(out.item())


def make_sharded_train_step(mesh: Mesh, model, opt_cfg, pipe_cfg,
                            width: int, height: int, sh_degree: int):
    """Data x render-parallel train step: `train/loop.py::make_train_step`
    on `mesh` (its docstring gives the contract on a mesh)."""
    from gaussianavatars_torch.train.loop import make_train_step

    return make_train_step(model, opt_cfg, pipe_cfg, width, height,
                           sh_degree, mesh=mesh)


def make_multisubject_train_step(mesh: Mesh, model, opt_cfg, pipe_cfg,
                                 width: int, height: int, sh_degree: int):
    """Multi-subject step: one avatar per 'data' group (port of the JAX
    package's batched multi-subject step).

    `train/loop.py::make_train_step` on `mesh` with `subjects`: `state`
    (and the view) is this data group's subject; subjects share the FLAME
    topology (`model`'s head) and own their Gaussians, FLAME trainables,
    moments and statistics, so nothing is averaged over 'data' and the
    FLAME gradients are summed over the subject's prim ranks only. The
    loss is L1 + D-SSIM + xyz + scale: no FLAME regularizers. The losses
    are the mean over the subjects of this step.
    """
    from gaussianavatars_torch.train.loop import make_train_step

    return make_train_step(model, opt_cfg, pipe_cfg, width, height,
                           sh_degree, mesh=mesh, subjects=True)


def shard_state(state, mesh: Mesh):
    """This rank's prim shard of a full step state (`train/loop.py::
    StepState`: copies of its rows of the Gaussian parameters, moments and
    statistics; the FLAME parts as they are). The state itself where the
    prim axis has one rank."""
    if mesh.shape["prim"] == 1:
        return state
    rows = mesh.shard(state.params.xyz.shape[0])

    def cut(t):
        return t[rows].clone()

    def cut_params(tree):
        return GaussianParams(*map(cut, tree))

    return state._replace(
        params=cut_params(state.params),
        mu={**state.mu, "gauss": cut_params(state.mu["gauss"])},
        nu={**state.nu, "gauss": cut_params(state.nu["gauss"])},
        max_radii2d=cut(state.max_radii2d),
        grad_accum=cut(state.grad_accum), denom=cut(state.denom))


@torch.no_grad()
def gather_state(state, mesh: Mesh, num_gaussians: int):
    """The full step state on every rank from the prim shards (one gather of
    every per-Gaussian column); the state itself where the prim axis has
    one rank."""
    if mesh.shape["prim"] == 1:
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
    return state._replace(
        params=GaussianParams(*out[:n_p]),
        mu={**state.mu, "gauss": GaussianParams(*out[n_p:2 * n_p])},
        nu={**state.nu, "gauss": GaussianParams(*out[2 * n_p:3 * n_p])},
        max_radii2d=out[-3], grad_accum=out[-2], denom=out[-1])
