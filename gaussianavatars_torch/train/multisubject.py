"""Multi-subject training (port of `gaussianavatars_tpu/train/multisubject.py`).

S avatars train together, one per 'data' group of the process mesh, through
`parallel/sharded.py::make_multisubject_train_step`. Subjects share the
FLAME topology but own their Gaussians, FLAME trainables, Adam moments and
densification statistics; each is driven by its own FLAME head (the JAX
step drives every subject with the first subject's, the same where the
heads are, as its trainer requires). Where the mesh has fewer data groups than
subjects, each rank runs its subjects in turn through the step: on the
local mesh (one process, one card) every subject takes its turn, the
single-card multi-tenant mode that `bench_multisubject.py` measures.

Each subject densifies on its own and keeps its exact Gaussian count: the
JAX package's common capacity bucket (`_align_capacity`, `_restack` /
`_unstack` and the re-jit cache) is not ported.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from gaussianavatars_torch.parallel.sharded import (
    gather_state,
    make_multisubject_train_step,
    shard_state,
)
from gaussianavatars_torch.train import optim
from gaussianavatars_torch.train.loop import (
    StepState,
    _adam,
    _after_surgery,
    lr_pytree,
)
from gaussianavatars_torch.utils.schedules import expon_lr


class MultiSubjectTrainer:
    """Drives S subjects through the multi-subject step.

    Args:
      models: the S bound FlameGaussianModels (one FLAME topology), on
        every rank; a rank trains the subjects of its data group: d, d +
        n_data, d + 2 n_data, ...
      mesh: the ('data', 'prim') mesh of `parallel/mesh.py`; S must be a
        multiple of mesh.shape["data"].
      opt_cfg / pipe_cfg: shared hyperparameters.
      width / height: the training resolution (shared).
      extents: per-subject scene extents (densification thresholds).
    """

    def __init__(self, models: Sequence, mesh, opt_cfg, pipe_cfg,
                 width: int, height: int, extents: Sequence[float]):
        self.models = list(models)
        self.mesh = mesh
        self.opt_cfg = opt_cfg
        self.extents = list(extents)
        n_data = mesh.shape["data"]
        if len(self.models) % n_data:
            raise ValueError(f"{len(self.models)} subjects over {n_data} "
                             "data groups")
        self.mine = list(range(mesh.data_index, len(self.models), n_data))
        self.states, self.flame_fixed, self.steps = {}, {}, {}
        for i in self.mine:
            m = self.models[i]
            flame_tr = m.flame_trainable()
            mu, nu, count = optim.init({"gauss": m.params, "flame": flame_tr})
            self.states[i] = shard_state(StepState(
                params=m.params, flame_tr=flame_tr, mu=mu, nu=nu,
                count=count, max_radii2d=m.max_radii2d,
                grad_accum=m.xyz_gradient_accum, denom=m.denom), mesh)
            self.flame_fixed[i] = {k: v for k, v in m.flame_param.items()
                                   if k not in flame_tr}
            self.steps[i] = make_multisubject_train_step(
                mesh, m, opt_cfg, pipe_cfg, width, height, m.max_sh_degree)

    def _full(self, i: int) -> StepState:
        """Subject i's full state, written back into its model."""
        m = self.models[i]
        full = gather_state(self.states[i], self.mesh, m.num_gaussians)
        m.params = full.params
        m.max_radii2d = full.max_radii2d
        m.xyz_gradient_accum = full.grad_accum
        m.denom = full.denom
        m.merge_flame_trainable(full.flame_tr)
        return full

    def train(self, batch_fn: Callable, first_iter: int, last_iter: int,
              *, densify: bool = True, log: Callable = lambda *_: None):
        """Run iterations [first_iter, last_iter] (1-based, inclusive);
        returns the last iteration's losses, the mean over the subjects.

        batch_fn(subject_index, iteration) -> (CameraArrays, gt [3, H, W],
        bg [3], timestep) supplies each subject's view for the step.
        """
        opt = self.opt_cfg
        scale = self.models[0].spatial_lr_scale
        losses = {}
        for iteration in range(first_iter, last_iter + 1):
            xyz_lr = float(expon_lr(
                iteration, opt.position_lr_init * scale,
                opt.position_lr_final * scale, opt.position_lr_delay_mult,
                opt.position_lr_max_steps))
            lrs = lr_pytree(opt, xyz_lr, self.states[self.mine[0]].flame_tr,
                            scale)
            turns, timesteps = [], {}
            for i in self.mine:
                cam, gt, bg, timestep = batch_fn(i, iteration)
                timesteps[i] = int(timestep)
                n = self.models[i].num_gaussians
                self.states[i], turn, _ = self.steps[i](
                    self.states[i], self.flame_fixed[i],
                    self.models[i].binding[self.mesh.shard(n)], cam, gt, bg,
                    timesteps[i], lrs, n)
                turns.append(turn)
            losses = {k: sum(t[k] for t in turns) / len(turns)
                      for k in turns[0]}

            if not densify or iteration >= opt.densify_until_iter:
                continue
            hit_densify = (iteration > opt.densify_from_iter
                           and iteration % opt.densification_interval == 0)
            hit_reset = iteration % opt.opacity_reset_interval == 0
            if not (hit_densify or hit_reset):
                continue
            for i in self.mine:
                m, full = self.models[i], self._full(i)
                adam = _adam(full)
                if hit_densify:
                    size_threshold = (20 if iteration
                                      > opt.opacity_reset_interval else None)
                    with torch.no_grad():
                        face_scaling = m.face_frames_at(
                            m.flame_param, timesteps[i]).scaling
                    adam = m.densify_and_prune(
                        adam, opt.densify_grad_threshold, 0.005,
                        self.extents[i], size_threshold, opt.percent_dense,
                        face_scaling, seed=iteration,
                        screen_size_prune=opt.screen_size_prune)
                    log(f"[multisubject] subject {i}: {m.num_gaussians} "
                        "Gaussians")
                if hit_reset:
                    adam = m.reset_opacity(adam)
                self.states[i] = shard_state(_after_surgery(m, full, adam),
                                             self.mesh)
        for i in self.mine:
            self._full(i)
        return losses

