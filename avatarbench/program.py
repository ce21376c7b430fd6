"""The measured program, `gaussianavatars_torch`, driven through its public
entries: the model classes, `config.py`, `train/loop.py::make_train_step`
and `make_render_fn`, and the viewer's `to_wire` frame conversion. This
is the only module of the benchmark that imports the program; it hands
the program copies of the benchmark's inputs and reads back only what its
entries return.
"""

from __future__ import annotations

import numpy as np
import torch

from gaussianavatars_torch.config import OptimizationConfig, PipelineConfig
from gaussianavatars_torch.device import resolve_device
from gaussianavatars_torch.models.flame import FlameHead
from gaussianavatars_torch.models.flame_gaussians import FlameGaussianModel
from gaussianavatars_torch.models.gaussians import (
    GaussianModel,
    GaussianParams,
)
from gaussianavatars_torch.train.loop import (
    CameraArrays,
    initial_state,
    lr_pytree,
    make_render_fn,
    make_train_step,
)
from gaussianavatars_torch.viewer.network_gui import to_wire

__all__ = ["Program", "camera_arrays", "to_wire"]

def _meshes(motion: dict, n_verts: int) -> dict:
    """The motion as the dataset meshes `load_meshes` takes, one dict of
    FLAME parameters per timestep."""
    t = motion["expr"].shape[0]
    keys = ("expr", "rotation", "neck_pose", "jaw_pose", "eyes_pose",
            "translation")
    return {i: dict(shape=motion["shape"],
                    static_offset=np.zeros((n_verts, 3), np.float32),
                    **{k: motion[k][i] for k in keys}) for i in range(t)}


class Program:
    """One model of the program with its train step or its render.

    `params` (raw Gaussian parameters, copied) and `binding` come from the
    benchmark; a bound model also takes the FLAME files and the motion.
    """

    def __init__(self, cfg: dict, params: dict, binding, device,
                 flame_paths: dict | None = None, motion: dict | None = None,
                 parts_path: str | None = None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.pipe = PipelineConfig(tile_size=cfg["tile_size"],
                                   binning=cfg["binning"])
        opt = cfg["optimization"]
        self.opt = OptimizationConfig(**opt)
        gp = GaussianParams(**{k: v.detach().clone().contiguous()
                               for k, v in params.items()})
        if binding is None:
            model = GaussianModel(cfg["sh_degree"], gp)
        else:
            head = FlameHead(
                300, 100, flame_model_path=flame_paths["model"],
                flame_template_mesh_path=flame_paths["obj"],
                flame_lmk_embedding_path=flame_paths["lmk"],
                flame_parts_path=parts_path, device=self.device)
            model = FlameGaussianModel(
                cfg["sh_degree"], head,
                not_finetune_flame_params=not cfg["finetune_flame"])
            model.load_meshes(_meshes(motion, 5023), {})
            model.params = gp
            model.binding = binding.clone()
            model.binding_counter = torch.bincount(model.binding,
                                                   minlength=head.num_faces)
        model.spatial_lr_scale = cfg["spatial_lr_scale"]
        model.reset_stats()
        self.model = model
        self.bound = binding is not None

    # ---- training ---------------------------------------------------------

    def train_step(self, width: int, height: int):
        """The train step, its state, the fixed FLAME parameters and the
        learning rates (xyz at `position_lr_init`, the start of the
        schedule)."""
        m = self.model
        step = make_train_step(m, self.opt, self.pipe, width, height,
                               self.cfg["sh_degree"], m.num_timesteps)
        state = initial_state(m)
        fixed = ({k: v for k, v in m.flame_param.items()
                  if k not in state.flame_tr} if self.bound else {})
        lrs = lr_pytree(self.opt, self.opt.position_lr_init
                        * m.spatial_lr_scale, state.flame_tr,
                        m.spatial_lr_scale)
        return step, state, fixed, lrs

    # ---- serving ----------------------------------------------------------

    def render_fn(self, width: int, height: int):
        return make_render_fn(self.model, self.pipe, width, height,
                              self.cfg["sh_degree"])


def camera_arrays(cam: dict) -> CameraArrays:
    return CameraArrays(viewmatrix=cam["viewmatrix"],
                        projmatrix=cam["projmatrix"], campos=cam["campos"],
                        tan_fovx=cam["tan_fovx"], tan_fovy=cam["tan_fovy"])
