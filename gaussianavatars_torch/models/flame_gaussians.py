"""Gaussian splats rigged to a FLAME head (port of the serving subset of
`gaussianavatars_tpu/models/flame_gaussians.py`; reference
scene/flame_gaussian_model.py:21-154)."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from gaussianavatars_torch.models.flame import FlameHead
from gaussianavatars_torch.models.gaussians import (
    FaceFrames,
    GaussianModel,
    GaussianParams,
)
from gaussianavatars_torch.ops.quaternion import rotmat_to_quat_components
from gaussianavatars_torch.ops.transforms import _safe_normalize


def face_frames_from_verts(verts: torch.Tensor,
                           faces: torch.Tensor) -> FaceFrames:
    """Per-triangle frames from posed vertices [V, 3]
    (reference flame_gaussian_model.py:137-154, utils/graphics_utils.py:116-135).

    One triangle gather feeds orientation, scale, center and quaternion;
    the packed (F, 17) `table` is what the binding chain gathers.
    """
    tri = verts[faces]                        # (F, 3, 3)
    v0, v1, v2 = tri[:, 0], tri[:, 1], tri[:, 2]

    e01 = v1 - v0
    e02 = v2 - v0
    a0 = _safe_normalize(e01)
    a1 = _safe_normalize(torch.cross(a0, e02, dim=-1))
    a2 = -_safe_normalize(torch.cross(a1, a0, dim=-1))

    s0 = torch.sqrt(torch.clamp(
        torch.sum(e01 * e01, dim=-1, keepdim=True), min=1e-20))
    s1 = torch.abs(torch.sum(a2 * e02, dim=-1, keepdim=True))
    scale = (s0 + s1) / 2.0
    center = (v0 + v1 + v2) / 3.0

    # orient matrix has COLUMNS (a0, a1, a2): row-major rows are
    # [a0x a1x a2x | a0y a1y a2y | a0z a1z a2z]
    flat9 = torch.stack(
        [a0[:, 0], a1[:, 0], a2[:, 0],
         a0[:, 1], a1[:, 1], a2[:, 1],
         a0[:, 2], a1[:, 2], a2[:, 2]], dim=1)
    quat = rotmat_to_quat_components(*flat9.unbind(1))
    table = torch.cat([flat9, scale, center, quat], dim=1)    # (F, 17)
    return FaceFrames(center=center, orient_mat=flat9.reshape(-1, 3, 3),
                      orient_quat=quat, scaling=scale, table=table)


class FlameGaussianModel(GaussianModel):
    """Gaussians bound to the faces of a FLAME head, driven per timestep."""

    def __init__(self, sh_degree: int, flame_head: FlameHead,
                 params: Optional[GaussianParams] = None,
                 binding: Optional[torch.Tensor] = None):
        super().__init__(sh_degree, params)
        self.flame_model = flame_head
        self.binding = binding
        self.flame_param: Optional[dict[str, torch.Tensor]] = None
        self.num_timesteps = 1

    @property
    def device(self) -> torch.device:
        return self.flame_model.v_template.device

    def load_meshes(self, train_meshes: dict, test_meshes: dict,
                    tgt_train_meshes: dict | None = None,
                    tgt_test_meshes: dict | None = None):
        """Build the per-timestep FLAME parameter dict from dataset meshes
        (reference flame_gaussian_model.py:43-89). Shape and static offset
        come from the first mesh; poses and expressions from the target
        meshes when given (reenactment), else from the meshes."""
        if self.flame_param is not None:
            return
        meshes = {**train_meshes, **test_meshes}
        tgt_meshes = {**(tgt_train_meshes or {}), **(tgt_test_meshes or {})}
        pose_meshes = meshes if len(tgt_meshes) == 0 else tgt_meshes
        self.num_timesteps = t = max(pose_meshes) + 1
        num_verts = self.flame_model.num_verts

        first = meshes[min(meshes)]
        static_offset = np.asarray(first["static_offset"], np.float32)
        static_offset = static_offset.reshape(-1, 3)
        if static_offset.shape[0] != num_verts:
            pad = num_verts - static_offset.shape[0]
            static_offset = np.pad(static_offset, ((0, pad), (0, 0)))

        n_expr = np.asarray(first["expr"]).reshape(-1).shape[0]
        param = {
            "shape": np.asarray(first["shape"], np.float32).reshape(-1),
            "expr": np.zeros((t, n_expr), np.float32),
            "rotation": np.zeros((t, 3), np.float32),
            "neck_pose": np.zeros((t, 3), np.float32),
            "jaw_pose": np.zeros((t, 3), np.float32),
            "eyes_pose": np.zeros((t, 6), np.float32),
            "translation": np.zeros((t, 3), np.float32),
            "static_offset": static_offset,
            "dynamic_offset": np.zeros((t, num_verts, 3), np.float32),
        }
        for i, mesh in pose_meshes.items():
            for k in ("expr", "rotation", "neck_pose", "jaw_pose",
                      "eyes_pose", "translation"):
                param[k][i] = np.asarray(mesh[k], np.float32).reshape(
                    param[k][i].shape)
        self.flame_param = {k: torch.as_tensor(v, device=self.device)
                            for k, v in param.items()}

    def verts_at(self, flame_param: dict, timestep: int):
        """FLAME forward at one timestep: verts [1, V, 3]."""
        p = flame_param
        return self.flame_model(
            p["shape"][None],
            p["expr"][timestep][None],
            p["rotation"][timestep][None],
            p["neck_pose"][timestep][None],
            p["jaw_pose"][timestep][None],
            p["eyes_pose"][timestep][None],
            p["translation"][timestep][None],
            static_offset=p["static_offset"][None],
            dynamic_offset=p["dynamic_offset"][timestep][None],
        )

    def face_frames_at(self, flame_param: dict, timestep: int) -> FaceFrames:
        """Frames for the binding chain at one timestep."""
        verts = self.verts_at(flame_param, timestep)
        return face_frames_from_verts(verts[0], self.flame_model.faces)
