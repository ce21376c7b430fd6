"""Gaussian splats rigged to a FLAME head (port of
`gaussianavatars_tpu/models/flame_gaussians.py`; reference
scene/flame_gaussian_model.py:21-269): the per-timestep mesh driving, the
FLAME regularizers and the PLY / motion IO."""

from __future__ import annotations

import os
from pathlib import Path
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

# FLAME parameter groups that get finetuned (reference
# flame_gaussian_model.py:174-217: pose, translation, expression).
FINETUNE_KEYS = ("rotation", "neck_pose", "jaw_pose", "eyes_pose",
                 "translation", "expr")


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
    """Gaussians bound to the faces of a FLAME head, driven per timestep.

    Without a `binding`, the model starts with one Gaussian per face
    (reference :39-41); `binding_counter` [F] counts the Gaussians of each
    face throughout densification.
    """

    def __init__(self, sh_degree: int, flame_head: FlameHead,
                 params: Optional[GaussianParams] = None,
                 binding: Optional[torch.Tensor] = None,
                 not_finetune_flame_params: bool = False,
                 disable_flame_static_offset: bool = False):
        super().__init__(sh_degree, params)
        self.flame_model = flame_head
        self.not_finetune_flame_params = not_finetune_flame_params
        self.disable_flame_static_offset = disable_flame_static_offset
        self.flame_param: Optional[dict[str, torch.Tensor]] = None
        self.flame_param_orig: Optional[dict[str, np.ndarray]] = None
        n_faces = flame_head.num_faces
        if binding is None:
            binding = torch.arange(n_faces, device=self.device)
        self.binding = binding
        self.binding_counter = torch.bincount(binding, minlength=n_faces)

    @classmethod
    def from_assets(cls, sh_degree: int, asset_dir: Optional[str] = None,
                    device: str | torch.device = "cuda",
                    **kwargs) -> "FlameGaussianModel":
        """The model on a FLAME head read from `asset_dir` (`flame2023.pkl`,
        `head_template_mesh.obj` and, where they exist,
        `landmark_embedding_with_eyes.npy` and `FLAME_masks.pkl`; default:
        $FLAME_ASSET_DIR, else flame_model/assets/flame), 300 shape and
        100 expression dims."""
        paths = {}
        if asset_dir is not None:
            paths = dict(
                flame_model_path=os.path.join(asset_dir, "flame2023.pkl"),
                flame_template_mesh_path=os.path.join(
                    asset_dir, "head_template_mesh.obj"),
                flame_lmk_embedding_path=os.path.join(
                    asset_dir, "landmark_embedding_with_eyes.npy"),
                flame_parts_path=os.path.join(asset_dir, "FLAME_masks.pkl"))
        return cls(sh_degree, FlameHead(300, 100, device=device, **paths),
                   **kwargs)

    @property
    def device(self) -> torch.device:
        return self.flame_model.v_template.device

    def load_meshes(self, train_meshes: dict, test_meshes: dict,
                    tgt_train_meshes: dict | None = None,
                    tgt_test_meshes: dict | None = None):
        """Build the per-timestep FLAME parameter dict from dataset meshes
        (reference flame_gaussian_model.py:43-89). Shape and static offset
        come from the first mesh (the static offset is zero with
        `disable_flame_static_offset`); poses and expressions from the
        target meshes when given (reenactment), else from the meshes."""
        if self.flame_param is not None:
            return
        meshes = {**train_meshes, **test_meshes}
        tgt_meshes = {**(tgt_train_meshes or {}), **(tgt_test_meshes or {})}
        pose_meshes = meshes if len(tgt_meshes) == 0 else tgt_meshes
        self.num_timesteps = t = max(pose_meshes) + 1
        num_verts = self.flame_model.num_verts

        first = meshes[min(meshes)]
        if self.disable_flame_static_offset:
            static_offset = np.zeros((num_verts, 3), np.float32)
        else:
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
        self.flame_param_orig = {k: v.copy() for k, v in param.items()}

    def flame_trainable(self) -> dict:
        """The finetuned FLAME subset (the model's own tensors; the train
        step's Adam updates them in place)."""
        if self.not_finetune_flame_params or self.flame_param is None:
            return {}
        return {k: self.flame_param[k] for k in FINETUNE_KEYS}

    def merge_flame_trainable(self, trainable: dict):
        if self.flame_param is not None:
            self.flame_param.update(trainable)

    def verts_at(self, flame_param: dict, timestep: int,
                 return_verts_cano: bool = False):
        """FLAME forward at one timestep: verts [1, V, 3], or (verts,
        canonical verts [1, V, 3]) with `return_verts_cano`."""
        p = flame_param
        return self.flame_model(
            p["shape"][None],
            p["expr"][timestep][None],
            p["rotation"][timestep][None],
            p["neck_pose"][timestep][None],
            p["jaw_pose"][timestep][None],
            p["eyes_pose"][timestep][None],
            p["translation"][timestep][None],
            return_landmarks=False,
            return_verts_cano=return_verts_cano,
            static_offset=p["static_offset"][None],
            dynamic_offset=p["dynamic_offset"][timestep][None],
        )

    def face_frames_at(self, flame_param: dict, timestep: int) -> FaceFrames:
        """Frames for the binding chain at one timestep."""
        verts = self.verts_at(flame_param, timestep)
        return face_frames_from_verts(verts[0], self.flame_model.faces)

    @torch.no_grad()
    def select_mesh_by_timestep(self, timestep: int, original: bool = False):
        """The reference's host API for viewers and renderers: drive the
        mesh at `timestep` (with the dataset's original FLAME parameters if
        `original`), keep `verts`, `verts_cano` and `frames` on the model
        and return the frames."""
        self.timestep = timestep
        param = self.flame_param
        if original and self.flame_param_orig is not None:
            param = {k: torch.as_tensor(v, device=self.device)
                     for k, v in self.flame_param_orig.items()}
        self.verts, self.verts_cano = self.verts_at(param, timestep,
                                                    return_verts_cano=True)
        self.frames = face_frames_from_verts(self.verts[0],
                                             self.flame_model.faces)
        return self.frames

    # ------------------------------------------------------------------
    # Regularizers (reference flame_gaussian_model.py:156-172)
    # ------------------------------------------------------------------

    def compute_dynamic_offset_loss(self, flame_param: dict, timestep: int):
        """Mean norm of the timestep's dynamic offset."""
        off = flame_param["dynamic_offset"][timestep]
        return torch.linalg.norm(off, dim=-1).mean()

    def compute_laplacian_loss(self, flame_param: dict, timestep: int,
                               verts_cano: torch.Tensor):
        """Mean squared change the timestep's dynamic offset makes to the
        laplacian of the canonical mesh. Only the offset carries a
        gradient: the mesh without it and its laplacian are constants."""
        offset = flame_param["dynamic_offset"][timestep][None]
        verts_wo = (verts_cano - offset).detach()
        verts_w = verts_wo + offset
        lap_wo = self.flame_model.laplacian_smooth(verts_wo).detach()
        lap_w = self.flame_model.laplacian_smooth(verts_w)
        diff = (lap_wo - lap_w) ** 2
        return diff.sum(dim=-1, keepdim=True).mean()

    # ------------------------------------------------------------------
    # IO (reference flame_gaussian_model.py:219-269)
    # ------------------------------------------------------------------

    def save_ply(self, path: str):
        """The PLY, and `flame_param.npz` beside it."""
        super().save_ply(path)
        if self.flame_param is not None:
            np.savez(str(Path(path).parent / "flame_param.npz"),
                     **{k: v.detach().cpu().numpy()
                        for k, v in self.flame_param.items()})

    def load_ply(self, path: str, has_target: bool = False,
                 motion_path: Optional[str] = None,
                 disable_fid: Optional[np.ndarray] = None):
        """The PLY, and, unless the scene drives a target's motion
        (`has_target`), the `flame_param.npz` beside it.

        `motion_path`: a FLAME sequence (`.npz`, e.g. another subject's
        tracked motion) whose float32 poses, expressions, translation and
        dynamic offsets replace the model's; shape and static offset stay.
        `disable_fid`: face ids whose Gaussians are dropped.
        """
        super().load_ply(path)
        dev = self.device
        npz_path = str(Path(path).parent / "flame_param.npz")
        if not has_target and os.path.exists(npz_path):
            with np.load(npz_path) as data:
                self.flame_param = {
                    k: torch.as_tensor(np.asarray(v, np.float32), device=dev)
                    for k, v in data.items()}
            self.num_timesteps = int(self.flame_param["expr"].shape[0])

        if motion_path is not None:
            with np.load(motion_path) as data:
                motion = {k: torch.as_tensor(v, device=dev)
                          for k, v in data.items() if v.dtype == np.float32}
            self.flame_param = {
                "shape": self.flame_param["shape"],
                "static_offset": self.flame_param["static_offset"],
                **{k: motion[k] for k in (
                    "translation", "rotation", "neck_pose", "jaw_pose",
                    "eyes_pose", "expr", "dynamic_offset")}}
            self.num_timesteps = int(self.flame_param["expr"].shape[0])

        if disable_fid is not None and len(disable_fid) > 0:
            keep = ~torch.isin(self.binding, torch.as_tensor(
                np.asarray(disable_fid, np.int64), device=dev))
            self.params = GaussianParams(*[p[keep] for p in self.params])
            self.binding = self.binding[keep]
            self.binding_counter = torch.bincount(
                self.binding, minlength=self.flame_model.num_faces)
            self.reset_stats()
