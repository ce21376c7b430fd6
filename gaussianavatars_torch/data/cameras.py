"""Cameras: host-side records and the renderer's `CameraParams` (port of
`gaussianavatars_tpu/data/cameras.py`; reference scene/cameras.py and
utils/camera_utils.py).

A `Camera` is a light host record; `to_params` builds the transposed
matrices the renderer reads as tensors on a device. The training loop asks
for the same camera's parameters every epoch, so each camera keeps the
tensors it built, one set per (width, height, device): the three small
uploads happen once per camera, not once per step.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from gaussianavatars_torch.ops.projection import CameraParams
from gaussianavatars_torch.ops.transforms import (
    camera_center_from_world_view,
    fov2focal,
    full_projection,
    perspective_projection,
    world_to_view,
)

ZNEAR = 0.01
ZFAR = 100.0

# resolution cap policy (reference utils/camera_utils.py:26-40)
MAX_AUTO_WIDTH = 1600


def _tensor(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


@dataclass
class Camera:
    """One training or eval view (reference scene/cameras.py:17-47)."""

    uid: int
    R: np.ndarray                  # [3,3] cam-to-world rotation
    T: np.ndarray                  # [3] world-to-cam translation
    fovx: float
    fovy: float
    width: int
    height: int
    image_path: Optional[str] = None
    image_name: str = ""
    bg: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    timestep: Optional[int] = None
    camera_id: Optional[int] = None
    trans: np.ndarray = field(default_factory=lambda: np.zeros(3))
    scale: float = 1.0
    _cache: dict = field(default_factory=dict, repr=False, compare=False)

    def world_view_transform(self) -> np.ndarray:
        return world_to_view(self.R, self.T, self.trans, self.scale)

    def to_params(self, width: Optional[int] = None,
                  height: Optional[int] = None,
                  device: str | torch.device = "cpu") -> CameraParams:
        """The renderer's camera at width x height (default: the camera's
        own size), its tensors on `device`; built once per size and
        device, then reused."""
        w = width or self.width
        h = height or self.height
        key = (w, h, str(torch.device(device)))
        params = self._cache.get(key)
        if params is None:
            wv = self.world_view_transform()
            proj = perspective_projection(ZNEAR, ZFAR, self.fovx, self.fovy)
            params = CameraParams(
                viewmatrix=_tensor(wv, device),
                projmatrix=_tensor(full_projection(wv, proj), device),
                campos=_tensor(camera_center_from_world_view(wv), device),
                tan_fovx=math.tan(self.fovx * 0.5),
                tan_fovy=math.tan(self.fovy * 0.5), width=w, height=h)
            self._cache[key] = params
        return params

    def resolution(self, resolution_arg: int = -1,
                   resolution_scale: float = 1.0) -> tuple[int, int]:
        """Target (width, height) under the reference's policy
        (utils/camera_utils.py:20-49): an explicit divisor if it is 1, 2, 4
        or 8, a target width if it is another positive number, else the
        width capped at 1600 px."""
        w, h = self.width, self.height
        if resolution_arg in (1, 2, 4, 8):
            return (round(w / (resolution_scale * resolution_arg)),
                    round(h / (resolution_scale * resolution_arg)))
        if resolution_arg == -1:
            scale = (w / MAX_AUTO_WIDTH) if w > MAX_AUTO_WIDTH else 1.0
        else:
            scale = w / resolution_arg
        scale *= resolution_scale
        return round(w / scale), round(h / scale)


@dataclass
class MiniCam:
    """Viewer camera (reference scene/cameras.py:49-62): ready transposed
    matrices instead of R and T."""

    width: int
    height: int
    fovx: float
    fovy: float
    znear: float
    zfar: float
    world_view_transform: np.ndarray
    full_proj_transform: np.ndarray
    timestep: int = 0

    def to_params(self, device: str | torch.device = "cpu") -> CameraParams:
        wv = np.asarray(self.world_view_transform, np.float32)
        return CameraParams(
            viewmatrix=_tensor(wv, device),
            projmatrix=_tensor(self.full_proj_transform, device),
            campos=_tensor(camera_center_from_world_view(wv), device),
            tan_fovx=math.tan(self.fovx * 0.5),
            tan_fovy=math.tan(self.fovy * 0.5),
            width=self.width, height=self.height)


def camera_to_json(uid: int, cam: Camera) -> dict:
    """reference utils/camera_utils.py:62-82 layout (cameras.json)."""
    w2c = np.zeros((4, 4))
    w2c[:3, :3] = cam.R.transpose()
    w2c[:3, 3] = cam.T
    w2c[3, 3] = 1.0
    c2w = np.linalg.inv(w2c)
    return {
        "id": uid,
        "img_name": cam.image_name,
        "width": cam.width,
        "height": cam.height,
        "position": c2w[:3, 3].tolist(),
        "rotation": [r.tolist() for r in c2w[:3, :3]],
        "fy": fov2focal(cam.fovy, cam.height),
        "fx": fov2focal(cam.fovx, cam.width),
    }
