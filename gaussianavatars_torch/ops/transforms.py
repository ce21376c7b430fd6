"""Camera matrices and the triangle-frame normalize (port of
`gaussianavatars_tpu/ops/transforms.py`).

Camera builders are host-side numpy in the reference's row-vector
(transposed, glm-style) storage, so points transform as
p_view = p_world @ world_view (reference utils/graphics_utils.py:31-71).
"""

from __future__ import annotations

import math

import numpy as np
import torch


def world_to_view(R: np.ndarray, t: np.ndarray,
                  translate: np.ndarray | None = None,
                  scale: float = 1.0) -> np.ndarray:
    """World->camera 4x4, returned transposed (row-vector convention).

    `R` is the camera-to-world rotation; `t` the world->camera translation.
    Optional recentering (translate/scale) matches getWorld2View2.
    """
    Rt = np.zeros((4, 4), dtype=np.float64)
    Rt[:3, :3] = R.T
    Rt[:3, 3] = t
    Rt[3, 3] = 1.0
    if translate is not None or scale != 1.0:
        translate = np.zeros(3) if translate is None else translate
        C2W = np.linalg.inv(Rt)
        C2W[:3, 3] = (C2W[:3, 3] + translate) * scale
        Rt = np.linalg.inv(C2W)
    return Rt.T.astype(np.float32)


def perspective_projection(znear: float, zfar: float,
                           fovx: float, fovy: float) -> np.ndarray:
    """Perspective projection 4x4, transposed (row-vector convention)."""
    P = np.zeros((4, 4), dtype=np.float32)
    P[0, 0] = 1.0 / math.tan(fovx / 2.0)
    P[1, 1] = 1.0 / math.tan(fovy / 2.0)
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    P[3, 2] = 1.0
    return P.T


def full_projection(world_view_t: np.ndarray, proj_t: np.ndarray) -> np.ndarray:
    """Composite world->clip (both inputs transposed): p_clip = p @ (W @ P)."""
    return (world_view_t @ proj_t).astype(np.float32)


def camera_center_from_world_view(world_view_t: np.ndarray) -> np.ndarray:
    """Camera origin in world space from a transposed world->view matrix."""
    return np.linalg.inv(world_view_t)[3, :3].astype(np.float32)


def fov2focal(fov: float, pixels: float) -> float:
    return pixels / (2.0 * math.tan(fov / 2.0))


def focal2fov(focal: float, pixels: float) -> float:
    return 2.0 * math.atan(pixels / (2.0 * focal))


def _safe_normalize(x: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    norm2 = torch.sum(x * x, dim=-1, keepdim=True)
    return x * (1.0 / torch.sqrt(torch.clamp(norm2, min=eps)))
