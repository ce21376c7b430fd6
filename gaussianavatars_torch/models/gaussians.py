"""Gaussian splat parameters and the binding chain (port of the serving
subset of `gaussianavatars_tpu/models/gaussians.py`; reference
scene/gaussian_model.py:113-160).

The port holds exactly the live Gaussians: there are no capacity buckets,
dead padding slots or alive masks.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from gaussianavatars_torch.ops.quaternion import quat_multiply, quat_normalize


class GaussianParams(NamedTuple):
    """Raw parameters of N Gaussians.

    SH features are flat 2D: `features_dc` [N, 3] and `features_rest`
    [N, 3*(K-1)] CHANNEL-major (all K-1 red coeffs, then green, then blue;
    the reference PLY f_rest_* order).
    """

    xyz: torch.Tensor            # [N, 3] local (bound) or world (unbound)
    features_dc: torch.Tensor    # [N, 3]
    features_rest: torch.Tensor  # [N, 3*(K-1)] flat channel-major blocks
    scaling: torch.Tensor        # [N, 3] log-scale
    rotation: torch.Tensor       # [N, 4] wxyz (unnormalized)
    opacity: torch.Tensor        # [N, 1] logit


class FaceFrames(NamedTuple):
    """Per-triangle rigid frames of the driven mesh."""

    center: torch.Tensor       # [F, 3]
    orient_mat: torch.Tensor   # [F, 3, 3] columns (a0, a1, a2)
    orient_quat: torch.Tensor  # [F, 4] wxyz
    scaling: torch.Tensor      # [F, 1]
    table: torch.Tensor        # [F, 17]: orient 9 | scale | center 3 | quat 4


class GaussianModel:
    """Unbound Gaussian cloud: parameters on one device."""

    def __init__(self, sh_degree: int, params: Optional[GaussianParams] = None):
        self.max_sh_degree = sh_degree
        self.active_sh_degree = sh_degree
        self.params = params
        self.binding: Optional[torch.Tensor] = None

    @property
    def num_gaussians(self) -> int:
        return 0 if self.params is None else self.params.xyz.shape[0]


def world_space_gaussians(
    params: GaussianParams,
    binding: Optional[torch.Tensor],
    frames: Optional[FaceFrames],
):
    """Activate raw params and (when bound) carry them into world space.

    Returns (means3d [N,3], scales [N,3], quats [N,4], opacities [N],
    shs [N, 3*K] flat channel-major), following the reference property
    chain get_xyz / get_scaling / get_rotation
    (scene/gaussian_model.py:113-150).
    """
    scales = torch.exp(params.scaling)
    opacities = torch.sigmoid(params.opacity[:, 0])
    km = params.features_rest.shape[1] // 3
    dc, rest = params.features_dc, params.features_rest
    shs = torch.cat(
        [dc[:, 0:1], rest[:, :km],
         dc[:, 1:2], rest[:, km:2 * km],
         dc[:, 2:3], rest[:, 2 * km:]], dim=1)

    if binding is None:
        return params.xyz, scales, quat_normalize(params.rotation), \
            opacities, shs

    rows = frames.table.index_select(0, binding)         # (N, 17)
    face_scale = rows[:, 9:10]
    face_center = rows[:, 10:13]
    face_quat = quat_normalize(rows[:, 13:17])

    x, y, z = params.xyz[:, 0], params.xyz[:, 1], params.xyz[:, 2]
    wx = rows[:, 0] * x + rows[:, 1] * y + rows[:, 2] * z
    wy = rows[:, 3] * x + rows[:, 4] * y + rows[:, 5] * z
    wz = rows[:, 6] * x + rows[:, 7] * y + rows[:, 8] * z
    means3d = torch.stack([wx, wy, wz], dim=-1) * face_scale + face_center
    scales = scales * face_scale
    quats = quat_multiply(face_quat, quat_normalize(params.rotation))
    return means3d, scales, quats, opacities, shs
