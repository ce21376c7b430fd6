"""3D covariance Sigma = R S S^T R^T of anisotropic Gaussians (port of
`gaussianavatars_tpu/ops/covariance.py`; reference
scene/gaussian_model.py:29-39, utils/general_utils.py:64-110)."""

from __future__ import annotations

import torch

from gaussianavatars_torch.ops.quaternion import quat_to_rotmat


def build_scaling_rotation(scales: torch.Tensor,
                           quats: torch.Tensor) -> torch.Tensor:
    """L = R(q) @ diag(s): [N, 3, 3]."""
    return quat_to_rotmat(quats) * scales[..., None, :]


def build_covariance_3d(scales: torch.Tensor, quats: torch.Tensor,
                        scaling_modifier: float = 1.0) -> torch.Tensor:
    """Full covariance Sigma = L L^T, [N, 3, 3] (float32 matmul)."""
    L = build_scaling_rotation(scaling_modifier * scales, quats)
    return torch.matmul(L, L.transpose(-1, -2))


def strip_symmetric(cov: torch.Tensor) -> torch.Tensor:
    """Symmetric [N,3,3] -> upper triangle [N,6] (xx, xy, xz, yy, yz, zz)."""
    return torch.stack(
        [cov[..., 0, 0], cov[..., 0, 1], cov[..., 0, 2],
         cov[..., 1, 1], cov[..., 1, 2], cov[..., 2, 2]], dim=-1)


def unstrip_symmetric(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of strip_symmetric: [N,6] -> [N,3,3]."""
    xx, xy, xz, yy, yz, zz = packed.unbind(-1)
    return torch.stack([
        torch.stack([xx, xy, xz], dim=-1),
        torch.stack([xy, yy, yz], dim=-1),
        torch.stack([xz, yz, zz], dim=-1),
    ], dim=-2)
