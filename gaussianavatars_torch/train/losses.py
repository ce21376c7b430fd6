"""Training loss assembly (port of `gaussianavatars_tpu/train/losses.py`;
reference train.py:127-163).

The regularizers are means over the visible Gaussians. The port holds
exactly the live Gaussians, so the visibility count is the JAX package's
count too (its padding slots are never visible).
"""

from __future__ import annotations

import torch

from gaussianavatars_torch.ops.ssim import ssim
from gaussianavatars_torch.utils.image import l1_loss


def safe_norm(x: torch.Tensor, dim: int = -1,
              eps: float = 1e-24) -> torch.Tensor:
    """Norm with a NaN-free gradient at 0: the clamp inside the sqrt sends
    the zero vector down the constant branch (fresh bound splats sit at
    xyz = 0)."""
    return torch.sqrt(torch.clamp(torch.sum(x * x, dim=dim), min=eps))


def masked_mean(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean over the entries where mask is 1 (0 if there are none)."""
    total = torch.sum(values * mask)
    count = torch.clamp(torch.sum(mask), min=1.0)
    return total / count


def compute_losses(image, gt_image, visibility, params_xyz, params_scaling,
                   face_scaling_per_gaussian, opt_cfg, bound: bool):
    """Returns (total, {term: value}): L1, D-SSIM and, for a bound model,
    the xyz and scale regularizers. The dynamic-offset and laplacian terms
    need FLAME state and are the caller's."""
    vis = visibility.to(torch.float32)
    losses = {
        "l1": l1_loss(image, gt_image) * (1.0 - opt_cfg.lambda_dssim),
        "ssim": (1.0 - ssim(image, gt_image)) * opt_cfg.lambda_dssim,
    }
    if bound:
        if opt_cfg.metric_xyz:
            val = safe_norm(torch.relu(
                params_xyz * face_scaling_per_gaussian - opt_cfg.threshold_xyz),
                dim=1)
        else:
            val = torch.relu(safe_norm(params_xyz, dim=1)
                             - opt_cfg.threshold_xyz)
        losses["xyz"] = masked_mean(val, vis) * opt_cfg.lambda_xyz

        if opt_cfg.lambda_scale != 0.0:
            scale = torch.exp(params_scaling)
            if opt_cfg.metric_scale:
                scale = scale * face_scaling_per_gaussian
            val = safe_norm(torch.relu(scale - opt_cfg.threshold_scale), dim=1)
            losses["scale"] = masked_mean(val, vis) * opt_cfg.lambda_scale

    total = sum(losses.values())
    return total, losses
