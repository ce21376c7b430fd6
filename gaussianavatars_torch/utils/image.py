"""Image losses and metrics (port of `gaussianavatars_tpu/utils/image.py`;
reference utils/image_utils.py:15-20 and utils/loss_utils.py:17-18)."""

from __future__ import annotations

import torch


def l1_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.abs(a - b).mean()


def mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-image MSE, images flattened per batch item ([..., C, H, W])."""
    diff = (a - b) ** 2
    return diff.reshape(diff.shape[:-3] + (-1,)).mean(dim=-1, keepdim=True)


def psnr(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """PSNR in dB over [0, 1] images."""
    return 20.0 * torch.log10(1.0 / torch.sqrt(mse(a, b)))
