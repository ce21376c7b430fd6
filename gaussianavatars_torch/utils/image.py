"""Image losses, metrics and error maps (port of
`gaussianavatars_tpu/utils/image.py`; reference utils/image_utils.py:15-26
and utils/loss_utils.py:17-21)."""

from __future__ import annotations

import numpy as np
import torch


def l1_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.abs(a - b).mean()


def l2_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return ((a - b) ** 2).mean()


def mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-image MSE, images flattened per batch item ([..., C, H, W])."""
    diff = (a - b) ** 2
    return diff.reshape(diff.shape[:-3] + (-1,)).mean(dim=-1, keepdim=True)


def psnr(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """PSNR in dB over [0, 1] images."""
    return 20.0 * torch.log10(1.0 / torch.sqrt(mse(a, b)))


# matplotlib's "seismic" colormap: five colours spaced evenly over [0, 1],
# interpolated into a 256-entry table (the host has no matplotlib)
_SEISMIC = np.array([(0.0, 0.0, 0.3), (0.0, 0.0, 1.0), (1.0, 1.0, 1.0),
                     (1.0, 0.0, 0.0), (0.5, 0.0, 0.0)])
_SEISMIC_LUT = np.stack(
    [np.interp(np.linspace(0.0, 1.0, 256), np.linspace(0.0, 1.0, 5), c)
     for c in _SEISMIC.T], axis=1)


def error_map(render: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """The mean absolute error over channels, min-max normalised and
    coloured with the seismic colormap (reference utils/image_utils.py:
    22-26). Inputs [C, H, W] in [0, 1] on the host; returns [3, H, W]
    float32."""
    err = np.abs(np.asarray(render) - np.asarray(gt)).mean(axis=0)
    lo, hi = err.min(), err.max()
    norm = (err - lo) / max(hi - lo, 1e-12)
    idx = np.clip((norm * 256).astype(np.int64), 0, 255)
    return np.transpose(_SEISMIC_LUT[idx], (2, 0, 1)).astype(np.float32)
