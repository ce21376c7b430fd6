"""Windowed SSIM as banded matrix products (port of
`gaussianavatars_tpu/ops/ssim.py`; reference utils/loss_utils.py:23-63:
11x11 Gaussian window, sigma 1.5, C1 = 0.01^2, C2 = 0.03^2, zero-padded
same-size filtering).

The separable blur is two `torch.matmul`s against precomputed banded
matrices, in full float32 (`device.resolve_device` turns TF32 off on CUDA).
Differentiable through autograd.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch


@functools.lru_cache(maxsize=8)
def _gaussian_window(window_size: int, sigma: float) -> np.ndarray:
    g = np.array([math.exp(-((x - window_size // 2) ** 2) / (2.0 * sigma ** 2))
                  for x in range(window_size)], dtype=np.float32)
    return g / g.sum()


@functools.lru_cache(maxsize=32)
def _band_matrix(n: int, window_size: int, sigma: float) -> np.ndarray:
    """(n, n) banded B with B[i, j] = w[i - j + half] inside the band:
    x @ B is the zero-padded same-size 1D correlation of each row of x."""
    w = _gaussian_window(window_size, sigma)
    half = window_size // 2
    d = np.arange(n)[:, None] - np.arange(n)[None, :] + half
    inside = (d >= 0) & (d < window_size)
    return np.where(inside, w[np.clip(d, 0, window_size - 1)], 0.0).astype(
        np.float32)


@functools.lru_cache(maxsize=8)
def _band_tensor(n: int, window_size: int, sigma: float,
                 device: torch.device) -> torch.Tensor:
    """`_band_matrix` on `device`, uploaded once (a pageable host copy per
    blur would stall the host every step)."""
    return torch.as_tensor(_band_matrix(n, window_size, sigma), device=device)


def _blur(img: torch.Tensor, window_size: int, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur of [C, H, W] -> [C, W, H] (the axes end
    swapped, as in the JAX package; ssim reduces to a scalar, so the
    orientation is never restored)."""
    h, w = img.shape[-2], img.shape[-1]
    bw = _band_tensor(w, window_size, sigma, img.device)
    bh = _band_tensor(h, window_size, sigma, img.device)
    return torch.matmul(torch.matmul(img, bw).transpose(-1, -2), bh)


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
         sigma: float = 1.5) -> torch.Tensor:
    """Mean SSIM over an image pair, [C, H, W] (or [N, C, H, W])."""
    def blur(x):
        return _blur(x, window_size, sigma)

    mu1 = blur(img1)
    mu2 = blur(img2)
    mu1_sq = mu1 * mu1
    mu2_sq = mu2 * mu2
    mu1_mu2 = mu1 * mu2
    sigma1_sq = blur(img1 * img1) - mu1_sq
    sigma2_sq = blur(img2 * img2) - mu2_sq
    sigma12 = blur(img1 * img2) - mu1_mu2
    c1 = 0.01 ** 2
    c2 = 0.03 ** 2
    ssim_map = ((2.0 * mu1_mu2 + c1) * (2.0 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    return ssim_map.mean()
