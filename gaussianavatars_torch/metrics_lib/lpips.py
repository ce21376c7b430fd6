"""LPIPS perceptual metric with a VGG16 backbone (port of
`gaussianavatars_tpu/metrics_lib/lpips.py`; reference lpipsPyTorch/modules/
{lpips,networks,utils}.py).

Both images pass through VGG16 up to relu5_3 as one batch; the relu after
the last convolution of each of the 5 stages is unit-normalised over the
channels, the squared difference weighted by that stage's 1x1 linear head,
averaged over the pixels and summed over the stages. The convolutions are
`F.conv2d` in full float32 (no TF32, `device.resolve_device`).

The pretrained weights are not part of the repository. They are read from
the `.npz` that `convert_torch_weights` writes (from torchvision's VGG16
state dict and the LPIPS `vgg.pth` heads), the same file the JAX package
reads: $LPIPS_WEIGHTS, else `lpips_vgg.npz` beside the FLAME asset
directory. Without it `lpips_available()` is False, and the metrics tools
and the training loop's evaluation leave the LPIPS column out.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gaussianavatars_torch.device import resolve_device

# VGG16 conv layout: (out_channels, n_convs) per stage; LPIPS taps the relu
# after the last conv of each stage.
_VGG_STAGES = [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]

# LPIPS input scaling (the reference's ScalingLayer constants).
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


def default_weights_path() -> str:
    return os.environ.get("LPIPS_WEIGHTS", os.path.normpath(os.path.join(
        os.environ.get("FLAME_ASSET_DIR", "flame_model/assets/flame"),
        "..", "lpips_vgg.npz")))


def lpips_available(path: Optional[str] = None) -> bool:
    return os.path.exists(path or default_weights_path())


def convert_torch_weights(vgg_state_path: str, lpips_state_path: str,
                          out_path: str) -> None:
    """Write the `.npz` both packages read from torch checkpoints.

    vgg_state_path: torchvision vgg16 state dict (features.N.weight/bias).
    lpips_state_path: LPIPS linear heads (lin{0..4}.model.1.weight).
    """
    vgg = torch.load(vgg_state_path, map_location="cpu")
    if hasattr(vgg, "state_dict"):
        vgg = vgg.state_dict()
    lin = torch.load(lpips_state_path, map_location="cpu")

    out = {}
    conv_idx = 0
    torch_layer = 0
    for _, n_convs in _VGG_STAGES:
        for _ in range(n_convs):
            out[f"conv{conv_idx}_w"] = \
                vgg[f"features.{torch_layer}.weight"].numpy()  # [o, i, 3, 3]
            out[f"conv{conv_idx}_b"] = \
                vgg[f"features.{torch_layer}.bias"].numpy()
            conv_idx += 1
            torch_layer += 2  # conv + relu
        torch_layer += 1      # maxpool
    for i in range(5):
        key = f"lin{i}.model.1.weight"
        if key not in lin:
            key = f"lin{i}.weight"
        out[f"lin{i}"] = np.asarray(lin[key]).reshape(-1)  # [C]
    np.savez(out_path, **out)


class LPIPS(nn.Module):
    """LPIPS(render, gt) for [N, 3, H, W] (or [3, H, W]) images in [0, 1]
    on `device`; returns the [N] distances."""

    def __init__(self, weights_path: Optional[str] = None,
                 device: str | torch.device = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        path = weights_path or default_weights_path()
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"LPIPS weights not found at {path}; convert them with "
                "gaussianavatars_torch.metrics_lib.lpips.convert_torch_weights")
        n_convs = sum(n for _, n in _VGG_STAGES)
        with np.load(path) as data:
            arrays = {k: data[k] for k in
                      [f"conv{i}_{p}" for i in range(n_convs)
                       for p in "wb"] + [f"lin{i}" for i in range(5)]}
        arrays["shift"] = _SHIFT[None, :, None, None]
        arrays["scale"] = _SCALE[None, :, None, None]
        for k, a in arrays.items():
            self.register_buffer(k, torch.as_tensor(
                np.asarray(a, np.float32), device=dev), persistent=False)

    def features(self, x: torch.Tensor) -> list:
        """The 5 stage taps of x [N, 3, H, W] in the LPIPS [-1, 1] range."""
        x = (x - self.shift) / self.scale
        feats = []
        ci = 0
        for stage, (_, n_convs) in enumerate(_VGG_STAGES):
            for _ in range(n_convs):
                x = F.relu(F.conv2d(x, getattr(self, f"conv{ci}_w"),
                                    getattr(self, f"conv{ci}_b"), padding=1))
                ci += 1
            feats.append(x)
            if stage < len(_VGG_STAGES) - 1:
                x = F.max_pool2d(x, 2, 2)
        return feats

    def forward(self, render: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
        if render.ndim == 3:
            render, gt = render[None], gt[None]
        n = render.shape[0]
        feats = self.features(torch.cat([render, gt]) * 2.0 - 1.0)
        total = 0.0
        for i, f in enumerate(feats):
            f = f / torch.sqrt(torch.sum(f * f, dim=1, keepdim=True) + 1e-10)
            diff = (f[:n] - f[n:]) ** 2
            lin = getattr(self, f"lin{i}")[None, :, None, None]
            total = total + torch.sum(diff * lin, dim=1).mean(dim=(1, 2))
        return total
