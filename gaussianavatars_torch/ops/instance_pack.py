"""Packed per-gaussian screen data and the instance-stream gather (port of
`gaussianavatars_tpu/ops/instance_pack.py`, forward).

The port's stream layout is row-major (K, 9) float32, one 36-byte row per
instance, shared by the plain blend and kernel K1 (csrc/blend_fwd.cu):

  0:2 mean2d | 2:5 conic (xx, xy, yy) | 5:8 color | 8 opacity

The JAX package's feature-major (16, K) layout exists for the TPU's DMA
tiling and is not ported.
"""

from __future__ import annotations

import torch

PACK_COLS = 9


def pack_projected(means2d, conics, colors, opacities) -> torch.Tensor:
    """[N,2]/[N,3]/[N,3]/[N] -> (N, 9) float32, one row per gaussian."""
    return torch.cat([means2d, conics, colors, opacities[:, None]], dim=1)


def gather_instances(pack: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """(N, 9) x [K] gaussian ids -> (K, 9) contiguous instance stream."""
    return pack.index_select(0, ids)
