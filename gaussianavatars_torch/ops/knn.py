"""Nearest-neighbour distances for the scale init of unbound Gaussians
(port of `gaussianavatars_tpu/ops/knn.py`; the reference's simple-knn
`distCUDA2`, scene/gaussian_model.py:191).

It runs once, when an avatar is made from a point cloud, so a blocked exact
top-k over pairwise squared distances is enough: each block of rows takes
|a|^2 + |b|^2 - 2 a.b against every point (one matmul, the form the JAX
package and `torch.cdist`'s matmul path use) and keeps its 3 smallest.
"""

from __future__ import annotations

import torch

BLOCK = 1024           # rows of the distance matrix at a time


@torch.no_grad()
def mean_sq_dist_to_3nn(points: torch.Tensor) -> torch.Tensor:
    """Mean squared distance from each point to its 3 nearest neighbours.

    Args:
      points: [N, 3] float32, on any device.
    Returns:
      [N] float32 on the points' device (distCUDA2's contract). With fewer
      than 4 points, the mean over the N - 1 others.
    """
    points = points.to(torch.float32)
    n = points.shape[0]
    k = min(3, max(n - 1, 1))
    sq = torch.sum(points * points, dim=-1)
    out = torch.empty(n, dtype=torch.float32, device=points.device)
    for start in range(0, n, BLOCK):
        chunk = points[start:start + BLOCK]
        d2 = (torch.sum(chunk * chunk, dim=-1)[:, None] + sq[None, :]
              - 2.0 * chunk @ points.T).clamp_(min=0.0)
        rows = torch.arange(chunk.shape[0], device=points.device)
        d2[rows, rows + start] = float("inf")
        out[start:start + BLOCK] = torch.topk(
            d2, k, dim=-1, largest=False).values.mean(dim=-1)
    return out
