"""Quaternion math in wxyz convention (port of
`gaussianavatars_tpu/ops/quaternion.py`).

  - quat product for the face<-local rotation chain
    (reference scene/gaussian_model.py:125-138 via roma.quat_product)
  - quat -> rotation matrix (reference utils/general_utils.py:78-99)
  - rotation matrix -> quat (reference scene/flame_gaussian_model.py:147 via
    roma.rotmat_to_unitquat)

All functions are vectorized over leading batch dims.
"""

from __future__ import annotations

import torch


def quat_normalize(q: torch.Tensor, eps: float = 1e-24) -> torch.Tensor:
    """Normalize quaternions along the last axis (clamp inside the sqrt, so
    the zero quaternion stays finite)."""
    norm2 = torch.sum(q * q, dim=-1, keepdim=True)
    return q * torch.rsqrt(torch.clamp(norm2, min=eps))


def quat_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a*b with wxyz layout: R(a*b) = R(a) @ R(b)."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Unit-normalize then convert wxyz quaternions to [..., 3, 3]."""
    w, x, y, z = quat_normalize(q).unbind(-1)
    rows = [
        [1.0 - 2.0 * (y * y + z * z), 2.0 * (x * y - w * z),
         2.0 * (x * z + w * y)],
        [2.0 * (x * y + w * z), 1.0 - 2.0 * (x * x + z * z),
         2.0 * (y * z - w * x)],
        [2.0 * (x * z - w * y), 2.0 * (y * z + w * x),
         1.0 - 2.0 * (x * x + y * y)],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def rotmat_to_quat_components(m00, m01, m02, m10, m11, m12, m20, m21, m22):
    """Rotation-matrix entries -> unit quaternions [..., 4] (wxyz).

    Branch-free Shepperd's method: all four candidate quaternions, the one
    with the largest squared magnitude selected; sign canonicalized to
    w >= 0.
    """
    qw2 = 1.0 + m00 + m11 + m22
    qx2 = 1.0 + m00 - m11 - m22
    qy2 = 1.0 - m00 + m11 - m22
    qz2 = 1.0 - m00 - m11 + m22

    cand_w = torch.stack([qw2, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    cand_x = torch.stack([m21 - m12, qx2, m01 + m10, m02 + m20], dim=-1)
    cand_y = torch.stack([m02 - m20, m01 + m10, qy2, m12 + m21], dim=-1)
    cand_z = torch.stack([m10 - m01, m02 + m20, m12 + m21, qz2], dim=-1)

    best = torch.argmax(torch.stack([qw2, qx2, qy2, qz2], dim=-1), dim=-1)
    cands = torch.stack([cand_w, cand_x, cand_y, cand_z], dim=-2)
    idx = best[..., None, None].expand(*best.shape, 1, 4)
    q = quat_normalize(torch.gather(cands, -2, idx)[..., 0, :])
    return torch.where(q[..., 0:1] < 0.0, -q, q)
