"""Real spherical-harmonics evaluation, degrees 0..4 (port of
`gaussianavatars_tpu/ops/sh.py`, reference utils/sh_utils.py:57-118;
autograd gives the backward).

The render path's coefficients use the flat CHANNEL-major layout [N, 3*K]
([all K red | all K green | all K blue]), the production layout of
`models/gaussians.GaussianParams` and the reference PLY f_rest_* order
(`eval_sh_flat_cmajor`). `eval_sh` is the reference's [..., C, K] form,
which the `convert_SHs_python` pipeline option evaluates outside the
rasterizer.
"""

from __future__ import annotations

import torch

_C0 = 0.28209479177387814
_C1 = 0.4886025119029199
_C2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)
_C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)
_C4 = (
    2.5033429417967046,
    -1.7701307697799304,
    0.9461746957575601,
    -0.6690465435572892,
    0.10578554691520431,
    -0.6690465435572892,
    0.47308734787878004,
    -1.7701307697799304,
    0.6258357354491761,
)


def num_sh_coeffs(degree: int) -> int:
    return (degree + 1) ** 2


def eval_sh(degree: int, sh: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """SH values [..., C] along unit directions `dirs` [..., 3] from
    coefficients `sh` [..., C, K], K >= (degree+1)^2, summed term by term
    in the reference's order (no +0.5 shift or clamp: callers apply it)."""
    assert 0 <= degree <= 4
    result = _C0 * sh[..., 0]
    if degree > 0:
        x = dirs[..., 0:1]
        y = dirs[..., 1:2]
        z = dirs[..., 2:3]
        result = (result - _C1 * y * sh[..., 1] + _C1 * z * sh[..., 2]
                  - _C1 * x * sh[..., 3])
        if degree > 1:
            xx, yy, zz = x * x, y * y, z * z
            xy, yz, xz = x * y, y * z, x * z
            result = (
                result
                + _C2[0] * xy * sh[..., 4]
                + _C2[1] * yz * sh[..., 5]
                + _C2[2] * (2.0 * zz - xx - yy) * sh[..., 6]
                + _C2[3] * xz * sh[..., 7]
                + _C2[4] * (xx - yy) * sh[..., 8]
            )
            if degree > 2:
                result = (
                    result
                    + _C3[0] * y * (3.0 * xx - yy) * sh[..., 9]
                    + _C3[1] * xy * z * sh[..., 10]
                    + _C3[2] * y * (4.0 * zz - xx - yy) * sh[..., 11]
                    + _C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy)
                    * sh[..., 12]
                    + _C3[4] * x * (4.0 * zz - xx - yy) * sh[..., 13]
                    + _C3[5] * z * (xx - yy) * sh[..., 14]
                    + _C3[6] * x * (xx - 3.0 * yy) * sh[..., 15]
                )
                if degree > 3:
                    result = (
                        result
                        + _C4[0] * xy * (xx - yy) * sh[..., 16]
                        + _C4[1] * yz * (3.0 * xx - yy) * sh[..., 17]
                        + _C4[2] * xy * (7.0 * zz - 1.0) * sh[..., 18]
                        + _C4[3] * yz * (7.0 * zz - 3.0) * sh[..., 19]
                        + _C4[4] * (zz * (35.0 * zz - 30.0) + 3.0)
                        * sh[..., 20]
                        + _C4[5] * xz * (7.0 * zz - 3.0) * sh[..., 21]
                        + _C4[6] * (xx - yy) * (7.0 * zz - 1.0) * sh[..., 22]
                        + _C4[7] * xz * (xx - 3.0 * yy) * sh[..., 23]
                        + _C4[8] * (xx * (xx - 3.0 * yy)
                                    - yy * (3.0 * xx - yy)) * sh[..., 24]
                    )
    return result


def sh_basis(degree: int, dirs: torch.Tensor, k: int) -> torch.Tensor:
    """Real SH basis values [..., k] along unit directions; coefficients
    beyond (degree+1)^2 are zero."""
    assert 0 <= degree <= 4
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    cols = [_C0 * torch.ones_like(x)]
    if degree > 0:
        cols += [-_C1 * y, _C1 * z, -_C1 * x]
    if degree > 1:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        cols += [
            _C2[0] * xy,
            _C2[1] * yz,
            _C2[2] * (2.0 * zz - xx - yy),
            _C2[3] * xz,
            _C2[4] * (xx - yy),
        ]
    if degree > 2:
        cols += [
            _C3[0] * y * (3.0 * xx - yy),
            _C3[1] * xy * z,
            _C3[2] * y * (4.0 * zz - xx - yy),
            _C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
            _C3[4] * x * (4.0 * zz - xx - yy),
            _C3[5] * z * (xx - yy),
            _C3[6] * x * (xx - 3.0 * yy),
        ]
    if degree > 3:
        cols += [
            _C4[0] * xy * (xx - yy),
            _C4[1] * yz * (3.0 * xx - yy),
            _C4[2] * xy * (7.0 * zz - 1.0),
            _C4[3] * yz * (7.0 * zz - 3.0),
            _C4[4] * (zz * (35.0 * zz - 30.0) + 3.0),
            _C4[5] * xz * (7.0 * zz - 3.0),
            _C4[6] * (xx - yy) * (7.0 * zz - 1.0),
            _C4[7] * xz * (xx - 3.0 * yy),
            _C4[8] * (xx * (xx - 3.0 * yy) - yy * (3.0 * xx - yy)),
        ]
    cols = cols[:k]
    cols += [torch.zeros_like(x)] * (k - len(cols))
    return torch.stack(cols, dim=-1)


def eval_sh_flat_cmajor(degree: int, sh2c: torch.Tensor,
                        dirs: torch.Tensor) -> torch.Tensor:
    """SH color [..., 3] from flat [..., 3*K] channel-major coefficients
    (no +0.5 shift or clamp: callers apply it)."""
    k = sh2c.shape[-1] // 3
    basis = sh_basis(degree, dirs, k)
    return torch.stack(
        [torch.sum(basis * sh2c[..., c * k:(c + 1) * k], dim=-1)
         for c in range(3)], dim=-1)


def flat_cmajor_from_kc(sh3: torch.Tensor) -> torch.Tensor:
    """[N, K, 3] coefficient-major -> flat [N, 3*K] channel-major."""
    return sh3.transpose(-1, -2).reshape(sh3.shape[0], -1)


def rgb2sh(rgb: torch.Tensor) -> torch.Tensor:
    """RGB in [0,1] -> DC SH coefficient (reference utils/sh_utils.py:114)."""
    return (rgb - 0.5) / _C0


def sh2rgb(sh: torch.Tensor) -> torch.Tensor:
    """DC SH coefficient -> RGB (reference utils/sh_utils.py:117)."""
    return sh * _C0 + 0.5
