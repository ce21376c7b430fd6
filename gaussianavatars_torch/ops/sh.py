"""Real spherical-harmonics evaluation, degrees 0..4 (port of
`gaussianavatars_tpu/ops/sh.py`, reference utils/sh_utils.py:57-118).
`sh_basis_vjp` is the basis's closed-form gradient along the direction,
for `ops/projection.py::project_bwd_plain` (which kernel `project_bwd`
mirrors); autograd differentiates the rest.

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


def sh_basis_vjp(degree: int, dirs: torch.Tensor,
                 g_basis: torch.Tensor) -> torch.Tensor:
    """The gradient [..., 3] along `dirs` of sum_k g_basis[..., k] times
    the basis function k of `sh_basis`, from each function's closed-form
    partials (the columns past (degree+1)^2 are constant)."""
    assert 0 <= degree <= 4
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    g = [g_basis[..., k] for k in range(min(g_basis.shape[-1],
                                             (degree + 1) ** 2))]
    zero = torch.zeros_like(x)
    gx, gy, gz = zero, zero, zero
    # (k, d/dx, d/dy, d/dz) of each basis function past the constant
    terms = []
    if degree > 0:
        terms += [(1, None, -_C1, None), (2, None, None, _C1),
                  (3, -_C1, None, None)]
    if degree > 1:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        terms += [
            (4, _C2[0] * y, _C2[0] * x, None),
            (5, None, _C2[1] * z, _C2[1] * y),
            (6, -2.0 * _C2[2] * x, -2.0 * _C2[2] * y, 4.0 * _C2[2] * z),
            (7, _C2[3] * z, None, _C2[3] * x),
            (8, 2.0 * _C2[4] * x, -2.0 * _C2[4] * y, None),
        ]
    if degree > 2:
        terms += [
            (9, _C3[0] * 6.0 * xy, _C3[0] * 3.0 * (xx - yy), None),
            (10, _C3[1] * yz, _C3[1] * xz, _C3[1] * xy),
            (11, _C3[2] * -2.0 * xy, _C3[2] * (4.0 * zz - xx - 3.0 * yy),
             _C3[2] * 8.0 * yz),
            (12, _C3[3] * -6.0 * xz, _C3[3] * -6.0 * yz,
             _C3[3] * (6.0 * zz - 3.0 * xx - 3.0 * yy)),
            (13, _C3[4] * (4.0 * zz - 3.0 * xx - yy), _C3[4] * -2.0 * xy,
             _C3[4] * 8.0 * xz),
            (14, _C3[5] * 2.0 * xz, _C3[5] * -2.0 * yz, _C3[5] * (xx - yy)),
            (15, _C3[6] * 3.0 * (xx - yy), _C3[6] * -6.0 * xy, None),
        ]
    if degree > 3:
        terms += [
            (16, _C4[0] * y * (3.0 * xx - yy), _C4[0] * x * (xx - 3.0 * yy),
             None),
            (17, _C4[1] * 6.0 * xy * z, _C4[1] * 3.0 * z * (xx - yy),
             _C4[1] * y * (3.0 * xx - yy)),
            (18, _C4[2] * y * (7.0 * zz - 1.0), _C4[2] * x * (7.0 * zz - 1.0),
             _C4[2] * 14.0 * xy * z),
            (19, None, _C4[3] * z * (7.0 * zz - 3.0),
             _C4[3] * y * (21.0 * zz - 3.0)),
            (20, None, None, _C4[4] * z * (140.0 * zz - 60.0)),
            (21, _C4[5] * z * (7.0 * zz - 3.0), None,
             _C4[5] * x * (21.0 * zz - 3.0)),
            (22, _C4[6] * 2.0 * x * (7.0 * zz - 1.0),
             _C4[6] * -2.0 * y * (7.0 * zz - 1.0),
             _C4[6] * 14.0 * z * (xx - yy)),
            (23, _C4[7] * 3.0 * z * (xx - yy), _C4[7] * -6.0 * xy * z,
             _C4[7] * x * (xx - 3.0 * yy)),
            (24, _C4[8] * 4.0 * x * (xx - 3.0 * yy),
             _C4[8] * 4.0 * y * (yy - 3.0 * xx), None),
        ]
    for k, dx, dy, dz in terms:
        if k >= len(g):
            break
        if dx is not None:
            gx = gx + g[k] * dx
        if dy is not None:
            gy = gy + g[k] * dy
        if dz is not None:
            gz = gz + g[k] * dz
    return torch.stack([gx, gy, gz], dim=-1)


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
