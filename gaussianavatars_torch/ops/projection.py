"""Screen-space projection of 3D Gaussians, EWA splatting (port of
`gaussianavatars_tpu/ops/projection.py`; differentiable through autograd).

Math contract (the upstream Inria design the reference depends on):
  * view-space position p_view = [p, 1] @ viewmatrix (row-vector, transposed
    matrix storage); cull when p_view.z <= 0.2
  * clip position p_hom = [p, 1] @ projmatrix; ndc = p_hom.xyz/(p_hom.w+1e-7)
  * pixel center = ndc2pix(ndc, size) = ((ndc + 1) * size - 1) / 2
  * 2D covariance = J W Sigma W^T J^T with the perspective Jacobian J
    evaluated at the frustum-clamped view position, plus a 0.3 px dilation
    on the diagonal
  * conic = inverse covariance; radius = ceil(3 sqrt(lambda_max)), tightened
    by the opacity reach; per-axis extents ext_x/ext_y and the q-threshold
    tau feed the exact tile cull of ops/binning_dense.py
  * color = max(eval_sh(deg, sh, normalize(p - campos)) + 0.5, 0)

Gradient convention: `means2d_offset` is a zeros-valued [N, 2] input added
to the NDC xy coordinates. Its gradient is the reference's
`viewspace_points.grad`, the screen gradient that drives densification.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gaussianavatars_torch.ops.quaternion import quat_normalize
from gaussianavatars_torch.ops.sh import eval_sh_flat_cmajor, flat_cmajor_from_kc


class ProjectedGaussians(NamedTuple):
    """Per-gaussian screen-space quantities (all [N, ...])."""

    means2d: torch.Tensor    # [N, 2] pixel coordinates of the center
    depths: torch.Tensor     # [N] view-space z
    conics: torch.Tensor     # [N, 3] inverse 2D covariance (xx, xy, yy)
    colors: torch.Tensor     # [N, 3] RGB from SH (>= 0)
    opacities: torch.Tensor  # [N] in (0, 1)
    radii: torch.Tensor      # [N] int32 pixel radius (0 = culled)
    valid: torch.Tensor      # [N] bool visibility after culling
    r2_max: torch.Tensor     # [N] max sq pixel distance at which alpha can
                             # still reach 1/255
    ext_x: torch.Tensor      # [N] per-axis half extent (pixels):
    ext_y: torch.Tensor      # min(radius, ceil(sqrt(tau * cov_axis)))
    tau: torch.Tensor        # [N] 2*ln(255*op): the q-threshold for
                             # alpha >= 1/255 (exact ellipse tile cull)


class CameraParams(NamedTuple):
    """One camera. Matrices are float32 tensors in the reference's
    transposed (row-vector) storage (scene/cameras.py:44-47)."""

    viewmatrix: torch.Tensor  # [4, 4] world->view, transposed
    projmatrix: torch.Tensor  # [4, 4] world->clip composite, transposed
    campos: torch.Tensor      # [3] camera center, world space
    tan_fovx: float
    tan_fovy: float
    width: int
    height: int


def _cov3d_components(scales, quats, scaling_modifier=1.0):
    """Sigma = R S S^T R^T as six [N] components (xx,xy,xz,yy,yz,zz)."""
    w, x, y, z = quat_normalize(quats).unbind(-1)
    r00 = 1.0 - 2.0 * (y * y + z * z)
    r01 = 2.0 * (x * y - w * z)
    r02 = 2.0 * (x * z + w * y)
    r10 = 2.0 * (x * y + w * z)
    r11 = 1.0 - 2.0 * (x * x + z * z)
    r12 = 2.0 * (y * z - w * x)
    r20 = 2.0 * (x * z - w * y)
    r21 = 2.0 * (y * z + w * x)
    r22 = 1.0 - 2.0 * (x * x + y * y)

    s0 = (scaling_modifier * scales[..., 0]) ** 2
    s1 = (scaling_modifier * scales[..., 1]) ** 2
    s2 = (scaling_modifier * scales[..., 2]) ** 2

    cxx = r00 * r00 * s0 + r01 * r01 * s1 + r02 * r02 * s2
    cxy = r00 * r10 * s0 + r01 * r11 * s1 + r02 * r12 * s2
    cxz = r00 * r20 * s0 + r01 * r21 * s1 + r02 * r22 * s2
    cyy = r10 * r10 * s0 + r11 * r11 * s1 + r12 * r12 * s2
    cyz = r10 * r20 * s0 + r11 * r21 * s1 + r12 * r22 * s2
    czz = r20 * r20 * s0 + r21 * r21 * s1 + r22 * r22 * s2
    return cxx, cxy, cxz, cyy, cyz, czz


def compute_cov2d_components(mean3d, cov3d_comps, vm, focal_x, focal_y,
                             tan_fovx, tan_fovy):
    """EWA projection, componentized. Returns (xx, xy, yy) [N] each,
    including the 0.3 px low-pass dilation."""
    tx_ = mean3d[..., 0] * vm[0, 0] + mean3d[..., 1] * vm[1, 0] \
        + mean3d[..., 2] * vm[2, 0] + vm[3, 0]
    ty_ = mean3d[..., 0] * vm[0, 1] + mean3d[..., 1] * vm[1, 1] \
        + mean3d[..., 2] * vm[2, 1] + vm[3, 1]
    tz_ = mean3d[..., 0] * vm[0, 2] + mean3d[..., 1] * vm[1, 2] \
        + mean3d[..., 2] * vm[2, 2] + vm[3, 2]
    # culled gaussians (z <= 0.2) never reach the blend; the clamp keeps
    # their jacobian finite
    tz = torch.clamp(tz_, min=0.2)

    limx = 1.3 * tan_fovx
    limy = 1.3 * tan_fovy
    tx = torch.clamp(tx_ / tz, -limx, limx) * tz
    ty = torch.clamp(ty_ / tz, -limy, limy) * tz

    inv_z = 1.0 / tz
    j00 = focal_x * inv_z
    j02 = -(focal_x * tx) * inv_z * inv_z
    j11 = focal_y * inv_z
    j12 = -(focal_y * ty) * inv_z * inv_z

    # rows of M = J @ W with W = world->view rotation (vm[:3,:3].T)
    m00 = j00 * vm[0, 0] + j02 * vm[0, 2]
    m01 = j00 * vm[1, 0] + j02 * vm[1, 2]
    m02 = j00 * vm[2, 0] + j02 * vm[2, 2]
    m10 = j11 * vm[0, 1] + j12 * vm[0, 2]
    m11 = j11 * vm[1, 1] + j12 * vm[1, 2]
    m12 = j11 * vm[2, 1] + j12 * vm[2, 2]

    cxx, cxy, cxz, cyy, cyz, czz = cov3d_comps
    s0x = cxx * m00 + cxy * m01 + cxz * m02
    s1x = cxy * m00 + cyy * m01 + cyz * m02
    s2x = cxz * m00 + cyz * m01 + czz * m02
    s0y = cxx * m10 + cxy * m11 + cxz * m12
    s1y = cxy * m10 + cyy * m11 + cyz * m12
    s2y = cxz * m10 + cyz * m11 + czz * m12

    out_xx = m00 * s0x + m01 * s1x + m02 * s2x + 0.3
    out_xy = m00 * s0y + m01 * s1y + m02 * s2y
    out_yy = m10 * s0y + m11 * s1y + m12 * s2y + 0.3
    return out_xx, out_xy, out_yy


def ndc2pix(ndc: torch.Tensor, size) -> torch.Tensor:
    return ((ndc + 1.0) * size - 1.0) * 0.5


def project_gaussians(means3d, scales, quats, opacities, shs, sh_degree: int,
                      camera: CameraParams, scaling_modifier: float = 1.0,
                      means2d_offset=None, colors_precomp=None,
                      cov3d_precomp=None) -> ProjectedGaussians:
    """Project world-space gaussians to screen space.

    Args:
      means3d: [N, 3] world positions.
      scales: [N, 3] linear (already exp-activated) scales.
      quats: [N, 4] wxyz rotations (normalized here).
      opacities: [N] in (0,1) (already sigmoid-activated).
      shs: flat [N, 3*K] CHANNEL-major, or [N, K, 3] coefficient-major;
        K >= (sh_degree+1)^2.
      sh_degree: active SH degree.
      camera: CameraParams.
      scaling_modifier: global scale multiplier (the viewer's control); it
        does not touch `cov3d_precomp`.
      means2d_offset: optional [N, 2] added to the NDC xy.
      colors_precomp: optional [N, 3] colours used as they are in place of
        the SH evaluation (`shs` is then not read).
      cov3d_precomp: optional [N, 3, 3] world covariances in place of the
        scale/rotation covariance.
    """
    n = means3d.shape[0]
    focal_x = camera.width / (2.0 * camera.tan_fovx)
    focal_y = camera.height / (2.0 * camera.tan_fovy)

    hom = torch.cat([means3d, means3d.new_ones(n, 1)], dim=-1)
    p_view = torch.matmul(hom, camera.viewmatrix)
    depths = p_view[..., 2]
    in_front = depths > 0.2

    p_hom = torch.matmul(hom, camera.projmatrix)
    w_safe = torch.where(in_front, p_hom[..., 3], torch.ones_like(depths))
    p_w = 1.0 / (w_safe + 1e-7)
    ndc_xy = p_hom[..., :2] * p_w[..., None]
    if means2d_offset is not None:
        ndc_xy = ndc_xy + means2d_offset
    means2d = torch.stack([ndc2pix(ndc_xy[..., 0], camera.width),
                           ndc2pix(ndc_xy[..., 1], camera.height)], dim=-1)

    if cov3d_precomp is not None:
        comps = (cov3d_precomp[..., 0, 0], cov3d_precomp[..., 0, 1],
                 cov3d_precomp[..., 0, 2], cov3d_precomp[..., 1, 1],
                 cov3d_precomp[..., 1, 2], cov3d_precomp[..., 2, 2])
    else:
        comps = _cov3d_components(scales, quats, scaling_modifier)
    c2xx, c2xy, c2yy = compute_cov2d_components(
        means3d, comps, camera.viewmatrix, focal_x, focal_y,
        camera.tan_fovx, camera.tan_fovy)

    det = c2xx * c2yy - c2xy ** 2
    det_ok = det > 0.0
    inv_det = 1.0 / torch.where(det_ok, det, torch.ones_like(det))
    conics = torch.stack([c2yy * inv_det, -c2xy * inv_det, c2xx * inv_det],
                         dim=-1)

    mid = 0.5 * (c2xx + c2yy)
    disc = torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    lambda_max = mid + disc

    # q(d) = d^T conic d >= |d|^2 / lambda_max, so alpha >= 1/255 needs
    # |d|^2 <= 2 ln(255 op) lambda_max: dropping tiles beyond it is exact
    tau = 2.0 * torch.log(torch.clamp(255.0 * opacities, min=1e-12))
    r2_max = torch.where(tau > 0.0, tau * torch.clamp(lambda_max, min=0.0),
                         torch.full_like(tau, -1.0))
    radius_f = torch.ceil(torch.minimum(
        3.0 * torch.sqrt(torch.clamp(lambda_max, min=0.0)),
        torch.sqrt(torch.clamp(r2_max, min=0.0))))

    # q >= dx^2 / cov_xx (marginal bound of a PD quadratic), so a pixel can
    # contribute only within |dx| <= sqrt(tau cov_xx): tight per-axis rects
    tau_pos = torch.clamp(tau, min=0.0)
    ext_x = torch.minimum(radius_f, torch.ceil(
        torch.sqrt(tau_pos * torch.clamp(c2xx, min=0.0))))
    ext_y = torch.minimum(radius_f, torch.ceil(
        torch.sqrt(tau_pos * torch.clamp(c2yy, min=0.0))))

    valid = in_front & det_ok
    radii = torch.where(valid, radius_f, torch.zeros_like(radius_f)).to(
        torch.int32)
    on_screen = (
        (means2d[..., 0] + radius_f >= 0.0)
        & (means2d[..., 0] - radius_f < camera.width)
        & (means2d[..., 1] + radius_f >= 0.0)
        & (means2d[..., 1] - radius_f < camera.height)
    )
    valid = valid & on_screen & (radii > 0)
    radii = torch.where(valid, radii, torch.zeros_like(radii))
    ext_x = torch.where(valid, ext_x, torch.zeros_like(ext_x))
    ext_y = torch.where(valid, ext_y, torch.zeros_like(ext_y))

    if colors_precomp is not None:
        colors = colors_precomp
    else:
        dirs = means3d - camera.campos
        dirs = dirs / torch.clamp(
            torch.linalg.norm(dirs, dim=-1, keepdim=True), min=1e-12)
        sh2c = shs if shs.ndim == 2 else flat_cmajor_from_kc(shs)
        colors = torch.clamp(
            eval_sh_flat_cmajor(sh_degree, sh2c, dirs) + 0.5, min=0.0)

    return ProjectedGaussians(
        means2d=means2d, depths=depths, conics=conics, colors=colors,
        opacities=opacities, radii=radii, valid=valid, r2_max=r2_max,
        ext_x=ext_x, ext_y=ext_y, tau=tau)
