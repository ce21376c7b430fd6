"""Screen-space projection of 3D Gaussians with their SH colours, EWA
splatting (port of `gaussianavatars_tpu/ops/projection.py`).

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

`project_gaussians` runs the autograd function `ProjectGaussians`: on CUDA
tensors its forward and backward are one hand-written kernel each
(`csrc/project.cu`, `project_fwd` and `project_bwd`), on CPU tensors the
plain versions below (`project_gaussians_plain` without autograd, and the
closed-form `project_bwd_plain` that the kernel's backward mirrors line by
line). The backward recomputes the forward's intermediates from the
inputs: autograd keeps nothing but the inputs. Precomputed colours
(`colors_precomp`) are taken as they are beside the same geometry;
precomputed covariances (`cov3d_precomp`) run `project_gaussians_plain`
through autograd. The JAX package's projection has no custom VJP and no
kernel: the two kernels replace the ~1,000 elementwise launches of the
plain version's forward and autograd backward.

Gradient convention: `means2d_offset` is a zeros-valued [N, 2] input added
to the NDC xy coordinates. Its gradient is the reference's
`viewspace_points.grad`, the screen gradient that drives densification.
`depths`, `radii`, `valid`, `r2_max`, `tau`, `ext_x` and `ext_y` carry no
gradient (the binnings detach them).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from gaussianavatars_torch import kernels
from gaussianavatars_torch.device import route
from gaussianavatars_torch.ops.quaternion import quat_normalize
from gaussianavatars_torch.ops.sh import (
    eval_sh_flat_cmajor,
    flat_cmajor_from_kc,
    num_sh_coeffs,
    sh_basis,
    sh_basis_vjp,
)
from gaussianavatars_torch.utils import trace

NEAR = 0.2              # view-space z at and below which a Gaussian is culled
FRUSTUM_SLACK = 1.3     # the Jacobian's clamp, in units of tan(fov / 2)
DILATION = 0.3          # px added to the 2D covariance's diagonal
W_EPS = 1e-7            # added to the clip w before the divide
QUAT_EPS = 1e-24        # clamp of |q|^2 under the normalising rsqrt
DIR_EPS = 1e-12         # clamp of |p - campos| under the view direction


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


class _Rotation(NamedTuple):
    """The normalised quaternion, its rotation matrix and the squared
    scales of `_rotation_scale`."""

    q: tuple        # w, x, y, z
    r: tuple        # r00, r01, r02, r10, r11, r12, r20, r21, r22
    s2: tuple       # (scaling_modifier * scale)^2 per axis
    rs: tuple       # scaling_modifier * scale per axis


def _rotation_scale(scales, quats, scaling_modifier=1.0) -> _Rotation:
    w, x, y, z = quat_normalize(quats, QUAT_EPS).unbind(-1)
    r = (1.0 - 2.0 * (y * y + z * z), 2.0 * (x * y - w * z),
         2.0 * (x * z + w * y),
         2.0 * (x * y + w * z), 1.0 - 2.0 * (x * x + z * z),
         2.0 * (y * z - w * x),
         2.0 * (x * z - w * y), 2.0 * (y * z + w * x),
         1.0 - 2.0 * (x * x + y * y))
    rs = tuple(scaling_modifier * scales[..., k] for k in range(3))
    return _Rotation((w, x, y, z), r, tuple(v ** 2 for v in rs), rs)


def _cov3d_components(scales, quats, scaling_modifier=1.0):
    """Sigma = R S S^T R^T as six [N] components (xx,xy,xz,yy,yz,zz)."""
    rot = _rotation_scale(scales, quats, scaling_modifier)
    r00, r01, r02, r10, r11, r12, r20, r21, r22 = rot.r
    s0, s1, s2 = rot.s2
    cxx = r00 * r00 * s0 + r01 * r01 * s1 + r02 * r02 * s2
    cxy = r00 * r10 * s0 + r01 * r11 * s1 + r02 * r12 * s2
    cxz = r00 * r20 * s0 + r01 * r21 * s1 + r02 * r22 * s2
    cyy = r10 * r10 * s0 + r11 * r11 * s1 + r12 * r12 * s2
    cyz = r10 * r20 * s0 + r11 * r21 * s1 + r12 * r22 * s2
    czz = r20 * r20 * s0 + r21 * r21 * s1 + r22 * r22 * s2
    return cxx, cxy, cxz, cyy, cyz, czz


class _Ewa(NamedTuple):
    """The EWA projection's intermediates (`_ewa`), each [N]."""

    t_raw: tuple    # view position before the clamps (tx_, ty_, tz_)
    tz: torch.Tensor
    u: tuple        # tx_ / tz, ty_ / tz before the frustum clamp
    uc: tuple       # and after it
    t: tuple        # uc * tz
    inv_z: torch.Tensor
    m: tuple        # rows of J W: m00, m01, m02, m10, m11, m12
    s: tuple        # Sigma m0 (s0x, s1x, s2x) and Sigma m1 (s0y, s1y, s2y)
    cov2d: tuple    # xx, xy, yy with the dilation


def _ewa(mean3d, cov3d_comps, vm, focal_x, focal_y, tan_fovx,
         tan_fovy) -> _Ewa:
    tx_ = mean3d[..., 0] * vm[0, 0] + mean3d[..., 1] * vm[1, 0] \
        + mean3d[..., 2] * vm[2, 0] + vm[3, 0]
    ty_ = mean3d[..., 0] * vm[0, 1] + mean3d[..., 1] * vm[1, 1] \
        + mean3d[..., 2] * vm[2, 1] + vm[3, 1]
    tz_ = mean3d[..., 0] * vm[0, 2] + mean3d[..., 1] * vm[1, 2] \
        + mean3d[..., 2] * vm[2, 2] + vm[3, 2]
    # culled gaussians (z <= 0.2) never reach the blend; the clamp keeps
    # their jacobian finite
    tz = torch.clamp(tz_, min=NEAR)

    limx = FRUSTUM_SLACK * tan_fovx
    limy = FRUSTUM_SLACK * tan_fovy
    ux, uy = tx_ / tz, ty_ / tz
    ucx, ucy = torch.clamp(ux, -limx, limx), torch.clamp(uy, -limy, limy)
    tx, ty = ucx * tz, ucy * tz

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

    out_xx = m00 * s0x + m01 * s1x + m02 * s2x + DILATION
    out_xy = m00 * s0y + m01 * s1y + m02 * s2y
    out_yy = m10 * s0y + m11 * s1y + m12 * s2y + DILATION
    return _Ewa((tx_, ty_, tz_), tz, (ux, uy), (ucx, ucy), (tx, ty), inv_z,
                (m00, m01, m02, m10, m11, m12),
                (s0x, s1x, s2x, s0y, s1y, s2y), (out_xx, out_xy, out_yy))


def compute_cov2d_components(mean3d, cov3d_comps, vm, focal_x, focal_y,
                             tan_fovx, tan_fovy):
    """EWA projection, componentized. Returns (xx, xy, yy) [N] each,
    including the 0.3 px low-pass dilation."""
    return _ewa(mean3d, cov3d_comps, vm, focal_x, focal_y, tan_fovx,
                tan_fovy).cov2d


def ndc2pix(ndc: torch.Tensor, size) -> torch.Tensor:
    return ((ndc + 1.0) * size - 1.0) * 0.5


def _focals(camera: CameraParams):
    return (camera.width / (2.0 * camera.tan_fovx),
            camera.height / (2.0 * camera.tan_fovy))


def _clip(means3d, camera: CameraParams):
    """(depths, in_front, p_hom, 1 / (w + 1e-7)) of the clip transform."""
    hom = torch.cat([means3d, means3d.new_ones(means3d.shape[0], 1)], dim=-1)
    depths = torch.matmul(hom, camera.viewmatrix)[..., 2]
    in_front = depths > NEAR
    p_hom = torch.matmul(hom, camera.projmatrix)
    w_safe = torch.where(in_front, p_hom[..., 3], torch.ones_like(depths))
    return depths, in_front, p_hom, 1.0 / (w_safe + W_EPS)


def _view_dirs(means3d, campos):
    """(p - campos, its norm [N, 1], the clamped norm)."""
    d = means3d - campos
    norm = torch.linalg.norm(d, dim=-1, keepdim=True)
    return d, norm, torch.clamp(norm, min=DIR_EPS)


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

    Without `cov3d_precomp` this is `ProjectGaussians` (the module's
    docstring), and counts 1 in the tracer's "projections_fused".
    """
    if cov3d_precomp is not None:
        return project_gaussians_plain(
            means3d, scales, quats, opacities, shs, sh_degree, camera,
            scaling_modifier, means2d_offset, colors_precomp, cov3d_precomp)
    if colors_precomp is not None:
        shs = None
    elif shs.ndim == 3:
        shs = flat_cmajor_from_kc(shs)
    trace.count(trace.PROJECTIONS_FUSED)
    (means2d, depths, conics, colors, radii, valid, r2_max, ext_x, ext_y,
     tau) = ProjectGaussians.apply(
        means3d, scales, quats, opacities, shs, means2d_offset, sh_degree,
        camera, float(scaling_modifier))
    return ProjectedGaussians(
        means2d=means2d, depths=depths, conics=conics,
        colors=colors if colors_precomp is None else colors_precomp,
        opacities=opacities, radii=radii, valid=valid, r2_max=r2_max,
        ext_x=ext_x, ext_y=ext_y, tau=tau)


class ProjectGaussians(torch.autograd.Function):
    """`project_fwd_cuda` and `project_bwd_cuda` on CUDA tensors,
    `project_fwd_plain` and `project_bwd_plain` on CPU tensors.

    Outputs: means2d, depths, conics, colors (None when `shs` is None),
    radii, valid, r2_max, ext_x, ext_y, tau; only means2d, conics and
    colors are differentiable. Gradients go to means3d, scales, quats, shs
    and means2d_offset.
    """

    @staticmethod
    def forward(ctx, means3d, scales, quats, opacities, shs, means2d_offset,
                sh_degree, camera, scaling_modifier):
        fwd = route(means3d, project_fwd_cuda, project_fwd_plain)
        out = fwd(means3d, scales, quats, opacities, shs, sh_degree, camera,
                  scaling_modifier, means2d_offset)
        ctx.mark_non_differentiable(out[1], *out[4:])
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(means3d, scales, quats, shs)
        ctx.static = (sh_degree, camera, scaling_modifier,
                      means2d_offset is not None)
        return out

    @staticmethod
    def backward(ctx, g_means2d, g_depths, g_conics, g_colors, *g_rest):
        means3d, scales, quats, shs = ctx.saved_tensors
        sh_degree, camera, scaling_modifier, with_offset = ctx.static
        bwd = route(means3d, project_bwd_cuda, project_bwd_plain)
        g_m, g_s, g_q, g_sh, g_off = bwd(
            means3d, scales, quats, shs, sh_degree, camera, scaling_modifier,
            g_means2d, g_conics, g_colors)
        return (g_m, g_s, g_q, None, g_sh, g_off if with_offset else None,
                None, None, None)


# ----------------------------------------------------------------------------
# Plain versions
# ----------------------------------------------------------------------------

def project_gaussians_plain(means3d, scales, quats, opacities, shs,
                            sh_degree: int, camera: CameraParams,
                            scaling_modifier: float = 1.0,
                            means2d_offset=None, colors_precomp=None,
                            cov3d_precomp=None) -> ProjectedGaussians:
    """`project_gaussians` in plain PyTorch on any device, differentiable
    through autograd. With `shs` and `colors_precomp` both None the
    colours are None."""
    focal_x, focal_y = _focals(camera)
    depths, in_front, p_hom, p_w = _clip(means3d, camera)
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

    if colors_precomp is not None or shs is None:
        colors = colors_precomp
    else:
        d, _, norm_c = _view_dirs(means3d, camera.campos)
        sh2c = shs if shs.ndim == 2 else flat_cmajor_from_kc(shs)
        colors = torch.clamp(
            eval_sh_flat_cmajor(sh_degree, sh2c, d / norm_c) + 0.5, min=0.0)

    return ProjectedGaussians(
        means2d=means2d, depths=depths, conics=conics, colors=colors,
        opacities=opacities, radii=radii, valid=valid, r2_max=r2_max,
        ext_x=ext_x, ext_y=ext_y, tau=tau)


def project_fwd_plain(means3d, scales, quats, opacities, shs, sh_degree,
                      camera, scaling_modifier, means2d_offset):
    """`ProjectGaussians`' forward outputs from `project_gaussians_plain`."""
    p = project_gaussians_plain(means3d, scales, quats, opacities, shs,
                                sh_degree, camera, scaling_modifier,
                                means2d_offset)
    return (p.means2d, p.depths, p.conics, p.colors, p.radii, p.valid,
            p.r2_max, p.ext_x, p.ext_y, p.tau)


def project_bwd_plain(means3d, scales, quats, shs, sh_degree, camera,
                      scaling_modifier, g_means2d, g_conics, g_colors):
    """`ProjectGaussians`' VJP in closed form (plain PyTorch, any device):
    the gradients of means3d, scales, quats, shs (None without `shs`) and
    means2d_offset from the cotangents of means2d, conics and colors (each
    may be None: zero). The forward's intermediates are recomputed by the
    forward's own helpers, so every mask (the near plane, the frustum
    clamp, det > 0, the colour clamp) is decided as the forward decided it;
    a gradient stops where the forward's `clamp` or `where` stops it.
    Kernel `project_bwd` (csrc/project.cu) is this function per Gaussian.
    """
    n = means3d.shape[0]
    if g_means2d is None:
        g_means2d = means3d.new_zeros(n, 2)
    if g_conics is None:
        g_conics = means3d.new_zeros(n, 3)
    vm, pm = camera.viewmatrix, camera.projmatrix
    focal_x, focal_y = _focals(camera)

    # means2d = ndc2pix(p_hom.xy / (w + 1e-7) + offset)
    _, in_front, p_hom, p_w = _clip(means3d, camera)
    g_ndc_x = g_means2d[:, 0] * 0.5 * camera.width
    g_ndc_y = g_means2d[:, 1] * 0.5 * camera.height
    g_offset = torch.stack([g_ndc_x, g_ndc_y], dim=-1)
    g_hx, g_hy = g_ndc_x * p_w, g_ndc_y * p_w
    g_pw = g_ndc_x * p_hom[:, 0] + g_ndc_y * p_hom[:, 1]
    g_hw = torch.where(in_front, -g_pw * p_w * p_w, torch.zeros_like(g_pw))
    g_m = [g_hx * pm[i, 0] + g_hy * pm[i, 1] + g_hw * pm[i, 3]
           for i in range(3)]

    # conic = (yy, -xy, xx) / det, det = xx yy - xy^2
    rot = _rotation_scale(scales, quats, scaling_modifier)
    e = _ewa(means3d, _cov3d_components(scales, quats, scaling_modifier),
             vm, focal_x, focal_y, camera.tan_fovx, camera.tan_fovy)
    a, b, c = e.cov2d
    det = a * c - b ** 2
    det_ok = det > 0.0
    inv_det = 1.0 / torch.where(det_ok, det, torch.ones_like(det))
    g0, g1, g2 = g_conics[:, 0], g_conics[:, 1], g_conics[:, 2]
    g_inv = g0 * c - g1 * b + g2 * a
    g_det = torch.where(det_ok, -g_inv * inv_det * inv_det,
                        torch.zeros_like(g_inv))
    g_a = g2 * inv_det + g_det * c
    g_b = -g1 * inv_det - 2.0 * b * g_det
    g_c = g0 * inv_det + g_det * a

    # a = m0 Sigma m0 + 0.3, b = m0 Sigma m1, c = m1 Sigma m1 + 0.3
    m00, m01, m02, m10, m11, m12 = e.m
    s0x, s1x, s2x, s0y, s1y, s2y = e.s
    gm00 = 2.0 * g_a * s0x + g_b * s0y
    gm01 = 2.0 * g_a * s1x + g_b * s1y
    gm02 = 2.0 * g_a * s2x + g_b * s2y
    gm10 = 2.0 * g_c * s0y + g_b * s0x
    gm11 = 2.0 * g_c * s1y + g_b * s1x
    gm12 = 2.0 * g_c * s2y + g_b * s2x
    g_cxx = g_a * m00 * m00 + g_b * m00 * m10 + g_c * m10 * m10
    g_cyy = g_a * m01 * m01 + g_b * m01 * m11 + g_c * m11 * m11
    g_czz = g_a * m02 * m02 + g_b * m02 * m12 + g_c * m12 * m12
    g_cxy = 2.0 * g_a * m00 * m01 + g_b * (m00 * m11 + m01 * m10) \
        + 2.0 * g_c * m10 * m11
    g_cxz = 2.0 * g_a * m00 * m02 + g_b * (m00 * m12 + m02 * m10) \
        + 2.0 * g_c * m10 * m12
    g_cyz = 2.0 * g_a * m01 * m02 + g_b * (m01 * m12 + m02 * m11) \
        + 2.0 * g_c * m11 * m12

    # M = J W: the Jacobian at the clamped view position
    g_j00 = gm00 * vm[0, 0] + gm01 * vm[1, 0] + gm02 * vm[2, 0]
    g_j02 = gm00 * vm[0, 2] + gm01 * vm[1, 2] + gm02 * vm[2, 2]
    g_j11 = gm10 * vm[0, 1] + gm11 * vm[1, 1] + gm12 * vm[2, 1]
    g_j12 = gm10 * vm[0, 2] + gm11 * vm[1, 2] + gm12 * vm[2, 2]
    tx, ty = e.t
    ux, uy = e.u
    tz, inv_z = e.tz, e.inv_z
    iz2 = inv_z * inv_z
    g_tx = -(focal_x * iz2) * g_j02
    g_ty = -(focal_y * iz2) * g_j12
    g_iz = (focal_x * g_j00 + focal_y * g_j11
            - 2.0 * (focal_x * tx) * inv_z * g_j02
            - 2.0 * (focal_y * ty) * inv_z * g_j12)
    cx, cy = e.uc
    limx = FRUSTUM_SLACK * camera.tan_fovx
    limy = FRUSTUM_SLACK * camera.tan_fovy
    zero = torch.zeros_like(g_tx)
    g_ux = torch.where((ux >= -limx) & (ux <= limx), g_tx * tz, zero)
    g_uy = torch.where((uy >= -limy) & (uy <= limy), g_ty * tz, zero)
    g_tz = -g_iz * iz2 + g_tx * cx + g_ty * cy - (g_ux * ux + g_uy * uy) / tz
    g_tz_ = torch.where(e.t_raw[2] >= NEAR, g_tz, zero)
    g_tx_, g_ty_ = g_ux / tz, g_uy / tz
    for i in range(3):
        g_m[i] = g_m[i] + g_tx_ * vm[i, 0] + g_ty_ * vm[i, 1] \
            + g_tz_ * vm[i, 2]

    # Sigma = R diag(s^2) R^T
    r00, r01, r02, r10, r11, r12, r20, r21, r22 = rot.r
    s2 = rot.s2
    gr = []
    g_scales = []
    for k, (ra, rb, rc) in enumerate(((r00, r10, r20), (r01, r11, r21),
                                      (r02, r12, r22))):
        g_sk = (g_cxx * ra * ra + g_cyy * rb * rb + g_czz * rc * rc
                + g_cxy * ra * rb + g_cxz * ra * rc + g_cyz * rb * rc)
        g_scales.append(g_sk * 2.0 * rot.rs[k] * scaling_modifier)
        gr.append((s2[k] * (2.0 * g_cxx * ra + g_cxy * rb + g_cxz * rc),
                   s2[k] * (g_cxy * ra + 2.0 * g_cyy * rb + g_cyz * rc),
                   s2[k] * (g_cxz * ra + g_cyz * rb + 2.0 * g_czz * rc)))
    (g00, g10, g20), (g01, g11, g21), (g02, g12, g22) = gr
    w, x, y, z = rot.q
    g_w = 2.0 * (-z * g01 + y * g02 + z * g10 - x * g12 - y * g20 + x * g21)
    g_x = 2.0 * (y * g01 + z * g02 + y * g10 - 2.0 * x * g11 - w * g12
                 + z * g20 + w * g21 - 2.0 * x * g22)
    g_y = 2.0 * (-2.0 * y * g00 + x * g01 + w * g02 + x * g10 + z * g12
                 - w * g20 + z * g21 - 2.0 * y * g22)
    g_z = 2.0 * (-2.0 * z * g00 - w * g01 + x * g02 + w * g10
                 - 2.0 * z * g11 + y * g12 + x * g20 + y * g21)
    g_qn = torch.stack([g_w, g_x, g_y, g_z], dim=-1)
    # q / sqrt(max(|q|^2, eps))
    n2 = torch.sum(quats * quats, dim=-1, keepdim=True)
    rq = torch.rsqrt(torch.clamp(n2, min=QUAT_EPS))
    dot = torch.sum(g_qn * quats, dim=-1, keepdim=True)
    g_quats = g_qn * rq + torch.where(
        n2 >= QUAT_EPS, -(rq * rq * rq) * dot, torch.zeros_like(dot)) * quats

    g_shs = None
    if shs is not None:
        k = shs.shape[1] // 3
        d, norm, norm_c = _view_dirs(means3d, camera.campos)
        dirs = d / norm_c
        raw = eval_sh_flat_cmajor(sh_degree, shs, dirs) + 0.5
        if g_colors is None:
            g_colors = torch.zeros_like(raw)
        g_raw = torch.where(raw >= 0.0, g_colors, torch.zeros_like(raw))
        basis = sh_basis(sh_degree, dirs, k)
        g_shs = (g_raw[:, :, None] * basis[:, None, :]).reshape(n, 3 * k)
        g_basis = torch.sum(g_raw[:, :, None] * shs.reshape(n, 3, k), dim=1)
        g_dirs = sh_basis_vjp(sh_degree, dirs, g_basis)
        # d / max(|d|, eps)
        dot = torch.sum(g_dirs * d, dim=-1, keepdim=True)
        g_norm = torch.where(norm >= DIR_EPS, -dot / (norm_c * norm_c * norm),
                             torch.zeros_like(dot))
        g_d = g_dirs / norm_c + g_norm * d
        g_m = [g_m[i] + g_d[:, i] for i in range(3)]

    return (torch.stack(g_m, dim=-1), torch.stack(g_scales, dim=-1),
            g_quats, g_shs, g_offset)


# ----------------------------------------------------------------------------
# The kernels
# ----------------------------------------------------------------------------

_F, _I, _P, _L = ctypes.c_float, ctypes.c_int, ctypes.c_void_p, \
    ctypes.c_longlong


def _lib_fn(name, argtypes):
    fn = getattr(kernels.load("project"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _kernel_inputs(means3d, scales, quats, shs, sh_degree):
    """(means3d, scales, quats, K) as the kernels take them: contiguous,
    the quaternions 16-byte aligned (read as float4); K is 0 without
    `shs`. Raises on what the kernels do not take."""
    n = means3d.shape[0]
    for name, t, cols in (("means3d", means3d, 3), ("scales", scales, 3),
                          ("quats", quats, 4)):
        if t.device != means3d.device or t.dtype != torch.float32 \
                or tuple(t.shape) != (n, cols):
            raise ValueError(f"{name} must be float32 ({n}, {cols}) on "
                             f"{means3d.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    quats = quats.contiguous()
    if quats.data_ptr() % 16:
        quats = quats.clone()
    k = 0
    if shs is not None:
        if not 0 <= sh_degree <= 4:
            raise ValueError(f"sh_degree must be 0-4, got {sh_degree}")
        k = shs.shape[-1] // 3
        if shs.device != means3d.device or shs.dtype != torch.float32 \
                or shs.ndim != 2 or shs.shape[0] != n \
                or shs.shape[1] != 3 * k or k < num_sh_coeffs(sh_degree) \
                or shs.stride(1) != 1:
            raise ValueError(
                f"shs must be float32 ({n}, 3K) with unit column stride, "
                f"K >= {num_sh_coeffs(sh_degree)}, on {means3d.device}, got "
                f"{shs.dtype} {tuple(shs.shape)} on {shs.device}")
    return means3d.contiguous(), scales.contiguous(), quats, k


def _camera_args(camera: CameraParams, device):
    """The kernels' camera arguments: the three device tensors (read by
    the kernel, never on the host, so a CUDA graph can capture the launch)
    and the scalars. Returns (tensors to keep alive, ctypes arguments)."""
    mats = [getattr(camera, k).to(device=device, dtype=torch.float32)
            .contiguous() for k in ("viewmatrix", "projmatrix", "campos")]
    focal_x, focal_y = _focals(camera)
    return mats, [m.data_ptr() for m in mats] + [
        FRUSTUM_SLACK * camera.tan_fovx, FRUSTUM_SLACK * camera.tan_fovy,
        focal_x, focal_y, int(camera.width), int(camera.height)]


_CAMERA_ARGTYPES = [_P, _P, _P, _F, _F, _F, _F, _I, _I]


def project_fwd_cuda(means3d, scales, quats, opacities, shs, sh_degree,
                     camera, scaling_modifier, means2d_offset):
    """`ProjectGaussians`' forward on the GPU through kernel `project_fwd`
    (one launch). `project_fwd_cuda.launches` counts the launches."""
    n = means3d.shape[0]
    dev = means3d.device
    means3d, scales, quats, k = _kernel_inputs(means3d, scales, quats, shs,
                                               sh_degree)
    opacities = opacities.to(torch.float32).contiguous()
    offset = (None if means2d_offset is None
              else means2d_offset.to(torch.float32).contiguous())
    if opacities.shape != (n,) or (
            offset is not None and offset.shape != (n, 2)):
        raise ValueError("opacities must be (N,) and means2d_offset (N, 2)")
    mats, cam = _camera_args(camera, dev)
    f32 = dict(dtype=torch.float32, device=dev)
    means2d = torch.empty((n, 2), **f32)
    conics = torch.empty((n, 3), **f32)
    colors = None if shs is None else torch.empty((n, 3), **f32)
    depths, r2_max, ext_x, ext_y, tau = (torch.empty(n, **f32)
                                         for _ in range(5))
    radii = torch.empty(n, dtype=torch.int32, device=dev)
    valid = torch.empty(n, dtype=torch.bool, device=dev)
    fn = _lib_fn("project_fwd", [
        _I, _P, _P, _P, _P, _P, _L, _I, _I, _P, *_CAMERA_ARGTYPES, _F,
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(n, means3d.data_ptr(), scales.data_ptr(), quats.data_ptr(),
                 opacities.data_ptr(),
                 None if shs is None else shs.data_ptr(),
                 0 if shs is None else shs.stride(0), k, sh_degree,
                 None if offset is None else offset.data_ptr(), *cam,
                 scaling_modifier, means2d.data_ptr(), depths.data_ptr(),
                 conics.data_ptr(),
                 None if colors is None else colors.data_ptr(),
                 radii.data_ptr(), valid.data_ptr(), r2_max.data_ptr(),
                 ext_x.data_ptr(), ext_y.data_ptr(), tau.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"project_fwd kernel launch failed: CUDA error "
                           f"{err}")
    project_fwd_cuda.launches += 1
    return (means2d, depths, conics, colors, radii, valid, r2_max, ext_x,
            ext_y, tau)


project_fwd_cuda.launches = 0


def _cotangent(g, n, cols, dev):
    """(pointer, row stride) of a cotangent read in place: autograd hands
    the pack's gradient over as stride-9 column slices. None reads as 0."""
    if g is None:
        return None, 0
    if g.shape != (n, cols) or g.device != dev:
        raise ValueError(f"a cotangent must be ({n}, {cols}) on {dev}, got "
                         f"{tuple(g.shape)} on {g.device}")
    if g.dtype != torch.float32 or g.stride(1) != 1:
        g = g.to(torch.float32).contiguous()
    return g, g.stride(0)


def project_bwd_cuda(means3d, scales, quats, shs, sh_degree, camera,
                     scaling_modifier, g_means2d, g_conics, g_colors):
    """`ProjectGaussians`' VJP on the GPU through kernel `project_bwd` (one
    launch; every gradient row written once, no zero fill).
    `project_bwd_cuda.launches` counts the launches."""
    n = means3d.shape[0]
    dev = means3d.device
    means3d, scales, quats, k = _kernel_inputs(means3d, scales, quats, shs,
                                               sh_degree)
    mats, cam = _camera_args(camera, dev)
    (g2, s2), (gc, sc), (gk, sk) = (
        _cotangent(g, n, 3 if i else 2, dev)
        for i, g in enumerate((g_means2d, g_conics, g_colors)))
    f32 = dict(dtype=torch.float32, device=dev)
    g_m = torch.empty((n, 3), **f32)
    g_s = torch.empty((n, 3), **f32)
    g_q = torch.empty((n, 4), **f32)
    g_sh = None if shs is None else torch.empty((n, 3 * k), **f32)
    g_off = torch.empty((n, 2), **f32)
    fn = _lib_fn("project_bwd", [
        _I, _P, _P, _P, _P, _L, _I, _I, *_CAMERA_ARGTYPES, _F,
        _P, _L, _P, _L, _P, _L, _P, _P, _P, _P, _P, _P])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(n, means3d.data_ptr(), scales.data_ptr(), quats.data_ptr(),
                 None if shs is None else shs.data_ptr(),
                 0 if shs is None else shs.stride(0), k, sh_degree, *cam,
                 scaling_modifier,
                 None if g2 is None else g2.data_ptr(), s2,
                 None if gc is None else gc.data_ptr(), sc,
                 None if gk is None else gk.data_ptr(), sk,
                 g_m.data_ptr(), g_s.data_ptr(), g_q.data_ptr(),
                 None if g_sh is None else g_sh.data_ptr(), g_off.data_ptr(),
                 stream)
    if err != 0:
        raise RuntimeError(f"project_bwd kernel launch failed: CUDA error "
                           f"{err}")
    project_bwd_cuda.launches += 1
    return g_m, g_s, g_q, g_sh, g_off


project_bwd_cuda.launches = 0
