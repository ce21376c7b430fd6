"""The render in plain PyTorch: the binding chain, the EWA projection with
the SH colours (3D Gaussian Splatting, Kerbl et al. 2023, and its CUDA
rasterizer's conventions), a tile binning and the closed-form per-pixel
blend.

The blend is the rasterizer's front-to-back loop written as a cumulative
product: for the Gaussians whose tile rect covers a pixel's tile, in depth
order,

    power = -1/2 d^T conic d,  d = mean2d - pixel (integer pixel indices)
    alpha = min(0.99, opacity exp(power)),  skipped when below 1/255
    the pixel stops before the Gaussian that takes T below 1e-4
    C = sum alpha_i T_i c_i,  image = C + T_final bg

evaluated over blocks of tiles, each block a [tiles, pixels, Gaussians]
tensor. With gradients each block is recomputed in the backward
(`torch.utils.checkpoint`), so a full frame fits in memory.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4
BLOCK_ELEMENTS = 1 << 26     # pixel-Gaussian pairs in one block of tiles

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)


class Camera(NamedTuple):
    """Row-vector (transposed) world->view and world->clip matrices, the
    camera centre and the half-angle tangents, at width x height."""

    viewmatrix: torch.Tensor
    projmatrix: torch.Tensor
    campos: torch.Tensor
    tan_fovx: float
    tan_fovy: float
    width: int
    height: int


def quat_normalize(q, eps=1e-24):
    return q * torch.rsqrt(torch.clamp((q * q).sum(-1, keepdim=True),
                                       min=eps))


def quat_multiply(a, b):
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([aw * bw - ax * bx - ay * by - az * bz,
                        aw * bx + ax * bw + ay * bz - az * by,
                        aw * by - ax * bz + ay * bw + az * bx,
                        aw * bz + ax * by - ay * bx + az * bw], -1)


def world_gaussians(params: dict, binding=None, frames=None):
    """Activated Gaussians in world space: (means, scales, quats,
    opacities, SH [N, 3, K]). A bound Gaussian's position, scale and
    rotation are local to its face: rotated by the face's orientation,
    scaled by its scale and moved to its centre."""
    scales = torch.exp(params["scaling"])
    opac = torch.sigmoid(params["opacity"][:, 0])
    n = params["xyz"].shape[0]
    sh = torch.cat([params["features_dc"][:, :, None],
                    params["features_rest"].reshape(n, 3, -1)], dim=2)
    quats = quat_normalize(params["rotation"])
    if binding is None:
        return params["xyz"], scales, quats, opac, sh
    orient = frames["orient"][binding]
    fscale = frames["scale"][binding]
    means = torch.einsum("nij,nj->ni", orient, params["xyz"]) * fscale \
        + frames["center"][binding]
    quats = quat_multiply(quat_normalize(frames["quat"][binding]), quats)
    return means, scales * fscale, quats, opac, sh


def sh_colors(sh, dirs):
    """max(SH_deg3(dirs) + 0.5, 0) per channel; sh [N, 3, 16]."""
    x, y, z = dirs[:, 0:1], dirs[:, 1:2], dirs[:, 2:3]
    xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
    basis = torch.cat([
        torch.full_like(x, SH_C0), -SH_C1 * y, SH_C1 * z, -SH_C1 * x,
        SH_C2[0] * xy, SH_C2[1] * yz, SH_C2[2] * (2 * zz - xx - yy),
        SH_C2[3] * xz, SH_C2[4] * (xx - yy),
        SH_C3[0] * y * (3 * xx - yy), SH_C3[1] * xy * z,
        SH_C3[2] * y * (4 * zz - xx - yy),
        SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
        SH_C3[4] * x * (4 * zz - xx - yy), SH_C3[5] * z * (xx - yy),
        SH_C3[6] * x * (xx - 3 * yy)], dim=1)                      # [N, 16]
    k = sh.shape[2]
    return torch.clamp((sh * basis[:, None, :k]).sum(-1) + 0.5, min=0.0)


class Projected(NamedTuple):
    means2d: torch.Tensor   # [N, 2]
    depths: torch.Tensor    # [N]
    conics: torch.Tensor    # [N, 3] xx, xy, yy
    colors: torch.Tensor    # [N, 3]
    opacities: torch.Tensor
    radii: torch.Tensor     # [N] float, 0 where culled
    valid: torch.Tensor     # [N] bool


def project(means, scales, quats, opac, sh, cam: Camera, offset=None):
    """EWA splatting: the view-space cull at z <= 0.2, pixel centres
    ((ndc + 1) size - 1) / 2 (plus `offset` in NDC, whose gradient is the
    densification signal), the 2D covariance J W Sigma W^T J^T at the
    frustum-clamped position plus 0.3 px, its inverse, and the radius
    ceil(min(3 sqrt(lambda_max), sqrt(2 ln(255 opacity) lambda_max)))."""
    n = means.shape[0]
    fx = cam.width / (2.0 * cam.tan_fovx)
    fy = cam.height / (2.0 * cam.tan_fovy)
    hom = torch.cat([means, means.new_ones(n, 1)], -1)
    p_view = torch.matmul(hom, cam.viewmatrix)
    depths = p_view[:, 2]
    in_front = depths > 0.2
    p_hom = torch.matmul(hom, cam.projmatrix)
    w_hom = torch.where(in_front, p_hom[:, 3], torch.ones_like(depths))
    ndc = p_hom[:, :2] / (w_hom + 1e-7)[:, None]
    if offset is not None:
        ndc = ndc + offset
    means2d = torch.stack([((ndc[:, 0] + 1.0) * cam.width - 1.0) * 0.5,
                           ((ndc[:, 1] + 1.0) * cam.height - 1.0) * 0.5], -1)

    w, x, y, z = quat_normalize(quats).unbind(-1)
    r = torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1)], -2)           # [N,3,3]
    m = r * scales[:, None, :]
    sigma = torch.matmul(m, m.transpose(1, 2))                     # [N,3,3]

    tz = torch.clamp(p_view[:, 2], min=0.2)
    limx, limy = 1.3 * cam.tan_fovx, 1.3 * cam.tan_fovy
    tx = torch.clamp(p_view[:, 0] / tz, -limx, limx) * tz
    ty = torch.clamp(p_view[:, 1] / tz, -limy, limy) * tz
    zeros = torch.zeros_like(tz)
    jac = torch.stack([
        torch.stack([fx / tz, zeros, -fx * tx / (tz * tz)], -1),
        torch.stack([zeros, fy / tz, -fy * ty / (tz * tz)], -1)], -2)
    wrot = cam.viewmatrix[:3, :3].T                                # [3, 3]
    t = torch.matmul(jac, wrot)                                    # [N,2,3]
    cov = torch.matmul(torch.matmul(t, sigma), t.transpose(1, 2))
    cxx, cxy, cyy = cov[:, 0, 0] + 0.3, cov[:, 0, 1], cov[:, 1, 1] + 0.3

    det = cxx * cyy - cxy * cxy
    det_ok = det > 0.0
    inv = 1.0 / torch.where(det_ok, det, torch.ones_like(det))
    conics = torch.stack([cyy * inv, -cxy * inv, cxx * inv], -1)
    mid = 0.5 * (cxx + cyy)
    lam = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    tau = 2.0 * torch.log(torch.clamp(255.0 * opac, min=1e-12))
    r2 = torch.where(tau > 0.0, tau * torch.clamp(lam, min=0.0),
                     torch.full_like(tau, -1.0))
    radius = torch.ceil(torch.minimum(
        3.0 * torch.sqrt(torch.clamp(lam, min=0.0)),
        torch.sqrt(torch.clamp(r2, min=0.0)))).detach()
    m2 = means2d.detach()
    on_screen = ((m2[:, 0] + radius >= 0) & (m2[:, 0] - radius < cam.width)
                 & (m2[:, 1] + radius >= 0)
                 & (m2[:, 1] - radius < cam.height))
    valid = (in_front & det_ok & on_screen & (radius > 0)).detach()

    dirs = means - cam.campos
    dirs = dirs / torch.clamp(torch.linalg.norm(dirs, dim=-1, keepdim=True),
                              min=1e-12)
    return Projected(means2d, depths, conics, sh_colors(sh, dirs), opac,
                     torch.where(valid, radius, torch.zeros_like(radius)),
                     valid)


def tile_rects(means2d, radii, width, height, tile):
    """The rasterizer's square tile rect of each radius, [x0, x1) x
    [y0, y1) in tiles: floor((p - r) / ts) .. floor((p + r + ts - 1) / ts),
    clipped to the grid."""
    ntx, nty = -(-width // tile), -(-height // tile)
    m = means2d.detach()

    def lo(p, n):
        return torch.clamp(torch.floor((p - radii) / tile), 0, n).long()

    def hi(p, n):
        return torch.clamp(torch.floor((p + radii + tile - 1) / tile), 0,
                           n).long()

    return (lo(m[:, 0], ntx), lo(m[:, 1], nty), hi(m[:, 0], ntx),
            hi(m[:, 1], nty))


class Bins(NamedTuple):
    ids: torch.Tensor      # [slots] Gaussian of each slot, tile-major,
                           # depth order within a tile
    starts: torch.Tensor   # [T]
    counts: torch.Tensor   # [T]
    ntx: int
    nty: int


def bin_tiles(proj: Projected, width, height, tile) -> Bins:
    """Every valid Gaussian in every tile of its rect, in depth order (a
    stable sort: equal depths keep the index order)."""
    dev = proj.means2d.device
    ntx, nty = -(-width // tile), -(-height // tile)
    x0, y0, x1, y1 = tile_rects(proj.means2d, proj.radii, width, height, tile)
    order = torch.sort(torch.where(proj.valid, proj.depths.detach(),
                                   torch.full_like(proj.depths, math.inf)),
                       stable=True).indices
    order = order[proj.valid[order]]
    w = (x1 - x0)[order].clamp(min=0)
    h = (y1 - y0)[order].clamp(min=0)
    n_slot = (w * h)
    total = int(n_slot.sum())
    rank = torch.repeat_interleave(torch.arange(order.shape[0], device=dev),
                                   n_slot, output_size=total)
    local = torch.arange(total, device=dev) - (torch.cumsum(n_slot, 0)
                                               - n_slot)[rank]
    g = order[rank]
    tiles = (y0[g] + local // w[rank]) * ntx + x0[g] + local % w[rank]
    key = tiles * (order.shape[0] + 1) + rank
    srt = torch.sort(key).indices
    counts = torch.bincount(tiles, minlength=ntx * nty)
    starts = torch.cumsum(counts, 0) - counts
    return Bins(g[srt], starts, counts, ntx, nty)


def _block(mx, my, cxx, cxy, cyy, op, col, live, px, py):
    """One block of tiles: [G, P] colour and final transmittance, and the
    per-pair accept / blend masks (no gradient)."""
    dx = mx[:, None, :] - px[:, :, None]
    dy = my[:, None, :] - py[:, :, None]
    power = -0.5 * (cxx[:, None, :] * dx * dx + cyy[:, None, :] * dy * dy) \
        - cxy[:, None, :] * dx * dy
    e = op[:, None, :] * torch.exp(torch.clamp(power, max=0.0))
    accept = (power <= 0.0) & (e >= ALPHA_MIN) & live[:, None, :]
    alpha = torch.where(accept, torch.clamp(e, max=ALPHA_MAX),
                        torch.zeros_like(e))
    log_t = torch.log1p(-alpha)
    incl = torch.cumsum(log_t, dim=2)
    blend = (incl >= math.log(T_EPS)).detach() & accept
    weight = torch.where(blend, alpha * torch.exp(incl - log_t),
                         torch.zeros_like(alpha))
    color = torch.einsum("gpl,glc->gpc", weight, col)
    trans = torch.exp((log_t * blend).sum(2))
    return color, trans, accept, blend


def _block_out(*args):
    color, trans, _, _ = _block(*args)
    return color, trans


class Blended(NamedTuple):
    image: torch.Tensor     # [3, H, W] composited
    work: dict              # pairs the inputs need (see `blend`)


def blend(proj: Projected, bins: Bins, width, height, tile, bg,
          grad=False, count=False, block_elements=BLOCK_ELEMENTS) -> Blended:
    """The closed-form blend over blocks of tiles of similar length.

    With `count`, `work` holds what these inputs need of a blend kernel:
    `blended` pixel-Gaussian pairs, `needed` pairs evaluated (the blended
    ones and the one that stops each stopped pixel), `slots` the
    (tile, Gaussian) pairs with an accepted pixel, and `tiles`, `pixels`.
    """
    dev = proj.means2d.device
    p = tile * tile
    ly, lx = torch.meshgrid(torch.arange(tile, device=dev),
                            torch.arange(tile, device=dev), indexing="ij")
    lx, ly = lx.reshape(-1), ly.reshape(-1)
    counts = bins.counts.tolist()
    order = sorted((t for t in range(len(counts)) if counts[t] > 0),
                   key=lambda t: -counts[t])
    m2, con = proj.means2d, proj.conics
    colors_out, trans_out, pix_out = [], [], []
    work = dict(blended=0, needed=0, slots=0, tiles=len(counts),
                pixels=width * height)
    i = 0
    while i < len(order):
        length = counts[order[i]]
        g = max(1, min(len(order) - i, block_elements // (p * length)))
        tiles = torch.tensor(order[i:i + g], device=dev)
        i += g
        pos = torch.arange(length, device=dev)
        live = pos[None, :] < bins.counts[tiles][:, None]
        slot = torch.clamp(bins.starts[tiles][:, None] + pos[None, :],
                           max=bins.ids.shape[0] - 1)
        ids = bins.ids[slot]                                       # [G, L]
        px = ((tiles % bins.ntx) * tile)[:, None] + lx[None, :]
        py = ((tiles // bins.ntx) * tile)[:, None] + ly[None, :]
        inside = (px < width) & (py < height)
        args = (m2[ids, 0], m2[ids, 1], con[ids, 0], con[ids, 1],
                con[ids, 2], proj.opacities[ids], proj.colors[ids], live,
                px.float(), py.float())
        if grad:
            color, trans = checkpoint(_block_out, *args, use_reentrant=False)
        if count:
            with torch.no_grad():
                c, t, accept, bl = _block(*args)
                accept = accept & inside[:, :, None]
                bl = bl & inside[:, :, None]
                work["blended"] += int(bl.sum())
                work["needed"] += int(bl.sum()) + int(
                    (accept & ~bl).any(2).sum())
                work["slots"] += int(accept.any(1).sum())
            del accept, bl
            if not grad:
                color, trans = c, t
        elif not grad:
            color, trans = _block_out(*args)
        keep = inside.reshape(-1)
        colors_out.append(color.reshape(-1, 3)[keep])
        trans_out.append(trans.reshape(-1)[keep])
        pix_out.append((py * width + px).reshape(-1)[keep])
    color = torch.zeros(width * height, 3, device=dev)
    trans = torch.ones(width * height, device=dev)
    if pix_out:
        pix = torch.cat(pix_out)
        color = color.index_put((pix,), torch.cat(colors_out))
        trans = trans.index_put((pix,), torch.cat(trans_out))
    image = (color + trans[:, None] * bg[None, :]).T.reshape(3, height, width)
    return Blended(image, work)


def render(params, binding, frames, cam: Camera, bg, tile=32, offset=None,
           grad=False, count=False):
    """World-space Gaussians, projection, binning and blend of one view:
    (Blended, Projected)."""
    proj = project(*world_gaussians(params, binding, frames), cam,
                   offset=offset)
    bins = bin_tiles(proj, cam.width, cam.height, tile)
    return blend(proj, bins, cam.width, cam.height, tile, bg, grad=grad,
                 count=count), proj
