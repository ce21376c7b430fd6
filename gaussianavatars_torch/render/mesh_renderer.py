"""Non-differentiable mesh rasterizer for overlays and viewers (port of
`gaussianavatars_tpu/render/mesh_renderer.py`; the reference uses
nvdiffrast, mesh_renderer/__init__.py:183-274).

A z-buffered, flat-shaded rasterizer of plain torch operations:

  * every valid face (all three view depths above 0.01) tests the pixel
    centres of its exact pixel bounding box, clipped to the image: the
    candidates are laid out with `repeat_interleave` over the box sizes,
    in chunks of faces whose boxes hold at most `_CANDIDATES` pixels
    together, so a face that fills the frame costs its box and no more;
  * the z-buffer takes two passes, as in the JAX package: the least depth
    per pixel (`scatter_reduce_` "amin"), then the least face id among the
    candidates at that depth, so equal depths resolve to the smallest face
    id;
  * shading follows the reference's 'constant' and 'front' modes, with
    optional per-face albedo; `antialias=True` renders at 2x and
    box-filters down (the stand-in for dr.antialias).

The JAX package tests each face on fixed patches in three passes (32 px
for all faces, 128 px for the 1024 faces with the largest boxes, the whole
frame for the 64 largest), since a TPU program needs static shapes; the
port's boxes are exact. Where those buckets hold every face that needs
them (at most 64 faces wider than 128 px and 1024 wider than 32 px), both
cover the same pixels.

`render_mesh` returns the reference's {albedo, normal, diffuse, rgba};
`rasterize_mesh` is the viewers' tuple API; `render_mesh_overlay`
composites the shaded mesh over an image (reference train.py:85-93).
"""

from __future__ import annotations

import bisect

import torch

from gaussianavatars_torch.ops.projection import CameraParams, ndc2pix

_BIG = 1e10
_NOFACE = 2 ** 30
_CANDIDATES = 1 << 22      # candidate pixels laid out at once


def _bbox(coords: torch.Tensor, size: int):
    """Integer pixel range [lo, hi] of each face's box along one axis,
    clipped to [0, size - 1] (hi < lo when the box misses the image)."""
    lo = torch.floor(coords.amin(dim=1)).clamp(0, size - 1)
    hi = torch.floor(coords.amax(dim=1)).clamp(max=size - 1)
    return lo.to(torch.int64), hi.to(torch.int64)


def _candidates(v0, v1, v2, z, lo_x, lo_y, box_w, counts, width):
    """The covered pixels of one chunk of faces: (flat pixel index, depth,
    chunk-local face index), one entry per covered pixel."""
    dev = z.device
    n_faces = counts.shape[0]
    face = torch.repeat_interleave(torch.arange(n_faces, device=dev), counts)
    first = torch.cumsum(counts, 0) - counts
    offs = torch.arange(face.shape[0], device=dev) - first[face]
    bw = box_w[face]
    px = lo_x[face] + offs % bw
    py = lo_y[face] + torch.div(offs, bw, rounding_mode="floor")
    fx, fy = px.to(torch.float32), py.to(torch.float32)

    def edge(a, b):
        a, b = a[face], b[face]
        return ((fx - a[:, 0]) * (b[:, 1] - a[:, 1])
                - (fy - a[:, 1]) * (b[:, 0] - a[:, 0]))

    e0 = edge(v0, v1)
    e1 = edge(v1, v2)
    e2 = edge(v2, v0)
    inside = (((e0 >= 0) & (e1 >= 0) & (e2 >= 0))
              | ((e0 <= 0) & (e1 <= 0) & (e2 <= 0)))
    face = face[inside]
    return (py[inside] * width + px[inside]), z[face], face


def _rasterize(xy: torch.Tensor, depths: torch.Tensor, faces: torch.Tensor,
               width: int, height: int):
    """Returns (covered [H, W] bool, zbuf [H, W], face id [H, W]; 0 where
    nothing covers the pixel)."""
    dev = xy.device
    d = depths[faces]                                     # [F, 3]
    valid = (d > 0.01).all(dim=1)
    ids = torch.nonzero(valid).squeeze(1)
    tri = xy[faces[ids]]                                  # [F', 3, 2]
    z = (d[ids, 0] + d[ids, 1] + d[ids, 2]) / 3.0
    lo_x, hi_x = _bbox(tri[:, :, 0], width)
    lo_y, hi_y = _bbox(tri[:, :, 1], height)
    box_w = (hi_x - lo_x + 1).clamp(min=0)
    counts = box_w * (hi_y - lo_y + 1).clamp(min=0)

    pix, depth, face = [], [], []
    ends = torch.cumsum(counts, 0).tolist()
    start, base = 0, 0
    while start < len(ends):
        # the chunk: faces until their boxes pass the candidate budget (at
        # least one face)
        stop = max(bisect.bisect_right(ends, base + _CANDIDATES), start + 1)
        c = slice(start, stop)
        p, dz, f = _candidates(tri[c, 0], tri[c, 1], tri[c, 2], z[c],
                               lo_x[c], lo_y[c], box_w[c], counts[c], width)
        pix.append(p)
        depth.append(dz)
        face.append(ids[c][f])
        base = ends[stop - 1]
        start = stop
    pix = torch.cat(pix) if pix else torch.zeros(0, dtype=torch.int64,
                                                 device=dev)
    depth = torch.cat(depth) if depth else torch.zeros(0, device=dev)
    face = torch.cat(face) if face else torch.zeros(0, dtype=torch.int64,
                                                    device=dev)

    zbuf = torch.full((height * width,), _BIG, device=dev)
    zbuf.scatter_reduce_(0, pix, depth, "amin")
    winner = torch.where(depth <= zbuf[pix], face,
                         torch.full_like(face, _NOFACE))
    fid = torch.full((height * width,), _NOFACE, dtype=torch.int64,
                     device=dev)
    fid.scatter_reduce_(0, pix, winner, "amin")
    covered = (zbuf < _BIG).reshape(height, width)
    fid = torch.where(fid == _NOFACE, 0, fid).reshape(height, width)
    return covered, zbuf.reshape(height, width), fid


def _transform(verts, m):
    """[x y z 1] @ m for verts [V, 3] and a 4x4 m, summed in pairs,
    ((x m0 + y m1) + (z m2 + m3)): the order of the JAX package's float32
    product on the CPU, so that the two place every vertex bit for bit."""
    return ((verts[:, 0:1] * m[0] + verts[:, 1:2] * m[1])
            + (verts[:, 2:3] * m[2] + m[3]))


def _project(verts, faces, camera: CameraParams, width, height):
    """Pixel positions [V, 2], view depths [V] and unit camera-space face
    normals [F, 3]."""
    p_view = _transform(verts, camera.viewmatrix)
    depths = p_view[:, 2]
    p_hom = _transform(verts, camera.projmatrix)
    ndc = p_hom[:, :2] / (p_hom[:, 3:4] + 1e-7)
    xy = torch.stack([ndc2pix(ndc[:, 0], width), ndc2pix(ndc[:, 1], height)],
                     dim=-1)
    vcam = p_view[:, :3]
    n = torch.cross(vcam[faces[:, 1]] - vcam[faces[:, 0]],
                    vcam[faces[:, 2]] - vcam[faces[:, 0]], dim=-1)
    n = n / torch.linalg.norm(n, dim=-1, keepdim=True).clamp(min=1e-12)
    return xy, depths, n


def _shade(normal, lighting_type):
    """The reference's modes (mesh_renderer/__init__.py:174-181); 'front'
    uses the winding-agnostic |n.z|, as the JAX package does."""
    if lighting_type == "constant":
        return torch.ones_like(normal[..., :1])
    if lighting_type == "front":
        return torch.clamp(torch.abs(normal[..., 2:3]), 0.0, 1.0)
    raise NotImplementedError(f"Unknown lighting type: {lighting_type}")


def _faces(faces, device):
    return torch.as_tensor(faces, device=device).to(torch.int64)


@torch.no_grad()
def render_mesh(verts, faces, camera: CameraParams, background_color=None,
                face_colors=None, lighting_type: str = "front",
                antialias: bool = False) -> dict:
    """The reference's NVDiffRenderer.render_from_camera
    (mesh_renderer/__init__.py:183-274): verts [V, 3] and faces [F, 3] on
    the camera's device. Returns {albedo [H,W,3], normal [H,W,3], diffuse
    [H,W,3], rgba [H,W,4]}.

    `background_color` is a 3-vector (constant) or an [H, W, 3] image;
    `face_colors` an optional [F, 3] albedo table; `antialias` renders at
    2x and box-filters.
    """
    dev = camera.viewmatrix.device
    verts = torch.as_tensor(verts, dtype=torch.float32, device=dev)
    faces = _faces(faces, dev)
    w, h = camera.width, camera.height
    scale = 2 if antialias else 1
    rw, rh = w * scale, h * scale

    xy, depths, normals = _project(verts, faces, camera, rw, rh)
    covered, _, fid = _rasterize(xy, depths, faces, rw, rh)

    normal = normals[fid]                                   # [H, W, 3]
    if face_colors is not None:
        albedo = torch.as_tensor(face_colors, dtype=torch.float32,
                                 device=dev)[fid]
    else:
        albedo = torch.ones(fid.shape + (3,), device=dev)
    diffuse = _shade(normal, lighting_type)
    rgba = torch.cat([albedo * diffuse,
                      covered.to(torch.float32)[..., None]], dim=-1)

    if background_color is None:
        background_color = [1.0, 1.0, 1.0]
    bg = torch.as_tensor(background_color, dtype=torch.float32, device=dev)
    if bg.ndim == 1:
        bg_img = bg.expand(fid.shape + (3,))
    else:
        bg_img = bg.repeat_interleave(scale, 0).repeat_interleave(scale, 1)
    mask = covered[..., None]
    normal = torch.where(mask, normal, bg_img)
    diffuse3 = torch.where(mask, diffuse.expand(normal.shape), bg_img)
    bg_rgba = torch.cat([bg_img, torch.zeros_like(bg_img[..., :1])], dim=-1)
    rgba = torch.where(mask, rgba, bg_rgba)

    out = {"albedo": albedo, "normal": normal, "diffuse": diffuse3,
           "rgba": rgba}
    if scale != 1:
        out = {k: v.reshape(h, scale, w, scale, v.shape[-1]).mean(dim=(1, 3))
               for k, v in out.items()}
    return out


@torch.no_grad()
def rasterize_mesh(verts, faces, camera: CameraParams):
    """Flat-shaded mesh raster (the viewers' tuple API): (rgb [H,W,3],
    alpha [H,W], depth [H,W], face id [H,W])."""
    dev = camera.viewmatrix.device
    verts = torch.as_tensor(verts, dtype=torch.float32, device=dev)
    faces = _faces(faces, dev)
    xy, depths, normals = _project(verts, faces, camera, camera.width,
                                   camera.height)
    covered, zbuf, fid = _rasterize(xy, depths, faces, camera.width,
                                    camera.height)
    rgb = torch.abs(normals[fid][..., 2:3]).expand(fid.shape + (3,))
    return rgb, covered.to(torch.float32), zbuf, fid


@torch.no_grad()
def render_mesh_overlay(verts, faces, camera: CameraParams, background=None,
                        opacity: float = 0.5) -> torch.Tensor:
    """The shaded mesh composited over `background` [3, H, W] (default
    white) with the reference's rule (train.py:85-93). Returns [3, H, W]."""
    rgb, alpha, _, _ = rasterize_mesh(verts, faces, camera)
    rgb = rgb.permute(2, 0, 1)
    alpha = alpha[None]
    if background is None:
        background = torch.ones_like(rgb)
    else:
        background = torch.as_tensor(background, dtype=torch.float32,
                                     device=rgb.device)
    return (rgb * alpha * opacity
            + background * (alpha * (1.0 - opacity) + (1.0 - alpha)))
