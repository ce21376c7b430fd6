"""Tile binning: the tile-major, depth-ordered instance stream (port of
`gaussianavatars_tpu/ops/binning_dense.py::bin_gaussians_dense`).

The GPU form is the reference CUDA rasterizer's duplicated-key sort
(SURVEY.md N1) with exact dynamic shapes:

  1. gaussians are depth-sorted once (stable, invalid ones last); the depth
     RANK orders instances within a tile
  2. each gaussian's tile rect from its per-axis extents
     (ops/binning.py::compute_tile_rects_ext, as in the JAX package)
  3. every gaussian is expanded over its rect (one slot per covered tile)
  4. the exact ellipse-box cull drops a slot whose tile box holds no pixel
     with q <= tau, i.e. no pixel the blend could accept (image-exact)
  5. int64 keys tile << 32 | depth_rank are sorted (unique keys)
  6. per-tile [start, end) by searchsorted

It produces the same stream as the JAX function (same `total`, ranges and
gaussian-id order); the JAX level plan, buckets and RANK_BITS packing exist
only for the TPU's static shapes and are not ported. All of this is
bookkeeping without gradients. The host waits twice, for the slot count
(step 3) and the cull's compaction (step 4): the `utils/trace.py` syncs
"sync.slots" and "sync.keep", after which the two lengths are added to the
counters "slots_expanded" and "slots_kept".
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gaussianavatars_torch.ops.binning import (
    compute_tile_rects_ext,
    tile_grid,
)
from gaussianavatars_torch.utils.trace import (
    SLOTS_EXPANDED,
    SLOTS_KEPT,
    count,
    sync,
)


class DenseBinning(NamedTuple):
    gaussian_ids: torch.Tensor  # [total] int64 gaussian per stream slot
    tile_starts: torch.Tensor   # [T] int32
    tile_ends: torch.Tensor     # [T] int32
    total: int                  # stream length
    num_tiles_x: int
    num_tiles_y: int


def _box_qmin(ax, bx, ay, by, cxx, cxy, cyy, rx, ry):
    """Exact min of q(d) = cxx dx^2 + 2 cxy dx dy + cyy dy^2 over the box
    [ax,bx] x [ay,by] (relative to the gaussian center). q is convex: 0 if
    the origin is inside, else the min over the four edges, each a clamped
    1D quadratic (rx = -cxy/cyy, ry = -cxy/cxx are the unconstrained
    argmin slopes)."""
    def edge_x(e):
        ystar = torch.minimum(torch.maximum(rx * e, ay), by)
        return (cxx * e + 2.0 * cxy * ystar) * e + cyy * ystar * ystar

    def edge_y(e):
        xstar = torch.minimum(torch.maximum(ry * e, ax), bx)
        return (cyy * e + 2.0 * cxy * xstar) * e + cxx * xstar * xstar

    qmin = torch.minimum(torch.minimum(edge_x(ax), edge_x(bx)),
                         torch.minimum(edge_y(ay), edge_y(by)))
    inside = (ax <= 0.0) & (bx >= 0.0) & (ay <= 0.0) & (by >= 0.0)
    return torch.where(inside, torch.zeros_like(qmin), qmin)


def bin_gaussians_dense(means2d, depths, radii, valid, conics, tau, ext_x,
                        ext_y, width: int, height: int, tile_size: int,
                        tile_row_start: int = 0,
                        tile_rows: int | None = None) -> DenseBinning:
    """Build the tile-major depth-sorted instance stream.

    Args mirror the JAX function with its exact-cull inputs (`conics`,
    `tau`, `ext_x`, `ext_y` from ops/projection.py). `tile_row_start` /
    `tile_rows` bin a window of tile rows; tile ids are local to it.
    """
    dev = means2d.device
    n = means2d.shape[0]
    ntx, nty_full = tile_grid(width, height, tile_size)
    nty = nty_full if tile_rows is None else tile_rows
    num_tiles = ntx * nty

    # ---- depth order (stable: ties keep the original index order) ---------
    depth_key = torch.where(valid, depths, torch.full_like(depths, float("inf")))
    perm = torch.sort(depth_key, stable=True).indices
    rank = torch.empty_like(perm)
    rank[perm] = torch.arange(n, device=dev)

    x0, y0, x1, y1 = compute_tile_rects_ext(
        means2d, ext_x, ext_y, radii, width, height, tile_size)
    y0 = torch.clamp(y0 - tile_row_start, 0, nty)
    y1 = torch.clamp(y1 - tile_row_start, 0, nty)
    rw = torch.clamp(x1 - x0, min=0)
    rh = torch.clamp(y1 - y0, min=0)
    counts = torch.where(valid, rw * rh, torch.zeros_like(rw))

    # ---- expand every gaussian over its rect ------------------------------
    with sync("sync.slots"):
        n_slots = int(counts.sum())
    count(SLOTS_EXPANDED, n_slots)
    gid = torch.repeat_interleave(
        torch.arange(n, device=dev), counts, output_size=n_slots)
    local = torch.arange(n_slots, device=dev) - (
        torch.cumsum(counts, 0) - counts)[gid]
    rw_g = rw[gid]
    tx = x0[gid] + local % rw_g
    ty = y0[gid] + local // rw_g

    # ---- exact ellipse-box cull (float32, the JAX expression order) -------
    ts = float(tile_size)
    cxx, cxy, cyy = conics[:, 0], conics[:, 1], conics[:, 2]
    rx = (-cxy / torch.clamp(cyy, min=1e-12))[gid]
    ry = (-cxy / torch.clamp(cxx, min=1e-12))[gid]
    bx_lo = tx.to(torch.float32) * ts
    by_lo = (ty + tile_row_start).to(torch.float32) * ts
    mx, my = means2d[gid, 0], means2d[gid, 1]
    qmin = _box_qmin(bx_lo - mx, bx_lo + ts - 1 - mx,
                     by_lo - my, by_lo + ts - 1 - my,
                     cxx[gid], cxy[gid], cyy[gid], rx, ry)
    keep = qmin <= tau[gid]

    # ---- one sort of unique keys tile << 32 | depth_rank ------------------
    keys = (ty * ntx + tx) << 32 | rank[gid]
    with sync("sync.keep"):
        keys = keys[keep]
    count(SLOTS_KEPT, keys.shape[0], ranged=True)
    sorted_keys = torch.sort(keys).values
    gaussian_ids = perm[sorted_keys & 0xFFFFFFFF]

    tiles = torch.arange(num_tiles, device=dev, dtype=torch.int64)
    tile_starts = torch.searchsorted(sorted_keys, tiles << 32).to(torch.int32)
    tile_ends = torch.searchsorted(sorted_keys, (tiles + 1) << 32).to(
        torch.int32)
    return DenseBinning(
        gaussian_ids=gaussian_ids, tile_starts=tile_starts,
        tile_ends=tile_ends, total=int(sorted_keys.shape[0]),
        num_tiles_x=ntx, num_tiles_y=nty)
