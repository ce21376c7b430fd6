"""Tile binning by rect expansion and one stable sort by tile (port of
`gaussianavatars_tpu/ops/binning.py`), selected by `--binning sort`.

The GPU form of the JAX function, with exact dynamic shapes:

  1. gaussians are depth-sorted once (stable, invalid ones last)
  2. each gaussian, in depth order, is expanded over the square tile rect
     of its radius (the CUDA getRect rule, `compute_tile_rects`)
  3. a slot is dropped when the tile's pixel box lies entirely beyond
     sqrt(r2_max) pixels of the centre (no pixel there can reach alpha >=
     1/255; image-exact, but looser than the dense path's ellipse-box
     test, so the blend kernels' per-warp cull removes the rest)
  4. one stable sort by tile id orders the stream; stability keeps the
     depth order of step 2 within a tile
  5. per-tile [start, end) by searchsorted

The stream equals the JAX function's slot for slot (gaussian ids, starts
and ends). `SortBinning.total` is the stream length, the kept slots; the
JAX `total` counts the rect slots before the cull, to size its static
capacity bucket, and is not carried. The JAX `chunk_align` /
`AlignedBinning` (a Pallas chunk relayout no caller uses) is not ported.
`compute_tile_rects_ext` (the dense path's per-axis rect) lives here, as
in the JAX package. All of this is bookkeeping without gradients. The
host waits twice, for the slot count and the cull's compaction: the
`utils/trace.py` syncs "sync.slots" and "sync.keep".
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gaussianavatars_torch.utils.trace import sync


class SortBinning(NamedTuple):
    gaussian_ids: torch.Tensor  # [total] int64 gaussian per stream slot
    tile_starts: torch.Tensor   # [T] int32
    tile_ends: torch.Tensor     # [T] int32
    total: int                  # stream length (kept slots)
    num_tiles_x: int
    num_tiles_y: int


def tile_grid(width: int, height: int, tile_size: int) -> tuple[int, int]:
    return (-(-width // tile_size), -(-height // tile_size))


def compute_tile_rects(means2d, radii, width, height, tile_size):
    """Square tile rect (x0, y0, x1, y1) int64 of each gaussian's radius
    (CUDA getRect: floor((p - r)/ts) .. floor((p + r + ts - 1)/ts), clipped
    to the grid), in float32 in the JAX expression order."""
    ntx, nty = tile_grid(width, height, tile_size)
    r = radii.to(means2d.dtype)
    mx, my = means2d[:, 0], means2d[:, 1]

    def lo(p, n):
        return torch.clamp(torch.floor((p - r) / tile_size), 0, n).to(
            torch.int64)

    def hi(p, n):
        return torch.clamp(torch.floor((p + r + tile_size - 1) / tile_size),
                           0, n).to(torch.int64)

    return lo(mx, ntx), lo(my, nty), hi(mx, ntx), hi(my, nty)


def compute_tile_rects_ext(means2d, ext_x, ext_y, radii, width, height,
                           tile_size):
    """Tile AABB (x0, y0, x1, y1) int64 from per-axis half extents
    (floor((p +- ext)/ts), + 1 on the far side), intersected with the
    square rect of `radii` (`compute_tile_rects`). Zero-extent gaussians
    get empty rects."""
    ntx, nty = tile_grid(width, height, tile_size)
    x0r, y0r, x1r, y1r = compute_tile_rects(means2d, radii, width, height,
                                            tile_size)

    def span(p, e, n, lo_r, hi_r):
        lo_e = torch.clamp(torch.floor((p - e) / tile_size), 0, n)
        hi_e = torch.clamp(torch.floor((p + e) / tile_size) + 1, 0, n)
        return (torch.maximum(lo_e.to(torch.int64), lo_r),
                torch.minimum(hi_e.to(torch.int64), hi_r))

    x0, x1 = span(means2d[:, 0], ext_x, ntx, x0r, x1r)
    y0, y1 = span(means2d[:, 1], ext_y, nty, y0r, y1r)
    empty = (ext_x <= 0.0) | (ext_y <= 0.0)
    x1 = torch.where(empty, x0, x1)
    y1 = torch.where(empty, y0, y1)
    return x0, y0, x1, y1


def bin_gaussians(means2d, depths, radii, valid, r2_max, width: int,
                  height: int, tile_size: int, tile_row_start: int = 0,
                  tile_rows: int | None = None) -> SortBinning:
    """Build the tile-major depth-sorted instance stream.

    Args mirror the JAX function with its cull inputs (`means2d` is also
    the cull centre; `r2_max` from ops/projection.py). `tile_row_start` /
    `tile_rows` bin a window of tile rows: tile ids are local to it, the
    cull uses the global pixel rows.
    """
    dev = means2d.device
    n = means2d.shape[0]
    ntx, nty_full = tile_grid(width, height, tile_size)
    nty = nty_full if tile_rows is None else tile_rows
    num_tiles = ntx * nty

    # ---- depth order (stable: ties keep the original index order) ---------
    depth_key = torch.where(valid, depths,
                            torch.full_like(depths, float("inf")))
    perm = torch.sort(depth_key, stable=True).indices

    # ---- square rects, in depth order -------------------------------------
    means_s = means2d[perm]
    x0, y0, x1, y1 = compute_tile_rects(means_s, radii[perm], width, height,
                                        tile_size)
    y0 = torch.clamp(y0 - tile_row_start, 0, nty)
    y1 = torch.clamp(y1 - tile_row_start, 0, nty)
    rw = torch.clamp(x1 - x0, min=0)
    rh = torch.clamp(y1 - y0, min=0)
    counts = torch.where(valid[perm], rw * rh, torch.zeros_like(rw))

    # ---- expand every gaussian over its rect, depth order kept ------------
    with sync("sync.slots"):
        n_slots = int(counts.sum())
    owner = torch.repeat_interleave(
        torch.arange(n, device=dev), counts, output_size=n_slots)
    local = torch.arange(n_slots, device=dev) - (
        torch.cumsum(counts, 0) - counts)[owner]
    rw_o = rw[owner]
    tx = x0[owner] + local % rw_o
    ty = y0[owner] + local // rw_o

    # ---- r2_max disc against the tile's pixel box (float32, JAX order) ----
    ts = float(tile_size)
    bx_lo = tx.to(torch.float32) * ts
    by_lo = (ty + tile_row_start).to(torch.float32) * ts
    mx, my = means_s[owner, 0], means_s[owner, 1]
    zero = torch.zeros((), device=dev)
    dx = torch.maximum(torch.maximum(bx_lo - mx, mx - (bx_lo + ts - 1)), zero)
    dy = torch.maximum(torch.maximum(by_lo - my, my - (by_lo + ts - 1)), zero)
    hit = dx * dx + dy * dy <= r2_max[perm][owner]
    with sync("sync.keep"):
        kept = torch.nonzero(hit).squeeze(1)

    # ---- one stable sort by tile (depth order inherited) ------------------
    tile_id = (ty * ntx + tx)[kept].to(torch.int32)
    sorted_tile, order = torch.sort(tile_id, stable=True)
    gaussian_ids = perm[owner[kept][order]]

    tiles = torch.arange(num_tiles, device=dev, dtype=torch.int32)
    tile_starts = torch.searchsorted(sorted_tile, tiles).to(torch.int32)
    tile_ends = torch.searchsorted(sorted_tile, tiles, right=True).to(
        torch.int32)
    return SortBinning(
        gaussian_ids=gaussian_ids, tile_starts=tile_starts,
        tile_ends=tile_ends, total=int(sorted_tile.shape[0]),
        num_tiles_x=ntx, num_tiles_y=nty)
