"""The frozen work counts: FP32 operations and bytes that a train step, a
frame and the two blend kernels need, from the shapes and from the pixel
pairs that the benchmark's own plain binning and blend of the same view
need (`reference/render.py::blend` with `count=True`).

A pair is what a pixel needs of one Gaussian: the `needed` pairs are the
blended ones and the one that stops each stopped pixel; the pairs a
perfect cull would skip (alpha below 1/255 everywhere in reach) are not
counted, so no kernel design can do less than this count asks. A
transcendental (exp, log, sqrt) counts as one operation; integer,
comparison-only and sorting work (the binning) is not counted. Bytes count
each input byte read once and each output byte written once.

`w` below is one view's work: `needed`, `blended`, `slots` (tile-Gaussian
pairs with a blended pixel), `tiles`, `pixels`, and the shapes
`gaussians`, `vertices`, `faces`, `flame_elems` (fine-tuned FLAME
elements, 0 unbound), `bound`.
"""

from __future__ import annotations

import json
import os

PEAKS_FILE = os.path.join(os.path.dirname(__file__), "peaks.json")

# per pixel pair: the quadratic (dx, dy, 9 products and sums), opacity *
# exp and the clamp; per blended pair on top: 1 - alpha, T update, weight,
# three colour FMAs
PAIR_FLOPS = 13
BLEND_FLOPS = 9
# the backward's extra work per blended pair: c.G 5, the inclusive prefix
# 2, d_color 6, d_alpha 4, d_power 1, d_mean 10, d_conic 11, d_opacity 2
BLEND_BWD_FLOPS = BLEND_FLOPS + 41
K1_ROW_BYTES = 36            # one stream row: mean 2, conic 3, colour 3, op 1

# per Gaussian, forward: activations 15, projection 240, SH degree 3 155;
# bound: the binding chain 60; per face: the frame 90; per vertex: FLAME's
# 400 blend shapes (2400), pose correctives (216) and skinning (180)
GAUSS_FWD_FLOPS = 15 + 240 + 155
BINDING_FLOPS = 60
FACE_FLOPS = 90
VERTEX_FLOPS = 2400 + 216 + 180
# per pixel: composite 2 a channel; the loss L1 3 a channel and D-SSIM 730
# (five separable 11-tap blurs of three channels, 660, and the map, 70);
# the backward of a dense per-pixel stage costs twice its forward
COMPOSITE_FLOPS = 6
LOSS_FLOPS = 9 + 730
# Adam per parameter element; the densification statistics per Gaussian
ADAM_FLOPS = 11
STATS_FLOPS = 6
REG_FLOPS = 20               # the xyz and scale regularizers per Gaussian
GAUSS_ELEMS = 3 + 3 + 45 + 3 + 4 + 1


def peaks() -> dict:
    with open(PEAKS_FILE) as fh:
        return json.load(fh)


def blend_fwd(w: dict) -> tuple[float, float]:
    """(FP32 operations, bytes) kernel K1 needs for one view."""
    flops = PAIR_FLOPS * w["needed"] + BLEND_FLOPS * w["blended"]
    nbytes = K1_ROW_BYTES * w["slots"] + 8 * w["tiles"] + 16 * w["pixels"]
    return float(flops), float(nbytes)


def blend_bwd(w: dict) -> tuple[float, float]:
    """(FP32 operations, bytes) kernel K2 needs: the stream and the
    forward's four planes and their cotangents in, a gradient row per
    stream row out."""
    flops = PAIR_FLOPS * w["needed"] + BLEND_BWD_FLOPS * w["blended"]
    nbytes = (2 * K1_ROW_BYTES * w["slots"] + 8 * w["tiles"]
              + 32 * w["pixels"])
    return float(flops), float(nbytes)


def bound_seconds(flops: float, nbytes: float, pk: dict) -> float:
    """The least time the card could take: the larger of the operations
    over the FP32 peak and the bytes over the memory rate."""
    return max(flops / pk["fp32_flops_per_s"], nbytes / pk["hbm_bytes_per_s"])


def _forward(w: dict) -> float:
    f = GAUSS_FWD_FLOPS * w["gaussians"] + COMPOSITE_FLOPS * w["pixels"]
    if w["bound"]:
        f += (BINDING_FLOPS * w["gaussians"] + FACE_FLOPS * w["faces"]
              + VERTEX_FLOPS * w["vertices"])
    return f + blend_fwd(w)[0]


def frame_flops(w: dict) -> float:
    """A served frame: the forward and the uint8 conversion (2 a value)."""
    return _forward(w) + 2 * 3 * w["pixels"]


def step_flops(w: dict) -> float:
    """A train step: the forward, the losses, their backward (twice the
    forward's dense work, K2's count for the blend, the gather's
    scatter-add of 9 a slot), Adam and the statistics."""
    fwd = _forward(w) - blend_fwd(w)[0]
    loss = LOSS_FLOPS * w["pixels"] + (REG_FLOPS * w["gaussians"]
                                       if w["bound"] else 0)
    bwd = 2 * (fwd + loss) + blend_bwd(w)[0] + 9 * w["slots"]
    adam = ADAM_FLOPS * (GAUSS_ELEMS * w["gaussians"] + w["flame_elems"])
    return (fwd + blend_fwd(w)[0] + loss + bwd + adam
            + STATS_FLOPS * w["gaussians"])
