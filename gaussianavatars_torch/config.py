"""Render-path configuration (the subset of `gaussianavatars_tpu/config.py`
that the serving path reads)."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class PipelineConfig:
    """Pipeline knobs read by `train/loop.make_render_fn`.

    tile_size: square pixel tile of the blend (16 or 32).
    binning: instance-stream builder; "dense" (the exact ellipse-culled
      duplicated-key sort of `ops/binning_dense.py`) is the only one ported.
    """

    tile_size: int = 32
    binning: str = "dense"
