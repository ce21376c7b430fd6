"""Render and training configuration (the subset of
`gaussianavatars_tpu/config.py` that the serving path and the train step
read)."""

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


@dataclass
class OptimizationConfig:
    """Learning rates and loss weights of the train step: the fields of
    `gaussianavatars_tpu/config.py::OptimizationConfig` (reference
    arguments/__init__.py:76-110) that the step and `lr_pytree` read, with
    the same defaults. The xyz schedule and densification fields belong to
    the host loop, which is not ported yet."""

    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.017
    rotation_lr: float = 0.001
    flame_expr_lr: float = 1e-3
    flame_trans_lr: float = 1e-6
    flame_pose_lr: float = 1e-5
    lambda_dssim: float = 0.2
    lambda_xyz: float = 1e-2
    threshold_xyz: float = 1.0
    metric_xyz: bool = False
    lambda_scale: float = 1.0
    threshold_scale: float = 0.6
    metric_scale: bool = False
    lambda_dynamic_offset: float = 0.0
    lambda_laplacian: float = 0.0
    lambda_dynamic_offset_std: float = 0.0
