"""Dataclass configuration with reflective argparse flags (port of
`gaussianavatars_tpu/config.py`; reference arguments/__init__.py:19-132).

Flag names, shorthands and defaults are the reference's, so command lines
transfer. A run's `ModelConfig` persists as `cfg.json` (what
`get_combined_config` and `load_config` read) and as the repr-style
`cfg_args` of the reference tools, which is written but never evaluated.
"""

from __future__ import annotations

import dataclasses
import json
import os
from argparse import ArgumentParser, Namespace
from dataclasses import dataclass


def _add_group(parser: ArgumentParser, cfg, name: str, shorthand_fields=(),
               sentinel: bool = False):
    """Reflect dataclass fields into argparse flags. With `sentinel`,
    defaults become None so that a saved config can fill them in
    (reference ParamGroup(fill_none))."""
    group = parser.add_argument_group(name)
    for f in dataclasses.fields(cfg):
        key = f.name
        default = getattr(cfg, key)
        flags = [f"--{key}"]
        if key in shorthand_fields:
            flags.append(f"-{key[0]}")
        if isinstance(default, bool):
            group.add_argument(*flags, default=None if sentinel else default,
                               action="store_true")
        else:
            group.add_argument(*flags, default=None if sentinel else default,
                               type=type(default))
    return group


def _extract(cfg_cls, args: Namespace):
    known = {f.name for f in dataclasses.fields(cfg_cls)}
    return cfg_cls(**{k: v for k, v in vars(args).items()
                      if k in known and v is not None})


@dataclass
class ModelConfig:
    """reference arguments/__init__.py:47-67 (ModelParams).

    `data_device` is accepted for command-line compatibility and ignored:
    ground-truth images live on the training device under a budget
    (`train/loop.py`)."""

    sh_degree: int = 3
    source_path: str = ""
    target_path: str = ""
    model_path: str = ""
    images: str = "images"
    resolution: int = -1
    white_background: bool = False
    data_device: str = "cuda"
    eval: bool = False
    bind_to_mesh: bool = False
    disable_flame_static_offset: bool = False
    not_finetune_flame_params: bool = False
    select_camera_id: int = -1

    SHORTHANDS = ("source_path", "target_path", "model_path", "images",
                  "resolution", "white_background")

    @classmethod
    def add_to_parser(cls, parser, sentinel=False):
        _add_group(parser, cls(), "Loading Parameters", cls.SHORTHANDS,
                   sentinel=sentinel)

    @classmethod
    def extract(cls, args):
        cfg = _extract(cls, args)
        cfg.source_path = os.path.abspath(cfg.source_path)
        return cfg


@dataclass
class PipelineConfig:
    """Pipeline knobs of the render and the train step (reference
    arguments/__init__.py:69-74, and the port's own two).

    convert_SHs_python: evaluate the SH colours outside the rasterizer
      (`ops/sh.py::eval_sh`) and hand them in as `colors_precomp`.
    compute_cov3D_python: build the 3D covariances outside the rasterizer
      (`ops/covariance.py::build_covariance_3d`) and hand them in as
      `cov3d_precomp`.
    debug: `training` stops at a non-finite loss after writing the state
      to `snapshot_fw_<iteration>.npz` (set from `--debug_from` on).
    tile_size: square pixel tile of the blend (16 or 32).
    binning: instance-stream builder; "dense" (the exact ellipse-culled
      duplicated-key sort of `ops/binning_dense.py`) is the only one ported.
    data_parallel: camera-batch groups over the mesh's 'data' axis.
    render_parallel: Gaussian / tile-row shards over its 'prim' axis (the
      mesh has data_parallel * render_parallel ranks; `train/loop.py`).
    """

    convert_SHs_python: bool = False
    compute_cov3D_python: bool = False
    debug: bool = False
    tile_size: int = 32
    binning: str = "dense"
    data_parallel: int = 1
    render_parallel: int = 1

    @classmethod
    def add_to_parser(cls, parser):
        _add_group(parser, cls(), "Pipeline Parameters")

    @classmethod
    def extract(cls, args):
        return _extract(cls, args)


@dataclass
class OptimizationConfig:
    """reference arguments/__init__.py:76-110 (OptimizationParams), with
    the JAX package's defaults.

    `screen_size_prune`: "reference" reproduces the reference's literal
    behaviour (densification zeroes max_radii2D before the prune reads it,
    so the screen-size test never fires); "effective" prunes on the radii
    from before the densification."""

    iterations: int = 600_000
    position_lr_init: float = 0.005
    position_lr_final: float = 0.00005
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 600_000
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.017
    rotation_lr: float = 0.001
    densification_interval: int = 2_000
    opacity_reset_interval: int = 60_000
    densify_from_iter: int = 10_000
    densify_until_iter: int = 600_000
    densify_grad_threshold: float = 0.0002
    screen_size_prune: str = "reference"

    flame_expr_lr: float = 1e-3
    flame_trans_lr: float = 1e-6
    flame_pose_lr: float = 1e-5
    percent_dense: float = 0.01
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

    @classmethod
    def add_to_parser(cls, parser):
        _add_group(parser, cls(), "Optimization Parameters")

    @classmethod
    def extract(cls, args):
        return _extract(cls, args)


def save_config(model_path: str, model_cfg: ModelConfig):
    """Write `cfg.json` (read back by `load_config`) and the repr-style
    `cfg_args` of the reference tools (reference train.py:227-228)."""
    os.makedirs(model_path, exist_ok=True)
    with open(os.path.join(model_path, "cfg.json"), "w") as f:
        json.dump(dataclasses.asdict(model_cfg), f, indent=2)
    ns = Namespace(**dataclasses.asdict(model_cfg))
    with open(os.path.join(model_path, "cfg_args"), "w") as f:
        f.write(str(ns))


def load_config(model_path: str) -> ModelConfig:
    with open(os.path.join(model_path, "cfg.json")) as f:
        data = json.load(f)
    known = {f.name for f in dataclasses.fields(ModelConfig)}
    return ModelConfig(**{k: v for k, v in data.items() if k in known})


def get_combined_config(parser: ArgumentParser, argv=None) -> Namespace:
    """Command-line arguments merged over the run's saved `cfg.json`
    (reference arguments/__init__.py:112-132, JSON instead of eval)."""
    args_cmdline = parser.parse_args(argv)
    merged = {}
    model_path = getattr(args_cmdline, "model_path", None)
    if model_path:
        cfg_json = os.path.join(model_path, "cfg.json")
        if os.path.exists(cfg_json):
            with open(cfg_json) as f:
                merged.update(json.load(f))
    for k, v in vars(args_cmdline).items():
        if v is not None:
            merged[k] = v
    return Namespace(**merged)
