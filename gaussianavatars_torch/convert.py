"""Carry a model's state across from the JAX package.

`from_jax_arrays` takes the JAX model's state as plain numpy arrays (read
with `np.asarray` on the JAX side; nothing of JAX is imported here) and
builds the port's model, so that both packages render the same avatar and,
with the Adam state and the densification statistics carried too, compute
the same train step.

`from_jax_multisubject` builds one port model per subject from the JAX
multi-subject trainer's stacked state, and `shard_from_jax` cuts a JAX
state laid out over a ('data', 'prim') mesh into this rank's shard.

`load_checkpoint` reads a training checkpoint (`chkpnt<N>.npz`) into the
port's model. Both packages write checkpoints under the same keys, so it
reads the JAX package's as well as the port's, and the JAX package's
`restore` reads the port's.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from gaussianavatars_torch.device import resolve_device
from gaussianavatars_torch.models.flame import FlameHead
from gaussianavatars_torch.models.flame_gaussians import FlameGaussianModel
from gaussianavatars_torch.models.gaussians import AdamState, GaussianParams

STATS = ("max_radii2d", "xyz_gradient_accum", "denom")


def from_jax_arrays(
    params: dict,
    binding: np.ndarray,
    flame_param: dict,
    *,
    sh_degree: int,
    n_alive: Optional[int] = None,
    flame_model_path: Optional[str] = None,
    flame_template_mesh_path: Optional[str] = None,
    opt_state: Optional[tuple] = None,
    stats: Optional[dict] = None,
    spatial_lr_scale: float = 0.0,
    not_finetune_flame_params: bool = False,
    device: str | torch.device = "cuda",
) -> FlameGaussianModel:
    """Build the port's model from the JAX model's arrays.

    Args:
      params: the `GaussianParams` fields xyz, features_dc, features_rest
        (flat channel-major), scaling, rotation, opacity as numpy arrays.
      binding: [N] face index per Gaussian.
      flame_param: the per-timestep FLAME dict; its `shape` and `expr`
        widths set the head's shape and expression dims.
      sh_degree: the model's SH degree.
      n_alive: live Gaussians; the JAX model pads its arrays to a capacity
        bucket, and the port keeps only the first `n_alive` rows.
      flame_model_path / flame_template_mesh_path: the FLAME pickle and
        template OBJ the JAX head was built from.
      opt_state: the JAX Adam state as (mu, nu, count), mu and nu each
        {"gauss": {field: array}, "flame": {key: array}}; it becomes
        `model.opt_state`, which `train.loop.initial_state` reads.
      stats: the densification statistics {max_radii2d,
        xyz_gradient_accum, denom}; zeros when not given.
      spatial_lr_scale / not_finetune_flame_params: the JAX model's.
      device: where the port's model lives.

    Every per-Gaussian array keeps its first `n_alive` rows.
    """
    dev = resolve_device(device)
    n = len(params["xyz"]) if n_alive is None else n_alive

    def rows(a):
        return torch.as_tensor(np.array(a[:n], np.float32), device=dev)

    def flame(d):
        return {k: torch.as_tensor(np.array(v, np.float32), device=dev)
                for k, v in d.items()}

    p = GaussianParams(**{k: rows(params[k]) for k in GaussianParams._fields})
    head = FlameHead(np.shape(flame_param["shape"])[-1],
                     np.shape(flame_param["expr"])[-1],
                     flame_model_path=flame_model_path,
                     flame_template_mesh_path=flame_template_mesh_path,
                     device=dev)
    model = FlameGaussianModel(
        sh_degree, head, p,
        torch.as_tensor(np.array(binding[:n], np.int64), device=dev),
        not_finetune_flame_params=not_finetune_flame_params)
    model.flame_param = flame(flame_param)
    model.num_timesteps = int(model.flame_param["expr"].shape[0])
    model.spatial_lr_scale = spatial_lr_scale
    model.reset_stats()
    if stats is not None:
        model.max_radii2d, model.xyz_gradient_accum, model.denom = (
            rows(stats[k]) for k in STATS)
    if opt_state is not None:
        mu, nu, count = opt_state
        model.opt_state = tuple(
            {"gauss": GaussianParams(**{k: rows(m["gauss"][k])
                                        for k in GaussianParams._fields}),
             "flame": flame(m["flame"])}
            for m in (mu, nu)) + (int(count),)
    return model


def from_jax_multisubject(params_s: dict, binding_s, active_s,
                          flame_param_s: dict, **kwargs
                          ) -> list[FlameGaussianModel]:
    """The S port models of a JAX multi-subject state.

    The JAX trainer stacks its subjects on a leading axis over a common
    capacity: `params_s` {field: [S, capacity, ...]}, `binding_s` and
    `active_s` [S, capacity], `flame_param_s` {key: [S, ...]}. Subject s
    keeps its active rows, in order. `kwargs` go to `from_jax_arrays`
    (sh_degree, the FLAME paths, device, ...).
    """
    models = []
    for s, active in enumerate(np.asarray(active_s, bool)):
        models.append(from_jax_arrays(
            {k: np.asarray(v[s])[active] for k, v in params_s.items()},
            np.asarray(binding_s[s])[active],
            {k: np.asarray(v[s]) for k, v in flame_param_s.items()},
            **kwargs))
    return models


def shard_from_jax(tree, n_alive: int, mesh,
                   device: str | torch.device = "cuda"):
    """This rank's prim shard of a JAX state's per-Gaussian arrays.

    The JAX package shards the capacity axis of arrays whose first
    `n_alive` rows are the live Gaussians; the port shards the live rows
    (`parallel/mesh.py::Mesh.shard`). `tree` is a dict or NamedTuple of
    numpy arrays [capacity, ...] (nested dicts too); the result has the
    same structure, as float32 tensors on `device`.
    """
    dev = resolve_device(device)
    rows = mesh.shard(n_alive)

    def cut(tree):
        if isinstance(tree, dict):
            return {k: cut(v) for k, v in tree.items()}
        if hasattr(tree, "_fields"):
            return type(tree)(*[cut(v) for v in tree])
        return torch.as_tensor(
            np.array(np.asarray(tree)[:n_alive][rows], np.float32),
            device=dev)

    return cut(tree)


def load_checkpoint(path: str, model) -> tuple[int, AdamState, dict]:
    """Restore `model` (a `GaussianModel` or `FlameGaussianModel` on its
    device) from the checkpoint file `path` of either package: the `g_*`
    keys through `model.restore` (which raises unless the checkpoint is
    labelled `features_rest_layout: cmajor`), the `f_*` FLAME trainables
    into `model.flame_param`. Returns (iteration, the Gaussians' Adam
    state, the FLAME trainables as tensors)."""
    with np.load(path) as f:
        data = dict(f)
    adam_g = model.restore({k[2:]: v for k, v in data.items()
                            if k.startswith("g_")}, source=path)
    flame_tr = {k[2:]: torch.as_tensor(np.asarray(v, np.float32),
                                       device=model.device)
                for k, v in data.items() if k.startswith("f_")}
    if flame_tr:
        model.merge_flame_trainable(flame_tr)
    return int(data["iteration"]), adam_g, flame_tr
