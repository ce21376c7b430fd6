"""Carry a model's state across from the JAX package.

`from_jax_arrays` takes the JAX model's state as plain numpy arrays (read
with `np.asarray` on the JAX side; nothing of JAX is imported here) and
builds the port's model, so that both packages render the same avatar.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from gaussianavatars_torch.device import resolve_device
from gaussianavatars_torch.models.flame import FlameHead
from gaussianavatars_torch.models.flame_gaussians import FlameGaussianModel
from gaussianavatars_torch.models.gaussians import GaussianParams


def from_jax_arrays(
    params: dict,
    binding: np.ndarray,
    flame_param: dict,
    *,
    sh_degree: int,
    n_alive: Optional[int] = None,
    flame_model_path: Optional[str] = None,
    flame_template_mesh_path: Optional[str] = None,
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
      device: where the port's model lives.
    """
    dev = resolve_device(device)
    n = len(params["xyz"]) if n_alive is None else n_alive
    p = GaussianParams(**{
        k: torch.as_tensor(np.array(params[k][:n], np.float32), device=dev)
        for k in GaussianParams._fields})
    head = FlameHead(np.shape(flame_param["shape"])[-1],
                     np.shape(flame_param["expr"])[-1],
                     flame_model_path=flame_model_path,
                     flame_template_mesh_path=flame_template_mesh_path,
                     device=dev)
    model = FlameGaussianModel(
        sh_degree, head, p,
        torch.as_tensor(np.array(binding[:n], np.int64), device=dev))
    model.flame_param = {
        k: torch.as_tensor(np.array(v, np.float32), device=dev)
        for k, v in flame_param.items()}
    model.num_timesteps = int(model.flame_param["expr"].shape[0])
    return model
