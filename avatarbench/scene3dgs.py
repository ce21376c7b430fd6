"""A 3DGS scene of a captured 360-degree capture, made from the seed: the
Gaussians of the configuration `3dgs-mip360-3m` (its `scene` group).

The mixture stands for a trained Mip-NeRF 360 scene seen from a ring of
cameras around it: a share of "object" Gaussians uniform in a ball at the
centre, the rest a background whose distances from the centre are
log-uniform between two radii, in directions uniform on the sphere, so
that about a fifth of it (9% of the scene) lies behind any ring camera
and some of it next to one. Scales are log-normal around `object_scale`, one axis flattened by
`flatten` (trained splats are flat); a background Gaussian's scales grow
with its distance from the centre, `object_scale` at `scale_distance`, so
that Gaussians far and near look alike in size on screen. Rotations are
random; colours and opacities are those of `scene.cloud_params`. One
`torch.Generator` on the device makes everything in a few large calls.
"""

from __future__ import annotations

import math

import torch

from avatarbench import scene


def _directions(g, n, device):
    d = torch.randn(n, 3, generator=g, device=device)
    return d / d.norm(dim=1, keepdim=True).clamp(min=1e-12)


def scene_params(seed: int, n: int, spec: dict, sh_coeffs: int,
                 device) -> dict:
    """The raw parameters of `n` Gaussians (see the module's docstring)."""
    g = scene._generator(seed, 6, device)
    n_obj = round(spec["object_share"] * n)
    n_bg = n - n_obj
    r_obj = spec["object_radius"] * torch.rand(
        n_obj, generator=g, device=device) ** (1.0 / 3.0)
    lo, hi = spec["background_radius"]
    r_bg = lo * (hi / lo) ** torch.rand(n_bg, generator=g, device=device)
    xyz = torch.cat([_directions(g, n_obj, device) * r_obj[:, None],
                     _directions(g, n_bg, device) * r_bg[:, None]])
    grow = torch.cat([torch.ones(n_obj, device=device),
                      r_bg / spec["scale_distance"]])
    scaling = (torch.randn(n, 3, generator=g, device=device)
               * spec["scale_sigma"] + math.log(spec["object_scale"])
               + torch.log(grow)[:, None])
    scaling[:, 2] += math.log(spec["flatten"])
    quat = torch.randn(n, 4, generator=g, device=device)
    dc, rest = scene._sh(g, n, sh_coeffs, device)
    opac = 0.2 + 0.78 * torch.rand(n, generator=g, device=device)
    return dict(xyz=xyz, features_dc=dc, features_rest=rest, scaling=scaling,
                rotation=quat / quat.norm(dim=1, keepdim=True),
                opacity=torch.log(opac / (1 - opac))[:, None])
