"""The benchmark's inputs, made from the seed: the FLAME arrays and their
files, the FLAME parameters of every timestep, the Gaussians of each
configuration, the camera rig and the orbit, and the ground-truth images.

The generators are frozen copies of the measured program's scene builders
(its `benchmark.py`: the synthetic FLAME head with the real topology, the
bench avatar of 10 Gaussians a face, the 100k cloud, the look-at rig of its
avatar datasets). Host arrays are made with numpy where the program reads
them from files; the Gaussians and the images are made on the device by
one `torch.Generator` in a few large calls.
"""

from __future__ import annotations

import math
import os
import pickle

import numpy as np
import torch

FLAME_V, FLAME_F, FLAME_J = 5023, 9976, 5
FLAME_DIRS = 400            # 300 shape + 100 expression


def _generator(seed: int, stream: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream) % (1 << 63))
    return g


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (1 << 63), stream])


def flame_arrays(seed: int) -> dict:
    """A FLAME-like head with the real topology's sizes: vertices along a
    spiral on a 0.1-radius sphere, faces joining neighbours across turns
    (triangles of a few mm, as on a real head), random bases at the real
    bases' magnitudes, and a 70-point landmark embedding."""
    rng = _rng(seed, 1)
    v, f, w = FLAME_V, FLAME_F, 62
    t = (np.arange(v) + 0.5) / v
    z = 1.0 - 2.0 * t
    r_xy = np.sqrt(np.maximum(1.0 - z * z, 1e-6))
    phi = 2.0 * np.pi * w * t
    sphere = np.stack([r_xy * np.cos(phi), r_xy * np.sin(phi), z], axis=1)
    v_template = 0.1 * sphere + rng.normal(0, 0.002, (v, 3))
    k = v // w
    i = np.arange(v - k - 1)
    grid = np.concatenate([np.stack([i, i + 1, i + k], 1),
                           np.stack([i + 1, i + k + 1, i + k], 1)])
    j = np.arange(f - len(grid))
    faces = np.concatenate([grid, np.stack([j, j + 2, j + k + 1], 1)])[:f]
    kintree = np.zeros((2, FLAME_J), np.int64)
    kintree[0] = [-1, 0, 1, 1, 1]          # root -> neck -> jaw, eyes
    kintree[1] = np.arange(FLAME_J)
    weights = rng.random((v, FLAME_J))
    weights /= weights.sum(1, keepdims=True)
    return dict(
        v_template=v_template,
        shapedirs=rng.normal(0, 5e-4, (v, 3, FLAME_DIRS)),
        posedirs=rng.normal(0, 5e-5, (v, 3, (FLAME_J - 1) * 9)),
        J_regressor=np.abs(rng.normal(0, 1, (FLAME_J, v))) / v,
        kintree_table=kintree, weights=weights, f=faces,
        lmk_faces=rng.integers(0, f, (1, 70)),
        lmk_bary=rng.dirichlet(np.ones(3), (1, 70)))


def write_flame_files(arrays: dict, dirpath: str) -> dict:
    """The FLAME files a GaussianAvatars installation reads: the model
    pickle, the template OBJ (one UV per vertex) and the landmark
    embedding. Returns their paths."""
    os.makedirs(dirpath, exist_ok=True)
    keys = ("v_template", "shapedirs", "posedirs", "J_regressor",
            "kintree_table", "weights", "f")
    paths = dict(model=os.path.join(dirpath, "flame2023.pkl"),
                 obj=os.path.join(dirpath, "head_template_mesh.obj"),
                 lmk=os.path.join(dirpath, "landmark_embedding_with_eyes.npy"))
    with open(paths["model"], "wb") as fh:
        pickle.dump({k: arrays[k] for k in keys}, fh)
    v = arrays["v_template"]
    idx = np.arange(len(v))
    lines = [f"v {p[0]:.6f} {p[1]:.6f} {p[2]:.6f}" for p in v]
    lines += [f"vt {a:.6f} {b:.6f}" for a, b in zip((idx % 97) / 97,
                                                     (idx % 89) / 89)]
    lines += [f"f {a + 1}/{a + 1} {b + 1}/{b + 1} {c + 1}/{c + 1}"
              for a, b, c in arrays["f"]]
    with open(paths["obj"], "w") as fh:
        fh.write("\n".join(lines) + "\n")
    np.save(paths["lmk"], np.array(dict(
        full_lmk_faces_idx=arrays["lmk_faces"],
        full_lmk_bary_coords=arrays["lmk_bary"]), dtype=object),
        allow_pickle=True)
    return paths


def flame_motion(seed: int, timesteps: int, motion: str) -> dict:
    """FLAME parameters per timestep at the bench avatar's scales: one
    shape (sigma 0.05), expressions (sigma 0.1) and jaw poses (|N(0,
    0.05)|), the other poses zero. "random" draws each timestep alone;
    "walk" is a smooth sequence, an AR(1) walk of correlation 0.95 with
    the same stationary spread. Returns numpy arrays with a leading
    timestep axis (shape without)."""
    rng = _rng(seed, 2)
    shape = rng.normal(0, 0.05, 300).astype(np.float32)
    if motion == "random":
        expr = rng.normal(0, 0.1, (timesteps, 100))
        jaw = np.abs(rng.normal(0, 0.05, (timesteps, 3)))
    elif motion == "walk":
        rho = 0.95
        eps = rng.normal(0, 1, (timesteps, 103))
        x = np.empty_like(eps)
        x[0] = eps[0]
        for t in range(1, timesteps):
            x[t] = rho * x[t - 1] + math.sqrt(1 - rho * rho) * eps[t]
        expr, jaw = 0.1 * x[:, :100], np.abs(0.05 * x[:, 100:])
    else:
        raise ValueError(f"unknown motion {motion!r}")
    zeros = np.zeros((timesteps, 3), np.float32)
    return dict(shape=shape, expr=expr.astype(np.float32),
                jaw_pose=jaw.astype(np.float32), rotation=zeros,
                neck_pose=zeros.copy(), translation=zeros.copy(),
                eyes_pose=np.zeros((timesteps, 6), np.float32))


def flame_tensors(motion: dict, n_verts: int, device) -> dict:
    """The motion as the FLAME parameter dict of a bound avatar: every
    key as a tensor, with zero static and dynamic offsets over the
    `n_verts` vertices (teeth included)."""
    t = motion["expr"].shape[0]
    out = {k: torch.as_tensor(v, device=device) for k, v in motion.items()}
    out["static_offset"] = torch.zeros(n_verts, 3, device=device)
    out["dynamic_offset"] = torch.zeros(t, n_verts, 3, device=device)
    return out


def _sh(g, n, k, device):
    dc = torch.randn(n, 3, generator=g, device=device) * 0.5 + 0.3
    rest = torch.randn(n, 3 * (k - 1), generator=g, device=device) * 0.05
    return dc, rest


def avatar_params(seed: int, n_faces: int, face_scale, n_per_face: int,
                  sh_coeffs: int, device) -> tuple[dict, torch.Tensor]:
    """The bound avatar: `n_per_face` Gaussians on every face, binding
    sorted by face, local positions N(0, 0.5), world scales 0.814
    exp(N(-5.2, 0.4)) (the size the bench avatar's calibration gives)
    made local by the face scale at timestep 0 (`face_scale` [F, 1]),
    random rotations, SH DC N(0.3, 0.5) and rest N(0, 0.05), opacities
    U(0.2, 0.98). Returns (raw parameters, binding)."""
    g = _generator(seed, 3, device)
    n = n_faces * n_per_face
    binding = torch.arange(n_faces, device=device).repeat_interleave(
        n_per_face)
    xyz = torch.randn(n, 3, generator=g, device=device) * 0.5
    world = 0.814 * torch.exp(
        torch.randn(n, 3, generator=g, device=device) * 0.4 - 5.2)
    scaling = torch.log(torch.clamp(
        world / torch.clamp(face_scale[binding], min=1e-12), min=1e-12))
    quat = torch.randn(n, 4, generator=g, device=device)
    dc, rest = _sh(g, n, sh_coeffs, device)
    opac = 0.2 + 0.78 * torch.rand(n, generator=g, device=device)
    return dict(xyz=xyz, features_dc=dc, features_rest=rest,
                scaling=scaling,
                rotation=quat / quat.norm(dim=1, keepdim=True),
                opacity=torch.log(opac / (1 - opac))[:, None]), binding


def cloud_params(seed: int, n: int, sh_coeffs: int, device) -> dict:
    """The unbound cloud: positions N(0, 0.13) (a head-sized cluster),
    scales exp(N(-5.2, 0.4)), random rotations, the avatar's colours and
    opacities."""
    g = _generator(seed, 4, device)
    xyz = torch.randn(n, 3, generator=g, device=device) * 0.13
    scaling = torch.randn(n, 3, generator=g, device=device) * 0.4 - 5.2
    quat = torch.randn(n, 4, generator=g, device=device)
    dc, rest = _sh(g, n, sh_coeffs, device)
    opac = 0.2 + 0.78 * torch.rand(n, generator=g, device=device)
    return dict(xyz=xyz, features_dc=dc, features_rest=rest, scaling=scaling,
                rotation=quat / quat.norm(dim=1, keepdim=True),
                opacity=torch.log(opac / (1 - opac))[:, None])


def look_at(yaw: float, pitch: float, dist: float) -> np.ndarray:
    """Camera-to-world (y down, z forward) of a camera at yaw and pitch
    (radians) on a sphere of radius `dist`, looking at the origin."""
    pos = dist * np.array([math.cos(pitch) * math.sin(yaw), math.sin(pitch),
                           -math.cos(pitch) * math.cos(yaw)])
    fwd = -pos / np.linalg.norm(pos)
    right = np.cross(np.array([0.0, -1.0, 0.0]), fwd)
    right /= np.linalg.norm(right)
    c2w = np.eye(4)
    c2w[:3, :3] = np.stack([right, np.cross(fwd, right), fwd], axis=1)
    c2w[:3, 3] = pos
    return c2w


def rig(n_cams: int, yaw_deg: float, pitch: float, dist: float) -> list:
    """The training rig: `n_cams` cameras spread evenly over +-yaw_deg,
    pitches alternating -pitch / +pitch."""
    return [look_at(math.radians(-yaw_deg + 2 * yaw_deg * c
                                 / max(n_cams - 1, 1)),
                    pitch if c % 2 else -pitch, dist)
            for c in range(n_cams)]


def orbit(i: int, period: int, yaw_deg: float, dist: float) -> np.ndarray:
    """Frame i of an orbit that sweeps +-yaw_deg once every `period`
    frames."""
    phase = 2 * math.pi * (i % period) / period
    return look_at(math.radians(yaw_deg) * math.sin(phase), 0.0, dist)


def camera(c2w: np.ndarray, width: int, height: int, fovx: float,
           device, znear=0.01, zfar=100.0) -> dict:
    """The rasterizer's camera inputs: the transposed world->view and
    world->clip matrices, the centre and the half-angle tangents."""
    w2c = np.linalg.inv(c2w)
    view = w2c.T.astype(np.float32)
    tan_x = math.tan(fovx / 2)
    tan_y = tan_x * height / width
    proj = np.zeros((4, 4), np.float32)
    proj[0, 0], proj[1, 1] = 1 / tan_x, 1 / tan_y
    proj[2, 2] = zfar / (zfar - znear)
    proj[2, 3] = -(zfar * znear) / (zfar - znear)
    proj[3, 2] = 1.0
    full = (view @ proj.T).astype(np.float32)
    centre = np.linalg.inv(view)[3, :3].astype(np.float32)
    return dict(viewmatrix=torch.as_tensor(view, device=device),
                projmatrix=torch.as_tensor(full, device=device),
                campos=torch.as_tensor(centre, device=device),
                tan_fovx=tan_x, tan_fovy=tan_y, width=width, height=height)


def smooth_images(seed: int, n: int, height: int, width: int, device,
                  grid=(9, 13)) -> torch.Tensor:
    """n smooth images [n, 3, H, W] in [0, 1]: uniform noise on a coarse
    grid, bilinearly upsampled (one ground truth per training view)."""
    g = _generator(seed, 5, device)
    coarse = torch.rand(n, 3, *grid, generator=g, device=device)
    return torch.nn.functional.interpolate(
        coarse, size=(height, width), mode="bilinear", align_corners=True)
