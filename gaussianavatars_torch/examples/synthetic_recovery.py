"""The unbound scene-recovery protocol (port of the JAX package's
`examples/synthetic_recovery.py`).

A known cloud of 20,000 SH-3 Gaussians (`make_gt_scene`) is rendered by
the port's `rasterize` into a Blender dataset (28 training and 4 test
views at distance 4, white background); a fresh unbound model then trains
from a noisy point cloud in `points3d.ply` (every 4th true centre plus
noise, random colours: the analogue of COLMAP points) and is scored on the
test views. For one seed the dataset is the JAX example's, its images
within one level.

    python -m gaussianavatars_torch.examples.synthetic_recovery \\
        [--iterations 2000] [--width 400] [--height 400] [--out DIR] \\
        [--device cuda]

prints one JSON line (wall seconds, steps/s overall and over the second
half, the final EMA loss, the number of Gaussians and the test split's L1,
PSNR and SSIM) and the card's `nvidia-smi` name and power limit.
`write_colmap_scene` writes the same views again as a COLMAP scene.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import tempfile
import time
from argparse import ArgumentParser

import numpy as np
import torch

FOVX = 0.8


def make_gt_scene(n=20_000, seed=0, device="cuda") -> dict:
    """The ground-truth cloud: means, linear scales, unit quaternions,
    opacities and [N, 16, 3] SH coefficients (a smooth colour field)."""
    rng = np.random.default_rng(seed)
    k = 16                                   # SH degree 3
    pts = rng.normal(0.0, 0.35, (n, 3)).astype(np.float32)
    scales = np.exp(rng.normal(-4.6, 0.4, (n, 3))).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    sh = np.zeros((n, k, 3), np.float32)
    sh[:, 0] = 0.5 + 0.9 * np.sin(pts * np.array([3.0, 5.0, 7.0]))
    sh[:, 1:] = rng.normal(0, 0.02, (n, k - 1, 3))
    opac = rng.uniform(0.5, 0.95, n).astype(np.float32)
    arrays = dict(means3d=pts, scales=scales, quats=quats, opacities=opac,
                  shs=sh)
    return {k: torch.as_tensor(v, device=device) for k, v in arrays.items()}


def camera_pose(angle, elev, dist=4.0):
    """(c2w in COLMAP axes, c2w in OpenGL axes) of a camera on the sphere
    of radius `dist` looking at the origin."""
    pos = np.array([
        dist * math.cos(elev) * math.sin(angle),
        dist * math.sin(elev),
        -dist * math.cos(elev) * math.cos(angle),
    ])
    fwd = -pos / np.linalg.norm(pos)
    up = np.array([0.0, -1.0, 0.0])
    right = np.cross(up, fwd)
    right /= np.linalg.norm(right)
    up2 = np.cross(fwd, right)
    c2w = np.eye(4)
    c2w[:3, :3] = np.stack([right, up2, fwd], axis=1)
    c2w[:3, 3] = pos
    c2w_gl = c2w.copy()
    c2w_gl[:3, 1:3] *= -1
    return c2w, c2w_gl


def views(n_train=28, n_test=4) -> list:
    """(split, index, yaw, elevation) of every view."""
    out = [("train", i, 2 * math.pi * i / n_train,
            0.5 * math.sin(2 * math.pi * i / 7)) for i in range(n_train)]
    out += [("test", i, 2 * math.pi * (i + 0.37) / n_test, 0.21 + 0.1 * i)
            for i in range(n_test)]
    return out


def render_dataset(root, gt, width, height, fovx=FOVX, n_train=28,
                   n_test=4, tile_size=32) -> int:
    """Render `gt` from every view through `rasterize` on a white
    background into a Blender dataset at `root` (RGBA PNGs, alpha 255, the
    colour truncated to uint8 as the JAX example writes it); returns the
    number of instances of the last view."""
    from gaussianavatars_torch.ops.projection import CameraParams
    from gaussianavatars_torch.ops.rasterize_tiles import rasterize
    from gaussianavatars_torch.ops.transforms import (
        camera_center_from_world_view,
        full_projection,
        perspective_projection,
        world_to_view,
    )
    from gaussianavatars_torch.utils.png import write_png

    dev = gt["means3d"].device
    fovy = 2 * math.atan(math.tan(fovx / 2) * height / width)
    bg = torch.ones(3, device=dev)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    splits = {"train": [], "test": []}
    os.makedirs(os.path.join(root, "train"), exist_ok=True)
    os.makedirs(os.path.join(root, "test"), exist_ok=True)
    proj = perspective_projection(0.01, 100.0, fovx, fovy)
    total = 0
    for split, i, angle, elev in views(n_train, n_test):
        c2w, c2w_gl = camera_pose(angle, elev)
        R = c2w[:3, :3]                      # cam-to-world rotation
        T = -R.T @ c2w[:3, 3]                # world-to-cam translation
        wv = world_to_view(R, T)
        cam = CameraParams(
            viewmatrix=t(wv), projmatrix=t(full_projection(wv, proj)),
            campos=t(camera_center_from_world_view(wv)),
            tan_fovx=math.tan(fovx / 2), tan_fovy=math.tan(fovy / 2),
            width=width, height=height)
        with torch.no_grad():
            out = rasterize(gt["means3d"], gt["scales"], gt["quats"],
                            gt["opacities"], gt["shs"], 3, cam, bg,
                            tile_size=tile_size)
        total = out.instance_total
        arr = out.image.clamp(0, 1).permute(1, 2, 0).cpu().numpy()
        rgba = np.concatenate([arr, np.ones_like(arr[..., :1])], -1)
        name = f"{split}/r_{i}"
        write_png(os.path.join(root, name + ".png"),
                  (rgba * 255).astype(np.uint8))
        splits[split].append({"file_path": f"./{name}",
                              "transform_matrix": c2w_gl.tolist()})
    for split, frames in splits.items():
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": fovx, "frames": frames}, f)
    return total


def write_noisy_init(root, gt, seed=1):
    """`points3d.ply`: every 4th true centre plus N(0, 0.02) noise, with
    random colours (the JAX example's init, draw for draw)."""
    from gaussianavatars_torch.utils.ply import store_point_cloud

    rng = np.random.default_rng(seed)
    means = gt["means3d"].cpu().numpy()
    xyz = means[::4] + rng.normal(0, 0.02, (len(means[::4]), 3))
    rgb = rng.random((len(xyz), 3)) * 255
    store_point_cloud(os.path.join(root, "points3d.ply"), xyz, rgb)
    return xyz, rgb


def write_colmap_scene(blender_root, colmap_root, width, height,
                       xyz, rgb, fovx=FOVX, n_train=28, n_test=4):
    """The Blender dataset at `blender_root` again as a COLMAP binary scene
    at `colmap_root`: one PINHOLE camera, one image per view
    (`<split>_r_<i>.png`, copied), and the points `xyz` with colours
    `rgb` in `sparse/0/points3D.bin`."""
    from gaussianavatars_torch.data.colmap import (
        ColmapCamera, ColmapImage, rotmat2qvec, write_cameras_binary,
        write_images_binary, write_points3d_binary,
    )
    from gaussianavatars_torch.ops.transforms import fov2focal

    sparse = os.path.join(colmap_root, "sparse", "0")
    images_dir = os.path.join(colmap_root, "images")
    os.makedirs(sparse, exist_ok=True)
    os.makedirs(images_dir, exist_ok=True)
    fovy = 2 * math.atan(math.tan(fovx / 2) * height / width)
    write_cameras_binary(os.path.join(sparse, "cameras.bin"), [ColmapCamera(
        1, "PINHOLE", width, height,
        np.array([fov2focal(fovx, width), fov2focal(fovy, height),
                  width / 2, height / 2]))])
    images = []
    for idx, (split, i, angle, elev) in enumerate(views(n_train, n_test)):
        c2w, _ = camera_pose(angle, elev)
        R = c2w[:3, :3]
        name = f"{split}_r_{i}.png"
        shutil.copyfile(os.path.join(blender_root, split, f"r_{i}.png"),
                        os.path.join(images_dir, name))
        images.append(ColmapImage(idx + 1, rotmat2qvec(R.T),
                                  -R.T @ c2w[:3, 3], 1, name))
    write_images_binary(os.path.join(sparse, "images.bin"), images)
    write_points3d_binary(os.path.join(sparse, "points3D.bin"),
                          np.asarray(xyz, np.float64),
                          np.asarray(rgb).astype(np.uint8))
    return colmap_root


def main(argv=None) -> dict:
    ap = ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iterations", type=int, default=2000)
    ap.add_argument("--width", type=int, default=400)
    ap.add_argument("--height", type=int, default=400)
    ap.add_argument("--out", type=str, default=None,
                    help="work directory (default: a new temporary one)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from gaussianavatars_torch.config import (
        ModelConfig, OptimizationConfig, PipelineConfig,
    )
    from gaussianavatars_torch.device import resolve_device
    from gaussianavatars_torch.examples import nvidia_smi_line, steady_rate
    from gaussianavatars_torch.train.loop import training

    dev = resolve_device(args.device)
    out = args.out or tempfile.mkdtemp(prefix="synthetic_recovery_")
    root = os.path.join(out, "data")
    gt = make_gt_scene(device=dev)
    print("[demo] rendering the ground-truth dataset ...", flush=True)
    render_dataset(root, gt, args.width, args.height)
    write_noisy_init(root, gt)

    model_cfg = ModelConfig(
        source_path=root, model_path=os.path.join(out, "out"),
        bind_to_mesh=False, eval=True, sh_degree=3, white_background=True)
    it = args.iterations
    opt_cfg = OptimizationConfig(
        iterations=it, densify_from_iter=500,
        densify_until_iter=int(0.75 * it), densification_interval=300,
        opacity_reset_interval=10 * it, position_lr_max_steps=it)
    print(f"[demo] training {it} iterations on {dev} ...", flush=True)
    t0 = time.time()
    model, state, info = training(model_cfg, opt_cfg, PipelineConfig(),
                                  testing_iterations={it},
                                  saving_iterations={it}, device=dev)
    dt = time.time() - t0
    result = {
        "iterations": it,
        "wall_s": round(dt, 1),
        "steps_per_s": round(it / dt, 2),
        "steady_steps_per_s": steady_rate(info["timeline"]),
        "final_ema_loss": round(float(info["ema_loss"]), 5),
        "n_gaussians": int(model.num_gaussians),
        "test": {k: round(float(v), 4)
                 for k, v in info["metrics"][it].get("test", {}).items()},
    }
    print(json.dumps(result))
    print(nvidia_smi_line() or "nvidia-smi: not available")
    return result


if __name__ == "__main__":
    main()
