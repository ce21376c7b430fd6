"""The bound-avatar quality protocol (port of the JAX package's
`examples/bound_avatar_recovery.py`): the reference's core use case, an
animatable FLAME-bound avatar trained from multi-view, multi-timestep
images, scored on held-out views.

A synthetic FLAME head (`benchmark.py::make_flame_assets`, the real
topology's dimensions) is driven through T timesteps of expression, jaw and
head motion and carries a known bound Gaussian cloud (`paint_gt_model`),
rendered by the port into a DynamicNerf dataset: two elevation rings of
16 cameras each, the middle camera of each ring held out. A fresh model
then trains from the standard bound init (one Gaussian per face, white
background, SH degree 2, densification every `--densify_every` iterations
from 400 to 70% of the run) and is scored on

  val  = novel-view synthesis (the held-out camera, seen timesteps)
  test = self-reenactment (held-out camera and timestep combinations).

For one seed the dataset is the JAX example's: the same FLAME parameters,
cameras and painted appearance, the images within one level.

    python -m gaussianavatars_torch.examples.bound_avatar_recovery \\
        --iterations 10000 --width 448 --height 400 --test_every 2000 \\
        --no_finetune_flame [--out DIR] [--device cuda]

prints the evaluations as it goes, then one JSON line (wall seconds,
steps/s overall and over the second half, the number of Gaussians, val and
test L1 / PSNR / SSIM, and LPIPS where its weights exist, and the
trajectory of every evaluation) and the card's `nvidia-smi` name and power
limit.
"""

from __future__ import annotations

import json
import math
import os
import tempfile
import time
from argparse import ArgumentParser

import numpy as np
import torch

T_STEPS = 8
N_CAMS = 16         # cameras per ring; the middle one is held out, so the
                    # eval view interpolates the training arc
N_RINGS = 2         # two elevation rings: a 2D view cone constrains the
                    # view-dependent SH far better than one yaw arc
ELEVS = (-0.18, 0.18)
DIST = 1.1          # the head fills most of the frame at FOVX from here
FOVX = 0.5


def camera_frame(angle, width, height, fovx, timestep, cam_idx, file_path,
                 flame_path, elev=0.0) -> dict:
    """A transforms.json frame for a camera at distance 4 on the ring of
    `angle` and `elev` (radians), looking at the origin (the JAX tests'
    dataset fixture's frame)."""
    dist = 4.0
    ce = math.cos(elev)
    pos = np.array([dist * ce * math.sin(angle), dist * math.sin(elev),
                    -dist * ce * math.cos(angle)])
    fwd = -pos / np.linalg.norm(pos)
    up = np.array([0.0, -1.0, 0.0])
    right = np.cross(up, fwd)
    right /= np.linalg.norm(right)
    up2 = np.cross(fwd, right)
    c2w = np.eye(4)
    c2w[:3, :3] = np.stack([right, up2, fwd], axis=1)   # COLMAP axes
    c2w[:3, 3] = pos
    c2w_gl = c2w.copy()                                  # OpenGL axes
    c2w_gl[:3, 1:3] *= -1
    return {
        "file_path": file_path,
        "transform_matrix": c2w_gl.tolist(),
        "camera_angle_x": fovx,
        "w": width,
        "h": height,
        "timestep_index": timestep,
        "camera_index": cam_idx,
        "flame_param_path": flame_path,
    }


def write_dataset(data_dir, asset_dir, width, height, seed=0,
                  t_steps=T_STEPS, n_cams=N_CAMS):
    """FLAME assets, transforms_{train,val,test}.json and smooth per-timestep
    FLAME parameters. The images are black placeholders until
    `render_gt_images` overwrites them."""
    from gaussianavatars_torch.benchmark import make_flame_assets
    from gaussianavatars_torch.utils.png import write_png

    hold_out = n_cams // 2
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(data_dir, "images"), exist_ok=True)
    os.makedirs(os.path.join(data_dir, "flame_param"), exist_ok=True)
    make_flame_assets(asset_dir, seed=seed)

    shape = rng.normal(0, 0.3, 300).astype(np.float32)
    # smooth expression and jaw trajectories (the self-reenactment signal)
    base_e = rng.normal(0, 0.25, 100).astype(np.float32)
    dir_e = rng.normal(0, 0.25, 100).astype(np.float32)
    for t in range(t_steps):
        ph = 2 * math.pi * t / t_steps
        np.savez(
            os.path.join(data_dir, "flame_param", f"{t:05d}.npz"),
            shape=shape,
            expr=(base_e * math.cos(ph) + dir_e * math.sin(ph))[None],
            # a head yaw sweep over the timesteps varies each Gaussian's
            # view directions, as turning heads in captured data do
            rotation=np.float32([[0.05 * math.sin(ph),
                                  0.35 * math.sin(ph + 0.7), 0]]),
            neck_pose=np.zeros((1, 3), np.float32),
            jaw_pose=np.float32([[0.08 + 0.05 * math.sin(ph), 0, 0]]),
            eyes_pose=np.zeros((1, 6), np.float32),
            translation=np.zeros((1, 3), np.float32),
            static_offset=np.zeros((1, 5023, 3), np.float32),
        )
    np.savez(os.path.join(data_dir, "canonical_flame_param.npz"),
             shape=shape)

    splits = {"train": [], "val": [], "test": []}
    img_id = 0
    placeholder = np.zeros((height, width, 3), np.uint8)
    for t in range(t_steps):
        for ring in range(N_RINGS):
            for c in range(n_cams):
                if c != hold_out:
                    split = "train"
                else:
                    # alternate the held-out views over rings and timesteps
                    # so that val and test each cover both elevations
                    split = "val" if (t + ring) % 2 == 0 else "test"
                name = f"images/{img_id:05d}.png"
                write_png(os.path.join(data_dir, name), placeholder)
                angle = 2.0 * math.pi * (c / n_cams - 0.5) * 0.35
                # stagger the rings' yaws so view directions tile the cone
                angle += (ring - (N_RINGS - 1) / 2) * math.pi * 0.35 / n_cams
                frame = camera_frame(angle, width, height, FOVX, t,
                                     ring * n_cams + c, name,
                                     f"flame_param/{t:05d}.npz",
                                     elev=ELEVS[ring])
                # pull the camera in close enough to fill the frame
                m = np.asarray(frame["transform_matrix"])
                m[:3, 3] *= DIST / 4.0
                frame["transform_matrix"] = m.tolist()
                splits[split].append(frame)
                img_id += 1
    for split, frames in splits.items():
        with open(os.path.join(data_dir, f"transforms_{split}.json"),
                  "w") as f:
            json.dump({"camera_angle_x": FOVX, "frames": frames}, f)


def paint_gt_model(model, seed=0):
    """Give the standard bound init (one Gaussian per face) a known
    appearance to recover: a smooth colour field over the face centres and
    near-opaque Gaussians (sigmoid(4) ~ 0.98), as real heads are opaque
    surfaces.

    The synthetic head has a tail of degenerate faces whose frame scale is
    up to ~25x the median; each face's world splat scale is capped at 3x
    the median through its local scaling (and its local offset shrunk
    alike), so the ground truth is a head-shaped surface."""
    rng = np.random.default_rng(seed + 7)
    with torch.no_grad():
        frames = model.face_frames_at(model.flame_param, 0)
    centers = frames.center.cpu().numpy()                # [F, 3]
    n = model.num_gaussians
    dc = 0.4 + 0.35 * np.sin(centers[:n] * np.float32([9.0, 14.0, 23.0]))
    fs = frames.scaling.cpu().numpy()[
        model.binding.cpu().numpy()[:n]].reshape(n, 1)    # [n, 1]
    cap = 3.0 * float(np.median(fs))

    def put(a):
        return torch.as_tensor(np.asarray(a, np.float32),
                               device=model.device)

    op = np.full((n, 1), 4.0, np.float32)
    local_scale = rng.uniform(0.7, 1.4, (n, 3)).astype(np.float32)
    local_scale = np.minimum(local_scale, cap / np.maximum(fs, 1e-9))
    xyz = rng.normal(0, 0.15, (n, 3)).astype(np.float32)
    xyz = np.clip(xyz, -1.0, 1.0) * np.minimum(1.0,
                                               cap / np.maximum(fs, 1e-9))
    model.params = model.params._replace(
        xyz=put(xyz),
        features_dc=put((dc - 0.5) / 0.28209479),
        opacity=put(op),
        scaling=put(np.log(local_scale)),
    )


def render_gt_images(model, scene, model_cfg, pipe_cfg, device) -> int:
    """Render every camera of `scene` with `model` on a white background
    and write the PNGs over the dataset's images; returns their number."""
    from gaussianavatars_torch.train.loop import camera_arrays, make_render_fn
    from gaussianavatars_torch.utils.png import write_png

    bg = torch.ones(3, device=device)
    render_fns = {}
    n_written = 0
    for cams in (scene.get_train_cameras(), scene.get_val_cameras(),
                 scene.get_test_cameras()):
        for cam in cams:           # the cameras only: never the placeholders
            w, h = cam.resolution(model_cfg.resolution)
            if (w, h) not in render_fns:
                render_fns[w, h] = make_render_fn(model, pipe_cfg, w, h,
                                                  model.active_sh_degree)
            img = render_fns[w, h](
                model.params, model.flame_param, model.binding,
                camera_arrays(cam.to_params(w, h, device=device)), bg,
                cam.timestep or 0).image
            arr = img.clamp(0, 1).permute(1, 2, 0).cpu().numpy()
            write_png(cam.image_path, (arr * 255 + 0.5).astype(np.uint8))
            n_written += 1
    return n_written


def _rounded(metrics: dict) -> dict:
    return {k: round(float(v), 4) for k, v in metrics.items()}


def main(argv=None) -> dict:
    ap = ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iterations", type=int, default=1500)
    ap.add_argument("--width", type=int, default=296)
    ap.add_argument("--height", type=int, default=240)
    ap.add_argument("--out", type=str, default=None,
                    help="work directory (default: a new temporary one)")
    ap.add_argument("--test_every", type=int, default=0,
                    help="also evaluate val and test every N iterations "
                         "(the PSNR/SSIM trajectory; 0: at the end only)")
    ap.add_argument("--densify_every", type=int, default=300)
    ap.add_argument("--no_finetune_flame", action="store_true",
                    help="freeze the FLAME parameters at the dataset's "
                         "values (this protocol's are the exact ground "
                         "truth)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from gaussianavatars_torch.config import (
        ModelConfig, OptimizationConfig, PipelineConfig,
    )
    from gaussianavatars_torch.data.scene import Scene
    from gaussianavatars_torch.device import resolve_device
    from gaussianavatars_torch.examples import nvidia_smi_line, steady_rate
    from gaussianavatars_torch.models.flame_gaussians import (
        FlameGaussianModel,
    )
    from gaussianavatars_torch.train.loop import evaluate_splits, training

    dev = resolve_device(args.device)
    out = args.out or tempfile.mkdtemp(prefix="bound_recovery_")
    data_dir = os.path.join(out, "data")
    asset_dir = os.path.join(out, "assets")
    write_dataset(data_dir, asset_dir, args.width, args.height)
    os.environ["FLAME_ASSET_DIR"] = asset_dir

    model_cfg = ModelConfig(
        source_path=data_dir, model_path=os.path.join(out, "out"),
        bind_to_mesh=True, eval=True, sh_degree=2, white_background=True,
        not_finetune_flame_params=args.no_finetune_flame)
    pipe_cfg = PipelineConfig()

    print("[demo] rendering the ground-truth avatar dataset ...", flush=True)
    os.makedirs(model_cfg.model_path, exist_ok=True)
    gt_model = FlameGaussianModel.from_assets(model_cfg.sh_degree,
                                              device=dev)
    scene = Scene(model_cfg, gt_model)
    paint_gt_model(gt_model)
    n = render_gt_images(gt_model, scene, model_cfg, pipe_cfg, dev)
    print(f"[demo] wrote {n} ground-truth renders", flush=True)

    it = args.iterations
    opt_cfg = OptimizationConfig(
        iterations=it, densify_from_iter=400,
        densify_until_iter=int(0.7 * it),
        densification_interval=args.densify_every,
        opacity_reset_interval=10 * it, position_lr_max_steps=it)
    tests = {it}
    if args.test_every:
        tests |= set(range(args.test_every, it + 1, args.test_every))
    print(f"[demo] training {it} iterations (bound) on {dev} ...", flush=True)
    t0 = time.time()
    model, state, info = training(model_cfg, opt_cfg, pipe_cfg,
                                  testing_iterations=tests,
                                  saving_iterations={it}, device=dev)
    dt = time.time() - t0

    # the final scores from a fresh camera pass
    scene2 = Scene(model_cfg, FlameGaussianModel.from_assets(
        model_cfg.sh_degree, device=dev))
    flame_fixed = {k: v for k, v in model.flame_param.items()
                   if k not in state.flame_tr}
    metrics = evaluate_splits(model, scene2, model_cfg, pipe_cfg, state,
                              flame_fixed)
    result = {
        "iterations": it,
        "wall_s": round(dt, 1),
        "steps_per_s": round(it / dt, 2),
        "steady_steps_per_s": steady_rate(info["timeline"]),
        "n_gaussians": int(model.num_gaussians),
        "val_novel_view": _rounded(metrics.get("val", {})),
        "test_self_reenactment": _rounded(metrics.get("test", {})),
        "trajectory": {i: {s: _rounded(m) for s, m in ms.items()}
                       for i, ms in sorted(info["metrics"].items())},
    }
    print(json.dumps(result))
    print(nvidia_smi_line() or "nvidia-smi: not available")
    return result


if __name__ == "__main__":
    main()
