"""FPS benchmark of the port's serving path (the port's counterpart of the
root `fps_benchmark_demo.py`; reference fps_benchmark_demo.py:35-81):

    python -m gaussianavatars_torch.fps_benchmark_demo [--point_path <ply>]
        [--width 802] [--height 550] [--n_iter 500] [--n_rounds 3]
        [--radius 1] [--fovy 20] [--timestep 0] [--vis] [--device cuda]

With --point_path it loads a trained `point_cloud.ply` (FLAME-bound when a
`flame_param.npz` lies beside it, the FLAME head from $FLAME_ASSET_DIR)
and renders it --n_iter times a round, from the orbit camera at --radius
and --fovy (OpenCV convention) at --timestep, as the root script does.
Without it, it renders the FLAME-bound bench avatar (101,440 Gaussians,
SH degree 3, white background) from the bench camera, cycling its
timesteps so every frame drives FLAME, the face frames and the binding
chain; `--unbound` renders the 100k-Gaussian cloud instead. Each round
ends with a device synchronisation, and its FPS is printed. --vis writes
the last frame to `fps_benchmark_demo.png` in the working directory.

The root script's --slab_tile_rows, a TPU device for its on-chip memory,
is not ported.
"""

from __future__ import annotations

import math
import time
from argparse import ArgumentParser
from pathlib import Path

import numpy as np
import torch

from gaussianavatars_torch.benchmark import (
    HEIGHT, N_ITERS, N_ROUNDS, SH_DEGREE, WIDTH, bench_camera,
    make_bench_scene, make_bound_bench_model, scene_to_model,
)
from gaussianavatars_torch.config import PipelineConfig
from gaussianavatars_torch.data.cameras import MiniCam
from gaussianavatars_torch.device import resolve_device
from gaussianavatars_torch.models.flame_gaussians import FlameGaussianModel
from gaussianavatars_torch.models.gaussians import GaussianModel
from gaussianavatars_torch.train.loop import camera_arrays, make_render_fn
from gaussianavatars_torch.utils.png import write_png
from gaussianavatars_torch.viewer.orbit_camera import OrbitCamera

VIS_PATH = "fps_benchmark_demo.png"


def load_avatar(point_path: str, sh_degree: int, device):
    """A trained avatar from its PLY (and `flame_param.npz`, if any)."""
    if (Path(point_path).parent / "flame_param.npz").exists():
        model = FlameGaussianModel.from_assets(sh_degree, device=device)
    else:
        model = GaussianModel(sh_degree, device=device)
    model.load_ply(point_path)
    return model


def orbit_params(width: int, height: int, radius: float, fovy: float,
                 timestep: int, device):
    """The root script's camera: an orbit camera (no camera.json) as a
    MiniCam's renderer parameters."""
    cam = OrbitCamera(width, height, r=radius, fovy=fovy,
                      convention="opencv", save_path="")
    return MiniCam(width=width, height=height,
                   fovx=math.radians(cam.fovx), fovy=math.radians(cam.fovy),
                   znear=cam.znear, zfar=cam.zfar,
                   world_view_transform=cam.world_view_transform.T,
                   full_proj_transform=cam.full_proj_transform.T,
                   timestep=timestep).to_params(device=device)


def save_vis(path: str, image: torch.Tensor):
    """A [3, H, W] frame as an 8-bit PNG, rounded as the root script does."""
    img = image.clamp(0.0, 1.0).cpu().numpy()
    write_png(path, np.clip(img * 255 + 0.5, 0, 255).astype(
        np.uint8).transpose(1, 2, 0))


def main(argv=None) -> list[float]:
    parser = ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--point_path", type=str, default=None)
    parser.add_argument("--sh_degree", type=int, default=SH_DEGREE)
    parser.add_argument("--width", type=int, default=WIDTH)
    parser.add_argument("--height", type=int, default=HEIGHT)
    parser.add_argument("--n_iter", type=int, default=N_ITERS)
    parser.add_argument("--n_rounds", type=int, default=N_ROUNDS)
    parser.add_argument("--radius", type=float, default=1.0)
    parser.add_argument("--fovy", type=float, default=20.0)
    parser.add_argument("--timestep", type=int, default=0)
    parser.add_argument("--vis", action="store_true",
                        help=f"write the last frame to {VIS_PATH}")
    parser.add_argument("--n_per_face", type=int, default=10,
                        help="Gaussians bound to each FLAME face (the bench "
                             "avatar)")
    parser.add_argument("--unbound", action="store_true",
                        help="render the unbound 100k cloud instead of the "
                             "bench avatar")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    dev = resolve_device(args.device)
    if args.point_path:
        model = load_avatar(args.point_path, args.sh_degree, dev)
        params = orbit_params(args.width, args.height, args.radius,
                              args.fovy, args.timestep, dev)
        timesteps = [args.timestep]
    elif args.unbound:
        model = scene_to_model(make_bench_scene(device=dev), args.sh_degree)
        params, timesteps = bench_camera(args.width, args.height,
                                         device=dev), [0]
    else:
        model = make_bound_bench_model(args.sh_degree, args.n_per_face,
                                       device=dev)
        params = bench_camera(args.width, args.height, device=dev)
        timesteps = list(range(model.num_timesteps))
    flame_param = model.flame_param if model.binding is not None else None
    cam = camera_arrays(params)
    render = make_render_fn(model, PipelineConfig(), args.width, args.height,
                            model.active_sh_degree)
    bg = torch.ones(3, device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    out = render(model.params, flame_param, model.binding, cam, bg,
                 timesteps[0])
    sync()
    print(f"[info] {model.num_gaussians} gaussians, "
          f"{out.instance_total} instances at timestep {timesteps[0]}, "
          f"{args.width}x{args.height}, {dev}")
    fps = []
    for r in range(args.n_rounds):
        t0 = time.perf_counter()
        for i in range(args.n_iter):
            out = render(model.params, flame_param, model.binding, cam, bg,
                         timesteps[i % len(timesteps)])
        sync()
        fps.append(args.n_iter / (time.perf_counter() - t0))
        print(f"round {r}: {fps[-1]:.2f} fps")
    if args.vis:
        save_vis(VIS_PATH, out.image)
        print(f"saved {VIS_PATH}")
    return fps


if __name__ == "__main__":
    main()
