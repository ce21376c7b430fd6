"""FPS benchmark of the port's serving path (the protocol of the root
`fps_benchmark_demo.py`, reference fps_benchmark_demo.py:35-81).

Renders the FLAME-bound bench avatar (101,440 Gaussians, SH degree 3,
white background, 802x550 by default), cycling its timesteps so every
frame drives FLAME, the face frames and the binding chain, and prints the
FPS of each round. `--unbound` renders the 100k-Gaussian cloud instead.

    python -m gaussianavatars_torch.fps_benchmark_demo [--n_iter 500]
        [--n_rounds 3] [--device cuda]
"""

from __future__ import annotations

import time
from argparse import ArgumentParser

import torch

from gaussianavatars_torch.benchmark import (
    HEIGHT, N_ITERS, N_ROUNDS, SH_DEGREE, WIDTH, bench_camera,
    make_bench_scene, make_bound_bench_model, scene_to_model,
)
from gaussianavatars_torch.config import PipelineConfig
from gaussianavatars_torch.device import resolve_device
from gaussianavatars_torch.train.loop import camera_arrays, make_render_fn


def main(argv=None) -> list[float]:
    parser = ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--sh_degree", type=int, default=SH_DEGREE)
    parser.add_argument("--width", type=int, default=WIDTH)
    parser.add_argument("--height", type=int, default=HEIGHT)
    parser.add_argument("--n_iter", type=int, default=N_ITERS)
    parser.add_argument("--n_rounds", type=int, default=N_ROUNDS)
    parser.add_argument("--n_per_face", type=int, default=10,
                        help="Gaussians bound to each FLAME face")
    parser.add_argument("--unbound", action="store_true",
                        help="render the unbound 100k cloud instead")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    dev = resolve_device(args.device)
    if args.unbound:
        model = scene_to_model(make_bench_scene(device=dev), args.sh_degree)
        flame_param, n_t = None, 1
    else:
        model = make_bound_bench_model(args.sh_degree, args.n_per_face,
                                       device=dev)
        flame_param, n_t = model.flame_param, model.num_timesteps
    cam = camera_arrays(bench_camera(args.width, args.height, device=dev))
    render = make_render_fn(model, PipelineConfig(), args.width, args.height,
                            model.active_sh_degree)
    bg = torch.ones(3, device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    out = render(model.params, flame_param, model.binding, cam, bg, 0)
    sync()
    print(f"[info] {model.num_gaussians} gaussians, "
          f"{out.instance_total} instances at timestep 0, {dev}")
    fps = []
    for r in range(args.n_rounds):
        t0 = time.perf_counter()
        for i in range(args.n_iter):
            render(model.params, flame_param, model.binding, cam, bg, i % n_t)
        sync()
        fps.append(args.n_iter / (time.perf_counter() - t0))
        print(f"round {r}: {fps[-1]:.2f} fps")
    return fps


if __name__ == "__main__":
    main()
