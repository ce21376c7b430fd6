"""Train-step benchmark of the port on the FLAME-bound bench avatar (the
bound train-step half of the root `bench.py::bench_bound`).

Every step drives FLAME at timestep 0 with the finetuned FLAME subset,
builds the face frames and the binding chain, renders at 802x550 (SH 3,
white background), computes L1 + D-SSIM and the xyz and scale
regularizers against a fixed random ground truth, backpropagates, applies
one Adam step and updates the densification statistics.

    python -m gaussianavatars_torch.bench [--device cuda] [--steps 100]
        [--rounds 3] [--width 802 --height 550 --n_per_face 10]

Prints one line per round and, last, one JSON line
{"metric": "bound_step_ms_<W>x<H>_<N/1000>k", "value": ms per step (the
best round), "unit": "ms", "device": ...}.
"""

from __future__ import annotations

import json
import time
from argparse import ArgumentParser

import numpy as np
import torch

from gaussianavatars_torch.benchmark import (
    HEIGHT, SH_DEGREE, WIDTH, bench_camera, make_bound_bench_model,
)
from gaussianavatars_torch.config import OptimizationConfig, PipelineConfig
from gaussianavatars_torch.device import resolve_device
from gaussianavatars_torch.train.loop import (
    camera_arrays, initial_state, lr_pytree, make_train_step,
)


def main(argv=None) -> dict:
    parser = ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--width", type=int, default=WIDTH)
    parser.add_argument("--height", type=int, default=HEIGHT)
    parser.add_argument("--n_per_face", type=int, default=10,
                        help="Gaussians bound to each FLAME face")
    parser.add_argument("--steps", type=int, default=100,
                        help="timed steps per round")
    parser.add_argument("--rounds", type=int, default=3)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    dev = resolve_device(args.device)
    w, h = args.width, args.height
    model = make_bound_bench_model(SH_DEGREE, args.n_per_face, device=dev)
    opt_cfg = OptimizationConfig()
    cam = camera_arrays(bench_camera(w, h, device=dev))
    bg = torch.ones(3, device=dev)
    gt = torch.as_tensor(np.random.default_rng(2).random((3, h, w)).astype(
        np.float32), device=dev)
    state = initial_state(model)
    flame_fixed = {k: v for k, v in model.flame_param.items()
                   if k not in state.flame_tr}
    lrs = lr_pytree(opt_cfg, 1e-3, state.flame_tr,
                    model.spatial_lr_scale or 1.0)
    step = make_train_step(model, opt_cfg, PipelineConfig(), w, h,
                           SH_DEGREE, model.num_timesteps)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    for _ in range(2):                       # warm-up (and kernel builds)
        state, losses, total = step(state, flame_fixed, model.binding, cam,
                                    gt, bg, 0, lrs)
    sync()
    device_name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu")
    print(f"[info] {model.num_gaussians} gaussians, {total} instances, "
          f"{device_name}")
    ms = []
    for r in range(args.rounds):
        t0 = time.perf_counter()
        for _ in range(args.steps):
            state, losses, total = step(state, flame_fixed, model.binding,
                                        cam, gt, bg, 0, lrs)
        sync()
        ms.append(1e3 * (time.perf_counter() - t0) / args.steps)
        print(f"round {r}: {ms[-1]:.3f} ms/step, loss "
              f"{float(losses['total']):.6f}")
    result = {
        "metric": f"bound_step_ms_{w}x{h}_{model.num_gaussians // 1000}k",
        "value": min(ms), "unit": "ms", "device": device_name,
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
