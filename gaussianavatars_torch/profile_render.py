"""Profile the port on the GPU: the device's busy share and kernel time by
name over a few renders (or, with `--train`, train steps) of the bound
bench avatar.

    python -m gaussianavatars_torch.profile_render [--renders 8] [--train]

Device time comes from torch.profiler (CUPTI); the busy share is the summed
device time of all kernels and copies over the host wall clock of the
profiled iterations (one CUDA stream, so kernels do not overlap). Prints a
table of the top kernels and, last, one JSON summary line.
"""

from __future__ import annotations

import json
import time
from argparse import ArgumentParser

import torch

from gaussianavatars_torch.benchmark import (
    HEIGHT, WIDTH, bench_camera, make_bound_bench_model,
)
import numpy as np

from gaussianavatars_torch.config import OptimizationConfig, PipelineConfig
from gaussianavatars_torch.device import resolve_device
from gaussianavatars_torch.train.loop import (
    camera_arrays, initial_state, lr_pytree, make_render_fn, make_train_step,
)


TOP = 25     # kernels listed


def _self_device_us(evt) -> float:
    """Device time of a device-side event (kernel, copy, set); 0 for host
    ops, which also report the time of the kernels they launched."""
    if not str(evt.device_type).endswith("CUDA"):
        return 0.0
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def main(argv=None) -> dict:
    parser = ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--renders", type=int, default=8,
                        help="profiled renders (train steps with --train)")
    parser.add_argument("--train", action="store_true",
                        help="profile train steps instead of renders")
    args = parser.parse_args(argv)

    dev = resolve_device("cuda")
    model = make_bound_bench_model(device=dev)
    cam = camera_arrays(bench_camera(WIDTH, HEIGHT, device=dev))
    bg = torch.ones(3, device=dev)
    if args.train:
        opt_cfg = OptimizationConfig()
        state = [initial_state(model)]
        flame_fixed = {k: v for k, v in model.flame_param.items()
                       if k not in state[0].flame_tr}
        lrs = lr_pytree(opt_cfg, 1e-3, state[0].flame_tr,
                        model.spatial_lr_scale or 1.0)
        step = make_train_step(model, opt_cfg, PipelineConfig(), WIDTH,
                               HEIGHT, model.active_sh_degree,
                               model.num_timesteps)
        gt = torch.as_tensor(np.random.default_rng(2).random(
            (3, HEIGHT, WIDTH)).astype(np.float32), device=dev)

        def run(i):
            state[0], _, _ = step(state[0], flame_fixed, model.binding, cam,
                                  gt, bg, i % model.num_timesteps, lrs)
    else:
        render = make_render_fn(model, PipelineConfig(), WIDTH, HEIGHT,
                                model.active_sh_degree)

        def run(i):
            render(model.params, model.flame_param, model.binding, cam, bg,
                   i % model.num_timesteps)

    for i in range(model.num_timesteps):
        run(i)
    torch.cuda.synchronize()

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, acc_events=True) as prof:
        t0 = time.perf_counter()
        for i in range(args.renders):
            run(i)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0

    rows = [(e.key, e.count, _self_device_us(e))
            for e in prof.key_averages()]
    rows = [r for r in rows if r[2] > 0]
    rows.sort(key=lambda r: -r[2])
    device_us = sum(r[2] for r in rows)
    unit = "step" if args.train else "render"
    n = args.renders
    print(f"{'kernel':60s} {'calls':>7s} {'ms/' + unit:>10s}")
    for key, count, us in rows[:TOP]:
        print(f"{key[:60]:60s} {count // n:7d} {us / 1e3 / n:10.4f}")
    summary = {
        "device": torch.cuda.get_device_name(dev),
        unit + "s": n,
        f"wall_ms_per_{unit}": 1e3 * wall_s / n,
        f"device_ms_per_{unit}": device_us / 1e3 / n,
        "device_busy_share": device_us / (wall_s * 1e6),
        f"device_ops_per_{unit}": sum(r[1] for r in rows) / n,
        "kernels_ms_per_" + unit: {
            name: sum(us for key, _, us in rows if name in key) / 1e3 / n
            for name in ("blend_fwd_kernel", "blend_bwd_kernel")},
    }
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
