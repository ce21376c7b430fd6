"""Profile the port's serving path on the GPU: the device's busy share and
kernel time by name over a few renders of the bound bench avatar.

    python -m gaussianavatars_torch.profile_render [--renders 8]

Device time comes from torch.profiler (CUPTI); the busy share is the summed
device time of all kernels and copies over the host wall clock of the
profiled renders (one CUDA stream, so kernels do not overlap). Prints a
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
from gaussianavatars_torch.config import PipelineConfig
from gaussianavatars_torch.device import resolve_device
from gaussianavatars_torch.train.loop import camera_arrays, make_render_fn


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
    parser.add_argument("--renders", type=int, default=8)
    args = parser.parse_args(argv)

    dev = resolve_device("cuda")
    model = make_bound_bench_model(device=dev)
    render = make_render_fn(model, PipelineConfig(), WIDTH, HEIGHT,
                            model.active_sh_degree)
    cam = camera_arrays(bench_camera(WIDTH, HEIGHT, device=dev))
    bg = torch.ones(3, device=dev)

    def serve(i):
        return render(model.params, model.flame_param, model.binding, cam,
                      bg, i % model.num_timesteps)

    for i in range(model.num_timesteps):
        serve(i)
    torch.cuda.synchronize()

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, acc_events=True) as prof:
        t0 = time.perf_counter()
        for i in range(args.renders):
            serve(i)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0

    rows = [(e.key, e.count, _self_device_us(e))
            for e in prof.key_averages()]
    rows = [r for r in rows if r[2] > 0]
    rows.sort(key=lambda r: -r[2])
    device_us = sum(r[2] for r in rows)
    per_render_ms = 1e3 * wall_s / args.renders
    print(f"{'kernel':60s} {'calls':>7s} {'ms/render':>10s}")
    for key, count, us in rows[:TOP]:
        print(f"{key[:60]:60s} {count // args.renders:7d} "
              f"{us / 1e3 / args.renders:10.4f}")
    summary = {
        "device": torch.cuda.get_device_name(dev),
        "renders": args.renders,
        "wall_ms_per_render": per_render_ms,
        "device_ms_per_render": device_us / 1e3 / args.renders,
        "device_busy_share": device_us / (wall_s * 1e6),
        "device_ops_per_render": sum(r[1] for r in rows) / args.renders,
    }
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
