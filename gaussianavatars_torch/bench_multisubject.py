"""Single-card multi-subject training throughput (port of
`tools/bench_multisubject.py`).

S bound bench avatars (`make_bound_bench_model(seed=s)`: their own FLAME
head, Gaussians, Adam state and FLAME trainables, one shape) take turns
through the port's `make_train_step` on one card, the single-card
multi-tenant mode of `train/multisubject.py`. Reports the
solo steps/s of subject 0, the total and per-subject steps/s of the S
subjects in turn, and the efficiency (total / solo; 1.0: taking turns
costs nothing beyond S times the work).

    python -m gaussianavatars_torch.bench_multisubject [--subjects 2]
        [--iters 60] [--rounds 3] [--device cuda]
        [--width 802 --height 550 --n_per_face 10]

Prints three lines and, last, one JSON line {"subjects", "device",
"solo_steps_per_s", "total_steps_per_s", "per_subject_steps_per_s",
"efficiency"} (the best round of each).
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
    parser.add_argument("--subjects", type=int, default=2)
    parser.add_argument("--iters", type=int, default=60,
                        help="iterations per round (each steps every "
                             "subject once)")
    parser.add_argument("--rounds", type=int, default=3)
    parser.add_argument("--width", type=int, default=WIDTH)
    parser.add_argument("--height", type=int, default=HEIGHT)
    parser.add_argument("--n_per_face", type=int, default=10,
                        help="Gaussians bound to each FLAME face")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    dev = resolve_device(args.device)
    w, h = args.width, args.height
    opt_cfg = OptimizationConfig()
    subjects = [make_bound_bench_model(SH_DEGREE, args.n_per_face, seed=s,
                                       device=dev)
                for s in range(args.subjects)]
    cam = camera_arrays(bench_camera(w, h, device=dev))
    bg = torch.ones(3, device=dev)
    gt = torch.as_tensor(np.random.default_rng(3).random((3, h, w)).astype(
        np.float32), device=dev)
    steps, states, fixeds, lrss = [], [], [], []
    for m in subjects:
        steps.append(make_train_step(m, opt_cfg, PipelineConfig(), w, h,
                                     SH_DEGREE, m.num_timesteps))
        state = initial_state(m)
        states.append(state)
        fixeds.append({k: v for k, v in m.flame_param.items()
                       if k not in state.flame_tr})
        lrss.append(lr_pytree(opt_cfg, 1e-3, state.flame_tr,
                              m.spatial_lr_scale or 1.0))

    def one(si):
        states[si] = steps[si](states[si], fixeds[si], subjects[si].binding,
                               cam, gt, bg, 0, lrss[si])[0]

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    for si in range(args.subjects):         # warm-up (and kernel builds)
        one(si)
    sync()

    def run(active):
        best = 0.0
        for _ in range(args.rounds):
            t0 = time.perf_counter()
            for _ in range(args.iters):
                for si in active:
                    one(si)
            sync()
            best = max(best, args.iters * len(active)
                       / (time.perf_counter() - t0))
        return best

    solo = run([0])
    inter = run(list(range(args.subjects)))
    print(f"solo: {solo:.1f} steps/s ({1e3 / solo:.2f} ms/step)")
    print(f"{args.subjects} subjects in turn: {inter:.1f} total steps/s "
          f"({inter / args.subjects:.1f} per subject, "
          f"{1e3 / inter:.2f} ms/step)")
    print(f"interleave efficiency: {inter / solo:.3f}")
    result = {
        "subjects": args.subjects,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "solo_steps_per_s": solo, "total_steps_per_s": inter,
        "per_subject_steps_per_s": inter / args.subjects,
        "efficiency": inter / solo,
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
