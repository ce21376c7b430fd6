"""Tiny sizes of the cells for CPU tests: 64x48 at tile 16, the avatar
seen through a narrow field of view (few of its Gaussians on screen), a
cloud of 400 Gaussians, one short window."""

from __future__ import annotations

import os
import time

import torch

from avatarbench import harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def shrink(cfg: dict, tr: dict) -> tuple[dict, dict]:
    tr = dict(tr, width=64, height=48, warmup_steps=3, profile_iterations=2,
              warmup_frames=1, check_from=1, check_frames=1, period=8,
              timesteps=min(tr["timesteps"], 2),
              cameras=min(tr.get("cameras", 1), 3),
              fovx=0.08 if cfg["kind"] == "bound" else 0.5)
    if "device_iterations" in tr:
        tr["device_iterations"] = 2
    cfg = dict(cfg, tile_size=16)
    if cfg["kind"] == "unbound":
        cfg["gaussians"] = 400
    return cfg, tr


def run(workload: str, trace: bool = False, seconds: float = 0.3,
        seed: int = 3_000_000_007, root: str = ROOT, lines=None) -> dict:
    """One run of a cell at the tiny size on the CPU."""
    bench, _, cfg, tr, limits = harness.find_cell(root, workload)
    cfg, tr = shrink(cfg, tr)
    log = lines.append if lines is not None else (lambda line: None)
    return harness.run_parts(root, bench, workload, cfg, tr, limits, seed,
                             seconds, trace, torch.device("cpu"),
                             time.perf_counter(), log)
