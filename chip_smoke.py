#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`gaussianavatars_torch`).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):
  1. device: the card's name and power limit, torch and CUDA versions;
  2. build: every kernel of the serving path from `gaussianavatars_torch/csrc`
     with nvcc (one process per source, started together);
  3. kernel K1 (forward tile blend) against its plain PyTorch version on
     the card: small scenes, an early-out scene, a tile-row slab (max|d| <=
     1e-5) and the full bench stream of the bound avatar (max|d| <= 1e-3,
     the JAX package's own kernel-vs-jnp drift from deep float32 blending);
  4. both checked-in golden renders through the port's rasterizer on the
     card, at the golden tests' tolerances;
  5. the main path: the FLAME-bound bench avatar (101,440 Gaussians, SH 3)
     served at 802x550 through `make_render_fn` over all 4 timesteps, with
     every kernel's launch count read around the run, then ms per render,
     FPS and the per-stage breakdown (CUDA events);
  6. K1's time at the bench shapes beside its plain version's and its
     roofline bound, as one JSON `kernels` line.
The last line is {"ok": true, "device": {...}}. Nothing here imports JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
TOL_SMALL = 1e-5
TOL_BENCH = 1e-3
MAIN_PATH_RENDERS = 40        # 10 cycles over the 4 timesteps

# NVIDIA H100 SXM published peaks (dense): float32 outside the tensor
# cores, HBM3 bandwidth, and the SFU rate (16 MUFU ops per SM per clock,
# 132 SMs, 1.98 GHz boost) that expf's ex2 issues on.
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
PEAK_SFU_OPS = 16 * 132 * 1.98e9
# K1 arithmetic per pixel-instance pair (see csrc/blend_fwd.cu):
FLOPS_PER_PAIR = 11           # dx, dy and the quadratic
FLOPS_PER_EXP_PAIR = 2        # opacity * exp, alpha clamp
FLOPS_PER_BLENDED = 9         # 1 - alpha, T update, weight, 3 color FMAs


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(res.returncode == 0, f"nvidia-smi failed: {res.stderr}")
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters):
    """Mean device ms of fn() over `iters` calls (after one warm-up)."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def small_scene(n, seed, spread=1.0, scale_mean=-2.3, sh_degree=2):
    """Random cloud near the origin (the JAX test suite's make_scene)."""
    rng = np.random.default_rng(seed)
    k = (sh_degree + 1) ** 2
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    sh = rng.normal(size=(n, k, 3)).astype(np.float32) * 0.3
    sh[:, 0] += 0.8
    return dict(
        means3d=rng.normal(size=(n, 3)).astype(np.float32) * spread,
        scales=np.exp(rng.normal(size=(n, 3)).astype(np.float32) * 0.3
                      + scale_mean),
        quats=quats,
        opacities=rng.uniform(0.3, 0.95, size=(n,)).astype(np.float32),
        shs=sh)


def big_golden_scene(n=1024, seed=3, sh_degree=2):
    """Three overlapping depth shells (the 160x120 golden's scene)."""
    rng = np.random.default_rng(seed)
    k = (sh_degree + 1) ** 2
    shell = rng.integers(0, 3, n)
    means = rng.normal(size=(n, 3)).astype(np.float32) * 0.35
    means[:, 2] += shell * 0.25
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    sh = rng.normal(size=(n, k, 3)).astype(np.float32) * 0.3
    sh[:, 0] += 0.8
    return dict(
        means3d=means,
        scales=np.exp(rng.normal(size=(n, 3)).astype(np.float32) * 0.4 - 2.0),
        quats=quats,
        opacities=rng.uniform(0.55, 0.98, size=(n,)).astype(np.float32),
        shs=sh)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from gaussianavatars_torch import kernels
    from gaussianavatars_torch.benchmark import (
        HEIGHT, WIDTH, bench_camera, make_bound_bench_model, make_camera,
    )
    from gaussianavatars_torch.config import PipelineConfig
    from gaussianavatars_torch.device import resolve_device
    from gaussianavatars_torch.models.gaussians import world_space_gaussians
    from gaussianavatars_torch.ops import tile_blend
    from gaussianavatars_torch.ops.binning_dense import bin_gaussians_dense
    from gaussianavatars_torch.ops.instance_pack import (
        gather_instances, pack_projected,
    )
    from gaussianavatars_torch.ops.projection import project_gaussians
    from gaussianavatars_torch.ops.rasterize_tiles import rasterize
    from gaussianavatars_torch.train.loop import camera_arrays, make_render_fn

    dev = resolve_device("cuda")

    # ---- 1. device --------------------------------------------------------
    smi = nvidia_smi_line()
    print(f"[device] {smi} | torch {torch.__version__} | CUDA "
          f"{torch.version.cuda} | {torch.cuda.get_device_name(0)}")
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmuls are on")

    # ---- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    logs = kernels.build()
    build_s = time.perf_counter() - t0
    print(f"[build] {sorted(logs)} in {build_s:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")

    # ---- 3. K1 against its plain version ------------------------------------
    def stream(scene, camera, tile_size, row0=0, rows=None, sh_degree=2):
        t = {k: torch.as_tensor(v, device=dev) for k, v in scene.items()}
        proj = project_gaussians(t["means3d"], t["scales"], t["quats"],
                                 t["opacities"], t["shs"], sh_degree, camera)
        b = bin_gaussians_dense(
            proj.means2d, proj.depths, proj.radii, proj.valid, proj.conics,
            proj.tau, proj.ext_x, proj.ext_y, camera.width, camera.height,
            tile_size, row0, rows)
        inst = gather_instances(pack_projected(
            proj.means2d, proj.conics, proj.colors, proj.opacities),
            b.gaussian_ids)
        ranges = torch.stack([b.tile_starts, b.tile_ends], -1)
        height = camera.height if rows is None else rows * tile_size
        return inst, ranges, (row0 * tile_size, camera.width, height,
                              tile_size)

    def compare(name, inst, ranges, args, tol):
        out = tile_blend.blend_image(inst, ranges, *args)
        torch.cuda.synchronize()
        ref = tile_blend.blend_image_plain(inst, ranges, *args)
        err = max(float((out[0] - ref[0]).abs().max()),
                  float((out[1] - ref[1]).abs().max()))
        check(bool(torch.isfinite(out[0]).all()), f"K1 {name}: non-finite")
        print(f"[K1] {name}: {inst.shape[0]} instances, max|d| {err:.3e} "
              f"(limit {tol:.0e})")
        check(err <= tol, f"K1 {name}: max|d| {err} above {tol}")
        return err

    small_cam = make_camera(width=48, height=40, device=dev)
    errs = []
    for name, scene, ts, window in (
        ("small tile16", small_scene(128, 0), 16, None),
        ("small tile32", small_scene(128, 4), 32, None),
        ("early-out 0.995", dict(small_scene(128, 9, 0.2, -1.2),
                                 opacities=np.full(128, 0.995, np.float32)),
         16, None),
        ("slab rows 1-2", small_scene(128, 2, 1.0, -2.0), 16, (1, 2)),
    ):
        inst, ranges, args = stream(scene, small_cam, ts,
                                    *(window or (0, None)))
        errs.append(compare(name, inst, ranges, args, TOL_SMALL))

    model = make_bound_bench_model(device=dev)
    cam = bench_camera(WIDTH, HEIGHT, device=dev)
    with torch.no_grad():
        frames = model.face_frames_at(model.flame_param, 0)
        m3, sc, q, op, shs = world_space_gaussians(model.params,
                                                   model.binding, frames)
        bench_scene = dict(means3d=m3, scales=sc, quats=q, opacities=op,
                           shs=shs)
        b_inst, b_ranges, b_args = stream(bench_scene, cam, 32, sh_degree=3)
    errs.append(compare("bench stream 802x550", b_inst, b_ranges, b_args,
                        TOL_BENCH))

    # ---- 4. goldens on the card ---------------------------------------------
    for fname, scene, camera, atol in (
        ("render_48x40_seed0.npz", small_scene(80, 0), small_cam, 3e-5),
        ("render_160x120_seed3.npz", big_golden_scene(),
         make_camera(width=160, height=120, fovx=0.6, dist=1.2, device=dev),
         5e-5),
    ):
        t = {k: torch.as_tensor(v, device=dev) for k, v in scene.items()}
        out = rasterize(t["means3d"], t["scales"], t["quats"],
                        t["opacities"], t["shs"], 2, camera,
                        torch.ones(3, device=dev), tile_size=32)
        golden = torch.as_tensor(np.load(os.path.join(
            REPO, "tests", "golden", fname))["image"], device=dev)
        excess = float(((out.image - golden).abs()
                        - (atol + 1e-4 * golden.abs())).max())
        print(f"[golden] {fname}: max|d| "
              f"{float((out.image - golden).abs().max()):.3e} "
              f"(atol {atol:.0e}, rtol 1e-4)")
        check(excess <= 0, f"golden {fname} differs")

    # ---- 5. the main path ---------------------------------------------------
    render = make_render_fn(model, PipelineConfig(), WIDTH, HEIGHT,
                            model.active_sh_degree)
    ca = camera_arrays(cam)
    bg = torch.ones(3, device=dev)

    def serve(i, mark=None):
        return render(model.params, model.flame_param, model.binding, ca, bg,
                      i % model.num_timesteps, mark)

    for i in range(model.num_timesteps):        # warm-up
        serve(i)
    torch.cuda.synchronize()

    counted = {"blend_fwd": tile_blend.blend_image_cuda}
    for fn in counted.values():
        fn.launches = 0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    outs = []
    t_host = time.perf_counter()
    start.record()
    for i in range(MAIN_PATH_RENDERS):
        outs.append(serve(i))
    end.record()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t_host
    launches = {name: fn.launches for name, fn in counted.items()}
    ms = start.elapsed_time(end) / MAIN_PATH_RENDERS
    print(f"[main] {MAIN_PATH_RENDERS} renders, launches {launches}")
    for name, n in launches.items():
        check(n == MAIN_PATH_RENDERS,
              f"{name} launched {n} times in {MAIN_PATH_RENDERS} renders")
    for i, out in enumerate(outs[:model.num_timesteps]):
        img = out.image
        check(tuple(img.shape) == (3, HEIGHT, WIDTH), f"image shape {img.shape}")
        check(bool(torch.isfinite(img).all()), f"timestep {i}: non-finite")
        check(float(img.std()) > 0.01, f"timestep {i}: constant image")
        check(float(img.min()) >= 0.0, f"timestep {i}: negative color")
        print(f"[main] timestep {i}: instance_total {out.instance_total}, "
              f"mean {float(img.mean()):.4f}, "
              f"covered {float((out.transmittance < 0.5).float().mean()):.3f}")
    check(float((outs[0].image - outs[1].image).abs().max()) > 0,
          "timesteps render identical images")
    print(f"[main] {ms:.3f} ms/render (CUDA events), {1e3 / ms:.1f} fps; "
          f"host clock {1e3 * host_s / MAIN_PATH_RENDERS:.3f} ms/render")

    stages = {}
    for i in range(2 * model.num_timesteps):
        events = [("start", torch.cuda.Event(enable_timing=True))]
        events[0][1].record()

        def mark(name):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append((name, ev))

        serve(i, mark)
        torch.cuda.synchronize()
        for (_, a), (name, b) in zip(events, events[1:]):
            stages[name] = stages.get(name, 0.0) + a.elapsed_time(b)
    stages = {k: v / (2 * model.num_timesteps) for k, v in stages.items()}
    print("[stages] ms: " + ", ".join(f"{k} {v:.3f}" for k, v in
                                      stages.items()))

    # ---- 6. K1 at the bench shapes ------------------------------------------
    k1_ms = cuda_ms(lambda: tile_blend.blend_image(b_inst, b_ranges, *b_args),
                    50)
    plain_ms = cuda_ms(lambda: tile_blend.blend_image_plain(
        b_inst, b_ranges, *b_args), 1)
    _, work = tile_blend.blend_image_plain(b_inst, b_ranges, *b_args,
                                           count_work=True)
    width, height = b_args[1], b_args[2]
    nbytes = (b_inst.numel() + b_ranges.numel() + 4 * width * height) * 4
    flops = (FLOPS_PER_PAIR * work["pairs"] + FLOPS_PER_EXP_PAIR * work["exps"]
             + FLOPS_PER_BLENDED * work["blended"])
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    t_ops = max(flops / PEAK_FP32_FLOPS, work["exps"] / PEAK_SFU_OPS) * 1e3
    bound_ms = max(t_bytes, t_ops)
    print(f"[K1] bench: {b_inst.shape[0]} instances, {k1_ms:.4f} ms kernel, "
          f"{plain_ms:.2f} ms plain; work {work}; bytes {nbytes}, "
          f"fp32 flops {flops}; bound {bound_ms:.4f} ms "
          f"(bytes {t_bytes:.4f}, ops {t_ops:.4f})")

    kernel_line = {"kernels": [{
        "name": "blend_fwd",
        "route": "cuda",
        "source": "gaussianavatars_torch/csrc/blend_fwd.cu",
        "replaces": "gaussianavatars_tpu/ops/blend_pallas.py:437",
        "launches": launches["blend_fwd"],
        "max_abs_err": max(errs),
        "ms": k1_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
    }]}
    print(smi)
    print(json.dumps(kernel_line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
