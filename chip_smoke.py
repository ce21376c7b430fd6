#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`gaussianavatars_torch`).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):
  1. device: the card's name and power limit, torch and CUDA versions;
  2. build: every kernel of the port from `gaussianavatars_torch/csrc` with
     nvcc (one process per source, started together);
  3. kernel K1 (forward tile blend) against its plain PyTorch version on
     the card: small scenes, an early-out scene, a tile-row slab, scenes
     that stress the kernels' per-warp cull (a Gaussian larger than the
     image, centres exactly on patch and tile borders, needle-thin rotated
     Gaussians, opacities at 1/255, each in every tile's range so that only
     the kernels cull, and a tile-unaligned 801x551 render) (max|d| <=
     1e-5) and the full bench stream of the bound avatar (max|d| <= 1e-3,
     the JAX package's own kernel-vs-jnp drift from deep float32 blending);
     then kernel K2 (its backward) against the plain backward on the same
     streams with random cotangents, per gradient column max|d| /
     max|plain| <= 1e-4 (small; the JAX package's backward gate between
     its backends) and <= 5e-4 (bench stream; its on-device gate at the
     100k bench), and K2 twice on every stream for the same bits;
  4. both checked-in golden renders through the port's rasterizer on the
     card, at the golden tests' tolerances;
  5. the serving path: the FLAME-bound bench avatar (101,440 Gaussians,
     SH 3) served at 802x550 through `make_render_fn` over all 4
     timesteps, with every kernel's launch count read around the run, then
     ms per render, FPS and the per-stage breakdown (CUDA events);
  6. the training path: the same avatar trained through `make_train_step`
     (FLAME finetuning on, L1 + D-SSIM + xyz and scale regularizers, Adam,
     densification statistics) for 2 warm-up and 20 timed steps cycling
     the 4 timesteps, with both kernels' launch counts read around the
     timed steps, finiteness and a falling loss checked, then ms per step
     and its per-phase breakdown (CUDA events);
  7. each kernel's time at the bench shapes beside its plain version's and
     its roofline bound, the bench stream's range lengths and the pixel
     evaluations the kernels make (a counting build), as JSON lines;
  8. training from a dataset (`loop_phase`): a DynamicNerf dataset at
     802x550 whose 40 images (4 timesteps x 8 training, 1 val and 1 test
     cameras) are renders of the bench avatar written by `utils/png.py`;
     the avatar's PLY + flame_param.npz saved and read back through
     `Scene(load_iteration=-1)` bit for bit (parameters, binding, renders);
     300 iterations of `train.loop.training` from the one-Gaussian-per-face
     init with densification at 100 and 200, evaluation and PLY at 300 and
     a checkpoint at 200, both kernels' launches counted around it and the
     binding's invariants checked after each densification; the checkpoint
     restored bit for bit and 10 more iterations from it; densification of
     the 101k avatar after 20 steps of statistics; and `python -m
     gaussianavatars_torch.train` for 30 iterations in a subprocess;
  9. the offline tools on phase 8's 101,440-Gaussian model directory and
     dataset (`offline_phase`): `render` over every split, each PNG within
     1 level of `make_render_fn`'s image and >= 45 dB against its ground
     truth (renders of the same avatar); reenactment through
     `--target_path` of a second dataset with other expressions and poses,
     within 1 level of `make_render_fn` with the target's FLAME parameters
     and unlike the avatar's own motion; `--render_mesh` on the val split
     (mesh coverage, the overlay's difference from the ground truth);
     `python -m gaussianavatars_torch.metrics` in a subprocess with
     synthetic LPIPS weights from seed 0 (LPIPS of identical images <=
     1e-6); 20 train steps of the bench avatar with all three FLAME
     regularizers and a random dynamic offset beside 20 plain steps. The
     renders run in process, where K1 counts one launch per image and K1
     and K2 one each per step.
The `kernels` line is the last but one, the card's name and power limit
the line before it. The last line is {"ok": true, "device": {...}}.
Nothing here imports JAX.
"""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
TOL_SMALL = 1e-5
TOL_BENCH = 1e-3
TOL_BWD_SMALL = 1e-4
TOL_BWD_BENCH = 5e-4
COUNTING = ("GA_COUNT=1",)    # the kernels' counting build (phase 7)
MAIN_PATH_RENDERS = 40        # 10 cycles over the 4 timesteps
TRAIN_STEPS = 20              # 5 cycles over the 4 timesteps
LOOP_ITERATIONS = 300         # phase 8: the training loop
RESUME_ITERATIONS = 10        # phase 8: iterations after the resume
CLI_ITERATIONS = 30           # phase 8: the `train` entry point
DENSIFY_STEPS = 20            # phase 8: statistics before densifying 101k
REG_STEPS = 20                # phase 9: regularized train steps
REGULARIZERS = dict(lambda_dynamic_offset=1.0, lambda_dynamic_offset_std=1.0,
                    lambda_laplacian=1.0)

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
# K2 per blended pair on top of the forward's (see csrc/blend_bwd.cu): c.G
# 5, S_incl 2, d_color 6, d_alpha 4, d_power 1, d_mean 10, d_conic 11,
# d_opacity 2
BWD_FLOPS_PER_BLENDED = FLOPS_PER_BLENDED + 41


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


def stress_streams(dev, tile_size, width=100, height=70, n=96):
    """Streams that stress the kernels' per-warp cull, made directly (no
    projection, no binning): every tile's range holds all `n` instances in
    one order, so nothing is culled before the kernels. Yields
    (name, inst, ranges, blend arguments)."""
    ntx, nty = -(-width // tile_size), -(-height // tile_size)

    def build(mean, lam1, lam2, theta, opacity, seed):
        rng = np.random.default_rng(seed)
        c, s = np.cos(theta), np.sin(theta)
        sxx = lam1 * c * c + lam2 * s * s
        sxy = (lam1 - lam2) * c * s
        syy = lam1 * s * s + lam2 * c * c
        det = sxx * syy - sxy * sxy
        rows = np.concatenate(
            [mean, np.stack([syy / det, -sxy / det, sxx / det], 1),
             rng.uniform(0, 1, (n, 3)), opacity[:, None]], 1)
        inst = torch.as_tensor(np.tile(rows, (ntx * nty, 1)).astype(
            np.float32), device=dev)
        starts = np.arange(ntx * nty) * n
        ranges = torch.as_tensor(np.stack([starts, starts + n], 1).astype(
            np.int32), device=dev)
        return inst, ranges, (0, width, height, tile_size)

    rng = np.random.default_rng(11)
    anywhere = np.stack([rng.uniform(-10, width + 10, n),
                         rng.uniform(-10, height + 10, n)], 1)
    small = np.exp(rng.uniform(np.log(0.3), np.log(30.0), (2, n)))
    angles = rng.uniform(0, np.pi, n)
    opaque = rng.uniform(0.05, 0.9, n)

    lam = small.copy()
    lam[:, 3] = (4e5, 3e5)              # one Gaussian larger than the image
    yield ("huge", *build(anywhere, lam[0], lam[1], angles, opaque, 1))
    on_borders = np.stack([4.0 * rng.integers(0, width // 4 + 1, n),
                           2.0 * rng.integers(0, height // 2 + 1, n)], 1)
    on_borders -= 0.5 * rng.integers(0, 2, (n, 1))
    yield ("borders", *build(on_borders, small[0], small[1], angles, opaque,
                             2))
    yield ("needles", *build(
        anywhere, np.exp(rng.uniform(np.log(1e3), np.log(1e5), n)),
        np.full(n, 0.3), angles, rng.uniform(0.02, 0.3, n), 3))
    faint = (1.0 / 255.0) * rng.choice(
        [1.0 - 1e-6, 1.0, 1.0 + 1e-6, 1.0 + 1e-3, 1.05, 1.5, 4.0], n)
    yield ("faint", *build(anywhere, small[0] * 4, small[1] * 4, angles,
                           faint, 4))


def check_binding(model, what):
    """The binding invariants densification keeps: sorted by face, the
    face counter equal to the binding's counts, no face empty."""
    faces = model.flame_model.num_faces
    counts = torch.bincount(model.binding, minlength=faces)
    check(bool((model.binding[1:] >= model.binding[:-1]).all()),
          f"{what}: binding not sorted")
    check(torch.equal(counts, model.binding_counter),
          f"{what}: binding_counter differs from the binding's counts")
    check(bool((counts > 0).all()), f"{what}: {int((counts == 0).sum())} "
          "faces lost every Gaussian")


def loop_phase(dev, width, height, work, iterations=LOOP_ITERATIONS,
               cli_iterations=CLI_ITERATIONS, n_per_face=10):
    """Phase 8: the avatar trained from a dataset on disk (see the module
    docstring), under the directory `work`, where the FLAME assets
    (`assets`, also left in $FLAME_ASSET_DIR), the dataset (`data`) and
    the avatar's model directory (`io`) stay for phase 9. Returns the
    numbers it measured; raises on any failure."""
    from gaussianavatars_torch.benchmark import (
        bench_meshes, make_bound_bench_model, make_flame_assets,
        write_avatar_dataset,
    )
    from gaussianavatars_torch.config import (
        ModelConfig, OptimizationConfig, PipelineConfig,
    )
    from gaussianavatars_torch.convert import load_checkpoint
    from gaussianavatars_torch.data.loader import load_camera_image
    from gaussianavatars_torch.data.scene import Scene
    from gaussianavatars_torch.models.flame_gaussians import (
        FlameGaussianModel,
    )
    from gaussianavatars_torch.models.gaussians import AdamState
    from gaussianavatars_torch.ops import tile_blend
    from gaussianavatars_torch.train import loop
    from gaussianavatars_torch.utils.png import (
        decode_png, encode_png, read_png,
    )

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def counted():
        return {"blend_fwd": tile_blend.blend_image_cuda,
                "blend_bwd": tile_blend.blend_image_bwd_cuda}

    def reset_launches():
        for fn in counted().values():
            fn.launches = 0

    def launches():
        return {name: fn.launches for name, fn in counted().items()}

    out = {}
    orig_densify = FlameGaussianModel.densify_and_prune
    orig_save = loop.save_checkpoint
    try:
        # ---- the dataset: renders of the bench avatar --------------------
        assets = os.path.join(work, "assets")
        make_flame_assets(assets, seed=0)
        os.environ["FLAME_ASSET_DIR"] = assets    # the model's FLAME head
        avatar = make_bound_bench_model(n_per_face=n_per_face, device=dev)
        timesteps = avatar.num_timesteps
        render = loop.make_render_fn(avatar, PipelineConfig(), width, height,
                                     avatar.active_sh_degree)
        black = torch.zeros(3, device=dev)

        def render_avatar(model, cam):
            return render(model.params, model.flame_param, model.binding,
                          loop.camera_arrays(cam.to_params(device=dev)),
                          black, cam.timestep).image

        def image_fn(cam):
            img = render_avatar(avatar, cam).clamp(0.0, 1.0)
            return (img * 255.0 + 0.5).to(torch.uint8).permute(
                1, 2, 0).cpu().numpy()

        t0 = time.perf_counter()
        data = write_avatar_dataset(
            os.path.join(work, "data"),
            bench_meshes(np.random.default_rng(0), timesteps), width, height,
            image_fn=image_fn)
        out["dataset_s"] = time.perf_counter() - t0
        first = os.path.join(data, "images", "00000_00.png")
        with open(first, "rb") as f:
            raw = f.read()
        paeth = encode_png(read_png(first), filter_type=4)
        decode = {}
        for name, buf in (("none", raw), ("paeth", paeth)):
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                img = decode_png(buf)
                times.append(time.perf_counter() - t0)
            check(img.shape == (height, width, 3), f"PNG shape {img.shape}")
            decode[name] = min(times) * 1e3
        check(np.array_equal(decode_png(paeth), decode_png(raw)),
              "Paeth-filtered PNG decodes differently")
        out["png_decode_ms"] = decode
        print(f"[loop] dataset of {10 * timesteps} {width}x{height} renders "
              f"in {out['dataset_s']:.2f} s; PNG decode per image "
              f"{decode['none']:.2f} ms unfiltered, {decode['paeth']:.2f} ms "
              "Paeth rows")

        # ---- IO at full size --------------------------------------------
        cfg = dict(source_path=data, bind_to_mesh=True, eval=True,
                   sh_degree=3)
        io_dir = os.path.join(work, "io")
        ply = os.path.join(io_dir, "point_cloud", "iteration_1",
                           "point_cloud.ply")
        sync()
        t0 = time.perf_counter()
        avatar.save_ply(ply)
        out["ply_save_s"] = time.perf_counter() - t0
        loaded = FlameGaussianModel.from_assets(3, device=dev)
        t0 = time.perf_counter()
        scene = Scene(ModelConfig(model_path=io_dir, **cfg), loaded,
                      load_iteration=-1)
        sync()
        out["scene_load_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded.load_ply(ply)
        sync()
        out["ply_load_s"] = time.perf_counter() - t0
        for k in avatar.params._fields:
            check(torch.equal(getattr(loaded.params, k),
                              getattr(avatar.params, k)), f"PLY {k} differs")
        check(torch.equal(loaded.binding, avatar.binding), "binding differs")
        for k, v in avatar.flame_param.items():
            check(torch.equal(loaded.flame_param[k], v),
                  f"flame_param.npz {k} differs")
        for cam in scene.get_val_cameras():
            check(torch.equal(render_avatar(loaded, cam),
                              render_avatar(avatar, cam)),
                  f"timestep {cam.timestep}: the loaded avatar renders "
                  "differently")
        print(f"[loop] PLY of {avatar.num_gaussians} Gaussians "
              f"({os.path.getsize(ply)} bytes): save {out['ply_save_s']:.3f}"
              f" s, load {out['ply_load_s']:.3f} s (Scene with it "
              f"{out['scene_load_s']:.3f} s); parameters, binding, FLAME "
              f"and {len(scene.get_val_cameras())} renders bit-identical")

        # ---- the loop ------------------------------------------------------
        densified = []

        def checked_densify(self, *args, **kwargs):
            before = self.num_gaussians
            result = orig_densify(self, *args, **kwargs)
            check_binding(self, f"densification {len(densified) + 1}")
            densified.append((before, self.num_gaussians))
            return result

        captured = {}

        def keeping_save(model, state, iteration, path):
            orig_save(model, state, iteration, path)
            captured[iteration] = model.capture(loop._adam(state))
            captured[iteration].update(
                {f"f_{k}": v.to("cpu", copy=True).numpy()
                 for k, v in state.flame_tr.items()})

        FlameGaussianModel.densify_and_prune = checked_densify
        loop.save_checkpoint = keeping_save
        ckpt_at = 2 * iterations // 3
        # a tenth of the default gradient threshold: from the init (opacity
        # 0.1) a 550-pixel-high view gives screen gradients of ~1e-4
        sched = dict(densify_from_iter=iterations // 6,
                     densification_interval=iterations // 3,
                     densify_until_iter=5 * iterations // 6,
                     densify_grad_threshold=2e-5,
                     opacity_reset_interval=10 * iterations)
        run_dir = os.path.join(work, "run")
        reset_launches()
        sync()
        t0 = time.perf_counter()
        model, state, info = loop.training(
            ModelConfig(model_path=run_dir, **cfg),
            OptimizationConfig(iterations=iterations, **sched),
            PipelineConfig(), testing_iterations={iterations},
            saving_iterations={iterations}, checkpoint_iterations={ckpt_at},
            device=dev)
        sync()
        loop_s = time.perf_counter() - t0
        loop_launches = launches()
        n_eval = len(scene.get_val_cameras()) + len(scene.get_test_cameras())
        print(f"[loop] {iterations} iterations, launches {loop_launches} "
              f"({n_eval} eval renders)")
        check(loop_launches["blend_fwd"] == iterations + n_eval,
              f"K1 launched {loop_launches['blend_fwd']} times")
        check(loop_launches["blend_bwd"] == iterations,
              f"K2 launched {loop_launches['blend_bwd']} times")
        history = info["history"]
        check(all(np.isfinite(v) for _, v in history), "non-finite loss")
        check(history[-1][1] < history[0][1],
              f"loss did not fall: {history[0]} -> {history[-1]}")
        faces = model.flame_model.num_faces
        check(len(densified) == 2, f"{len(densified)} densifications")
        check(model.num_gaussians > faces,
              f"{model.num_gaussians} Gaussians, no growth from {faces}")
        for name in (f"point_cloud/iteration_{iterations}/point_cloud.ply",
                     f"point_cloud/iteration_{iterations}/flame_param.npz",
                     f"chkpnt{ckpt_at}.npz", "cfg.json", "run_summary.json"):
            check(os.path.exists(os.path.join(run_dir, name)),
                  f"{name} missing")
        # log points between which no densification, eval or save runs
        times = dict(info["timeline"])
        lo = min(k for k in times if k >= iterations // 15)
        hi = max(k for k in times if k <= iterations // 3)
        steady_ms = 1e3 * (times[hi] - times[lo]) / (hi - lo)
        metrics = info["metrics"][iterations]
        out.update(
            loop_ms_per_iteration=1e3 * loop_s / iterations,
            loop_steady_ms_per_iteration=steady_ms,
            loop_launches=loop_launches, n_gaussians=model.num_gaussians,
            densify=[dict(before=b, after=a, s=s) for (b, a), s in
                     zip(densified, info["densify_s"])],
            psnr={split: m["psnr"] for split, m in metrics.items()},
            first_loss=history[0][1], last_loss=history[-1][1])
        print(f"[loop] {out['loop_ms_per_iteration']:.2f} ms/iteration over "
              f"the whole loop (host clock, {loop_s:.2f} s), "
              f"{steady_ms:.2f} ms/iteration between iterations {lo} and "
              f"{hi}; EMA loss {history[0][1]:.5f} -> {history[-1][1]:.5f}; "
              f"densifications " + ", ".join(
                  f"{d['before']} -> {d['after']} in {1e3 * d['s']:.1f} ms"
                  for d in out["densify"]))
        for split, m in metrics.items():
            print(f"[loop] {split}: " + ", ".join(
                f"{k} {v:.4f}" for k, v in m.items()))

        # ---- the bare step at the loop's shapes ---------------------------
        # the loop's steady window again without the loop: a fresh init,
        # the same cameras, their ground truth already on the device
        bare = FlameGaussianModel.from_assets(3, device=dev)
        bare_scene = Scene(ModelConfig(model_path=os.path.join(work, "bare"),
                                       **cfg), bare)
        opt = OptimizationConfig()
        bare_state = loop.initial_state(bare)
        fixed = {k: v for k, v in bare.flame_param.items()
                 if k not in bare_state.flame_tr}
        lrs = loop.lr_pytree(opt, opt.position_lr_init * bare.spatial_lr_scale,
                             bare_state.flame_tr, bare.spatial_lr_scale)
        step = loop.make_train_step(bare, opt, PipelineConfig(), width, height,
                                    bare.active_sh_degree, timesteps)
        views = [(loop.camera_arrays(c.to_params(device=dev)),
                  torch.tensor(load_camera_image(c), device=dev), c.timestep)
                 for c in bare_scene.get_train_cameras()]

        def bare_steps(start, count):
            nonlocal bare_state
            for i in range(start, start + count):
                ca, gt, t = views[i % len(views)]
                bare_state, _, _ = step(bare_state, fixed, bare.binding, ca,
                                        gt, black, t, lrs)

        bare_steps(0, lo)
        sync()
        t0 = time.perf_counter()
        bare_steps(lo, hi - lo)
        sync()
        out["bare_step_ms"] = 1e3 * (time.perf_counter() - t0) / (hi - lo)
        print(f"[loop] the bare train step at the loop's shapes (fresh "
              f"init, same cameras, ground truth on the device): "
              f"{out['bare_step_ms']:.2f} ms/step over steps {lo}-{hi}; the "
              f"loop {steady_ms:.2f} ms/iteration over the same iterations")

        # ---- resume ------------------------------------------------------
        restored = FlameGaussianModel.from_assets(3, device=dev)
        restored.flame_param = {k: v.clone()
                                for k, v in model.flame_param.items()}
        iteration, adam, flame_tr = load_checkpoint(
            os.path.join(run_dir, f"chkpnt{ckpt_at}.npz"), restored)
        again = restored.capture(adam)
        again.update({f"f_{k}": v.cpu().numpy() for k, v in flame_tr.items()})
        check(iteration == ckpt_at, f"checkpoint iteration {iteration}")
        check(sorted(again) == sorted(captured[ckpt_at]),
              "restored state has other keys")
        for k, v in captured[ckpt_at].items():
            check(np.array_equal(np.asarray(again[k]), np.asarray(v)),
                  f"restored {k} differs from the captured state")
        reset_launches()
        _, resumed, rinfo = loop.training(
            ModelConfig(model_path=os.path.join(work, "resumed"), **cfg),
            OptimizationConfig(iterations=ckpt_at + RESUME_ITERATIONS,
                               **sched),
            PipelineConfig(), start_checkpoint=os.path.join(
                run_dir, f"chkpnt{ckpt_at}.npz"), device=dev)
        resume_launches = launches()
        check(resumed.count == ckpt_at + RESUME_ITERATIONS,
              f"resumed Adam count {resumed.count}")
        check(np.isfinite(rinfo["ema_loss"]), "resumed loss not finite")
        check(resume_launches == {"blend_fwd": RESUME_ITERATIONS,
                                  "blend_bwd": RESUME_ITERATIONS},
              f"resumed launches {resume_launches}")
        print(f"[loop] checkpoint {ckpt_at} restored bit for bit "
              f"({len(again)} arrays); {RESUME_ITERATIONS} more iterations, "
              f"loss {rinfo['ema_loss']:.5f}, launches {resume_launches}")

        # ---- densification of the 101k avatar ----------------------------
        FlameGaussianModel.densify_and_prune = orig_densify
        avatar.reset_stats()
        state = loop.initial_state(avatar)
        fixed = {k: v for k, v in avatar.flame_param.items()
                 if k not in state.flame_tr}
        lrs = loop.lr_pytree(opt, 1e-3, state.flame_tr, 1.0)
        step = loop.make_train_step(avatar, opt, PipelineConfig(), width,
                                    height, 3, timesteps)
        # a noise target, as bench.py's: the dataset's images are the
        # avatar's own renders and would leave it without gradients
        gt = torch.as_tensor(np.random.default_rng(2).random(
            (3, height, width)).astype(np.float32), device=dev)
        cams = scene.get_train_cameras()
        for i in range(DENSIFY_STEPS):
            cam = cams[i % len(cams)]
            state, _, _ = step(state, fixed, avatar.binding,
                               loop.camera_arrays(cam.to_params(device=dev)),
                               gt, black, cam.timestep, lrs)
        with torch.no_grad():
            face_scaling = avatar.face_frames_at(avatar.flame_param,
                                                 0).scaling
        before = avatar.num_gaussians
        sync()
        t0 = time.perf_counter()
        adam = avatar.densify_and_prune(
            AdamState(state.mu["gauss"], state.nu["gauss"], state.count),
            opt.densify_grad_threshold, 0.005, scene.cameras_extent, None,
            opt.percent_dense, face_scaling, seed=1)
        sync()
        out["densify_bench"] = dict(before=before,
                                    after=avatar.num_gaussians,
                                    s=time.perf_counter() - t0)
        check_binding(avatar, "101k densification")
        check(adam.mu.xyz.shape[0] == avatar.num_gaussians,
              "Adam state and parameters differ in length")
        check(avatar.num_gaussians != before, "the 101k avatar did not change")
        print(f"[loop] densify_and_prune at the bench size: {before} -> "
              f"{avatar.num_gaussians} Gaussians in "
              f"{1e3 * out['densify_bench']['s']:.1f} ms after "
              f"{DENSIFY_STEPS} steps")

        # ---- the entry point -----------------------------------------------
        cli_dir = os.path.join(work, "cli")
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "gaussianavatars_torch.train", "-s", data,
             "-m", cli_dir, "--bind_to_mesh", "--eval", "--iterations",
             str(cli_iterations), "--save_iterations", str(cli_iterations),
             "--test_iterations", str(cli_iterations),
             "--checkpoint_iterations", str(cli_iterations),
             "--device", dev.type],
            cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
            capture_output=True, text=True, timeout=600)
        out["cli_s"] = time.perf_counter() - t0
        check(res.returncode == 0, f"train entry point exited "
              f"{res.returncode}: {res.stderr[-3000:]}")
        check(os.path.exists(os.path.join(
            cli_dir, "point_cloud", f"iteration_{cli_iterations}",
            "point_cloud.ply")), "the train entry point wrote no PLY")
        tail = [line for line in res.stdout.splitlines() if line.strip()]
        print(f"[loop] python -m gaussianavatars_torch.train: "
              f"{cli_iterations} iterations in {out['cli_s']:.1f} s "
              f"(process included); {tail[-2] if len(tail) > 1 else tail}")
    finally:
        FlameGaussianModel.densify_and_prune = orig_densify
        loop.save_checkpoint = orig_save
    return out


def _level_diff(a, b) -> int:
    return int(np.abs(a.astype(np.int16) - b.astype(np.int16)).max())


def _png_psnr(a, b) -> float:
    """PSNR in dB of two uint8 images (inf when they are equal)."""
    mse = float(np.mean(((a.astype(np.float64) - b) / 255.0) ** 2))
    return float("inf") if mse == 0.0 else -10.0 * float(np.log10(mse))


def synthetic_lpips_weights(path, seed=0):
    """LPIPS weights of the VGG16 shapes drawn from `seed` (the real ones
    are a download the repository does not hold)."""
    from gaussianavatars_torch.metrics_lib.lpips import _VGG_STAGES

    rng = np.random.default_rng(seed)
    weights, ci, in_ch = {}, 0, 3
    for ch, n_convs in _VGG_STAGES:
        for _ in range(n_convs):
            weights[f"conv{ci}_w"] = (rng.standard_normal(
                (ch, in_ch, 3, 3), np.float32) * np.sqrt(2.0 / (9 * in_ch))
            ).astype(np.float32)
            weights[f"conv{ci}_b"] = np.zeros(ch, np.float32)
            in_ch = ch
            ci += 1
    for i, (ch, _) in enumerate(_VGG_STAGES):
        weights[f"lin{i}"] = np.abs(rng.normal(0, 0.05, ch)).astype(
            np.float32)
    np.savez(path, **weights)
    return path


def offline_phase(dev, width, height, work, steps=REG_STEPS):
    """Phase 9: the trained avatar of phase 8's model directory
    (`<work>/io`, 101,440 Gaussians, its dataset `<work>/data`) rendered,
    reenacted, overlaid and scored by the offline entry points, and the
    bench avatar trained with the FLAME regularizers (see the module
    docstring). Returns the numbers it measured; raises on any failure."""
    from gaussianavatars_torch import metrics as metrics_cli
    from gaussianavatars_torch.benchmark import (
        bench_camera, bench_meshes, make_bound_bench_model,
        write_avatar_dataset,
    )
    from gaussianavatars_torch.config import (
        ModelConfig, OptimizationConfig, PipelineConfig, save_config,
    )
    from gaussianavatars_torch.data.scene import Scene
    from gaussianavatars_torch.metrics_lib.lpips import LPIPS
    from gaussianavatars_torch.models.flame_gaussians import (
        FlameGaussianModel,
    )
    from gaussianavatars_torch.ops import tile_blend
    from gaussianavatars_torch.render import __main__ as render_cli
    from gaussianavatars_torch.render.mesh_renderer import (
        rasterize_mesh, render_mesh_overlay,
    )
    from gaussianavatars_torch.train import loop
    from gaussianavatars_torch.utils.png import read_png

    k1, k2 = tile_blend.blend_image_cuda, tile_blend.blend_image_bwd_cuda

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def run(argv):
        """The render entry point in process: (stats, host s, K1 and K2
        launches)."""
        k1.launches = k2.launches = 0
        sync()
        t0 = time.perf_counter()
        stats = render_cli.main(argv + ["--device", dev.type])
        sync()
        return (stats, time.perf_counter() - t0,
                {"blend_fwd": k1.launches, "blend_bwd": k2.launches})

    data, model_dir = os.path.join(work, "data"), os.path.join(work, "io")
    cfg = dict(source_path=data, model_path=model_dir, bind_to_mesh=True,
               eval=True, sh_degree=3)
    save_config(model_dir, ModelConfig(**cfg))
    model = FlameGaussianModel.from_assets(3, device=dev)
    scene = Scene(ModelConfig(**cfg), model, load_iteration=-1,
                  shuffle=False)
    it = scene.loaded_iter
    render = loop.make_render_fn(model, PipelineConfig(), width, height, 3)
    black = torch.zeros(3, device=dev)

    def reference(cam, flame_param):
        img = render(model.params, flame_param, model.binding,
                     loop.camera_arrays(cam.to_params(device=dev)), black,
                     cam.timestep).image
        return render_cli.to_uint8(img.clamp(0.0, 1.0)).cpu().numpy()

    out, launches = {}, {}
    # ---- (a) every split --------------------------------------------------
    stats, wall, launches["splits"] = run(["-m", model_dir])
    images = sum(st["images"] for st in stats.values())
    splits = {"train": scene.get_train_cameras(),
              "val": scene.get_val_cameras(),
              "test": scene.get_test_cameras()}
    check(images == sum(len(c) for c in splits.values()),
          f"render wrote {images} images per split {stats}")
    check(launches["splits"] == {"blend_fwd": images, "blend_bwd": 0},
          f"render launches {launches['splits']} for {images} images")
    level, psnrs = 0, []
    for split, cams in splits.items():
        base = os.path.join(model_dir, split, f"ours_{it}")
        for idx, cam in enumerate(cams):
            got = read_png(os.path.join(base, "renders", f"{idx:05d}.png"))
            level = max(level, _level_diff(got, reference(
                cam, model.flame_param)))
            psnrs.append(_png_psnr(got, read_png(os.path.join(
                base, "gt", f"{idx:05d}.png"))))
    check(level <= 1, f"a written render is {level} levels from "
          "make_render_fn's")
    check(min(psnrs) >= 45.0, f"PSNR {min(psnrs)} dB against the ground "
          "truth")
    render_s = sum(st["render_s"] for st in stats.values())
    write_s = sum(st["write_s"] for st in stats.values())
    out["render"] = dict(
        images=images, launches=launches["splits"], max_level_diff=level,
        gt_psnr_min=str(min(psnrs)), entry_point_s=wall,
        images_per_s=images / wall, render_ms_per_image=1e3 * render_s /
        images, png_write_ms_per_image=1e3 * write_s / images)
    print(f"[offline] render: {images} images in {wall:.2f} s "
          f"({images / wall:.1f} images/s, model load included); render + "
          f"copy {1e3 * render_s / images:.2f} ms/image, PNG encode "
          f"{1e3 * write_s / images:.2f} ms/image (pool threads); every "
          f"PNG within {level} level of make_render_fn; PSNR against the "
          f"ground truth >= {min(psnrs)} dB; launches {launches['splits']}")

    # ---- (b) reenactment ----------------------------------------------------
    tgt = bench_meshes(np.random.default_rng(7), model.num_timesteps)
    rng = np.random.default_rng(8)
    for mesh in tgt.values():
        for k, n in (("rotation", 3), ("neck_pose", 3), ("eyes_pose", 6)):
            mesh[k] = rng.normal(0, 0.05, n).astype(np.float32)
    target = write_avatar_dataset(os.path.join(work, "target"), tgt, width,
                                  height, n_train_cams=2)
    stats, wall, launches["reenact"] = run(["-m", model_dir, "-t", target])
    name = os.path.basename(target)
    tgt_cams = Scene(ModelConfig(**cfg, target_path=target),
                     FlameGaussianModel.from_assets(3, device=dev),
                     load_iteration=-1, shuffle=False).get_train_cameras()
    n_tgt = stats[name]["images"]
    check(n_tgt == len(tgt_cams) == 4 * model.num_timesteps,
          f"reenactment wrote {n_tgt} images")
    check(launches["reenact"] == {"blend_fwd": n_tgt, "blend_bwd": 0},
          f"reenactment launches {launches['reenact']}")
    tgt_param = dict(model.flame_param)
    for k in ("expr", "rotation", "neck_pose", "jaw_pose", "eyes_pose",
              "translation"):
        tgt_param[k] = torch.as_tensor(
            np.stack([tgt[t][k] for t in sorted(tgt)]), device=dev)
    level = 0
    base = os.path.join(model_dir, name, f"ours_{it}", "renders")
    for idx, cam in enumerate(tgt_cams):
        got = read_png(os.path.join(base, f"{idx:05d}.png"))
        level = max(level, _level_diff(got, reference(cam, tgt_param)))
    check(level <= 1, f"a reenacted render is {level} levels from "
          "make_render_fn's with the target's parameters")
    # the target's first camera is the training split's first camera
    own = read_png(os.path.join(model_dir, "train", f"ours_{it}", "renders",
                                "00000.png"))
    moved = np.abs(read_png(os.path.join(base, "00000.png")).astype(
        np.int16) - own).mean()
    check(moved > 0.1, "the reenactment renders the avatar's own motion")
    out["reenact"] = dict(images=n_tgt, launches=launches["reenact"],
                          max_level_diff=level,
                          mean_level_diff_to_own_motion=float(moved),
                          images_per_s=n_tgt / wall)
    print(f"[offline] reenactment: {n_tgt} images in {wall:.2f} s, within "
          f"{level} level of make_render_fn with the target's FLAME; mean "
          f"difference to the avatar's own motion {moved:.2f} levels")

    # ---- (c) mesh overlays --------------------------------------------------
    stats, wall, launches["mesh"] = run(
        ["-m", model_dir, "--skip_train", "--skip_test", "--render_mesh"])
    n_val = stats["val"]["images"]
    check(launches["mesh"] == {"blend_fwd": n_val, "blend_bwd": 0},
          f"--render_mesh launches {launches['mesh']}")
    cam = splits["val"][0]
    with torch.no_grad():
        verts = model.verts_at(model.flame_param, cam.timestep)[0]
    params = cam.to_params(device=dev)
    coverage = float(rasterize_mesh(verts, model.flame_model.faces,
                                    params)[1].mean())
    check(coverage > 0.0, "the mesh covers no pixel")
    overlay_ms = cuda_ms(lambda: render_mesh_overlay(
        verts, model.flame_model.faces, params), 10)
    base = os.path.join(model_dir, "val", f"ours_{it}")
    diffs = [np.abs(read_png(os.path.join(base, "renders_mesh", f)).astype(
        np.float64) - read_png(os.path.join(base, "gt", f))).mean() / 255.0
        for f in sorted(os.listdir(os.path.join(base, "renders_mesh")))]
    check(len(diffs) == n_val and min(diffs) > 0,
          f"{len(diffs)} overlays, differences {diffs}")
    out["mesh"] = dict(images=n_val, coverage=coverage,
                       overlay_mean_abs_diff_to_gt=float(np.mean(diffs)),
                       overlay_ms=overlay_ms,
                       entry_point_mesh_ms_per_image=1e3 * stats["val"][
                           "mesh_s"] / n_val)
    print(f"[offline] mesh overlays: {n_val} images, coverage "
          f"{coverage:.3f}, mean |overlay - gt| {np.mean(diffs):.4f}; "
          f"overlay {overlay_ms:.2f} ms (CUDA events), "
          f"{out['mesh']['entry_point_mesh_ms_per_image']:.2f} ms/image in "
          "the entry point (copy to the host included)")

    # ---- (d) metrics --------------------------------------------------------
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    weights = os.path.join(REPO, "chiprun_out", "lpips_synthetic.npz")
    saved = os.environ.get("LPIPS_WEIGHTS")
    try:
        synthetic_lpips_weights(weights, seed=0)
        os.environ["LPIPS_WEIGHTS"] = weights
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "gaussianavatars_torch.metrics", "-m",
             model_dir, "--device", dev.type],
            cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
            capture_output=True, text=True, timeout=600)
        cli_s = time.perf_counter() - t0
        check(res.returncode == 0, f"metrics entry point exited "
              f"{res.returncode}: {res.stderr[-3000:]}")
        with open(os.path.join(model_dir, "results.json")) as f:
            results = json.load(f)[f"ours_{it}"]
        with open(os.path.join(model_dir, "per_view.json")) as f:
            per_view = json.load(f)[f"ours_{it}"]
        check(sorted(results) == ["LPIPS", "PSNR", "SSIM"],
              f"results.json holds {sorted(results)}")
        # the renders are the ground truth's own pixels
        lpips_same = max(per_view["LPIPS"].values())
        check(lpips_same <= 1e-6, f"LPIPS of identical images {lpips_same}")

        lpips = LPIPS(weights, device=dev)
        a = torch.as_tensor(read_png(os.path.join(
            model_dir, "val", f"ours_{it}", "renders", "00000.png")),
            device=dev).permute(2, 0, 1).float() / 255.0
        b = torch.as_tensor(np.random.default_rng(3).random(
            (3, height, width)).astype(np.float32), device=dev)
        with torch.no_grad():
            same = float(lpips(a, a)[0])
            apart = float(lpips(a, b)[0])
            lpips_ms = cuda_ms(lambda: lpips(a, b), 5)
        check(same <= 1e-6 and apart > 0.0,
              f"LPIPS same {same}, render vs noise {apart}")
        check(not (torch.backends.cudnn.allow_tf32
                   or torch.backends.cuda.matmul.allow_tf32),
              "TF32 is on after LPIPS")
        # the tool in process, PNG reads included, the network built
        per_image = {}
        os.environ["LPIPS_WEIGHTS"] = weights + ".absent"
        for key, fn in (("with_lpips", lpips), ("without_lpips", None)):
            t0 = time.perf_counter()
            metrics_cli.evaluate([model_dir], ("test", "val", "train"),
                                 dev.type, lpips_fn=fn)
            per_image[key] = 1e3 * (time.perf_counter() - t0) / images
    finally:
        if saved is None:
            os.environ.pop("LPIPS_WEIGHTS", None)
        else:
            os.environ["LPIPS_WEIGHTS"] = saved
        if os.path.exists(weights):
            os.remove(weights)
    out["metrics"] = dict(
        results=results, lpips_identical_max=lpips_same, lpips_same=same,
        lpips_render_vs_noise=apart, lpips_ms_per_pair=lpips_ms,
        entry_point_s=cli_s, ms_per_image=per_image)
    print(f"[offline] python -m gaussianavatars_torch.metrics: "
          f"{cli_s:.1f} s (process included); "
          + ", ".join(f"{k} {v:.6f}" for k, v in results.items())
          + f"; LPIPS of identical images <= {lpips_same:.2e}, render vs "
          f"noise {apart:.4f}, {lpips_ms:.2f} ms per {width}x{height} pair (CUDA "
          f"events); in process {per_image['with_lpips']:.2f} ms/image "
          f"with LPIPS, {per_image['without_lpips']:.2f} without")

    # ---- (e) the FLAME regularizers ------------------------------------------
    bench = make_bound_bench_model(device=dev)
    off = bench.flame_param["dynamic_offset"]
    bench.flame_param["dynamic_offset"] = torch.as_tensor(
        np.random.default_rng(9).normal(0, 1e-3, tuple(off.shape)).astype(
            np.float32), device=dev)
    ca = loop.camera_arrays(bench_camera(width, height, device=dev))
    gt = torch.as_tensor(np.random.default_rng(2).random(
        (3, height, width)).astype(np.float32), device=dev)
    ones = torch.ones(3, device=dev)
    configs = {"plain": OptimizationConfig(),
               "regularized": OptimizationConfig(**REGULARIZERS)}
    steps_ms = {k: [] for k in configs}
    reg_losses = []
    for _ in range(2):
        for key, opt in configs.items():
            state = loop.initial_state(bench)
            fixed = {k: v for k, v in bench.flame_param.items()
                     if k not in state.flame_tr}
            lrs = loop.lr_pytree(opt, 1e-3, state.flame_tr, 1.0)
            step = loop.make_train_step(bench, opt, PipelineConfig(), width,
                                        height, 3, bench.num_timesteps)
            for i in range(2):                       # warm-up
                state, _, _ = step(state, fixed, bench.binding, ca, gt, ones,
                                   i % bench.num_timesteps, lrs)
            sync()
            k1.launches = k2.launches = 0
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for i in range(steps):
                state, losses, _ = step(state, fixed, bench.binding, ca, gt,
                                        ones, i % bench.num_timesteps, lrs)
                if key == "regularized":
                    reg_losses.append(losses)
            end.record()
            sync()
            steps_ms[key].append(start.elapsed_time(end) / steps)
            launches[key] = {"blend_fwd": k1.launches,
                             "blend_bwd": k2.launches}
            check(launches[key] == {"blend_fwd": steps, "blend_bwd": steps},
                  f"{key} steps launched {launches[key]}")
    for losses in reg_losses:
        for k in ("dy_off", "dynamic_offset_std", "lap"):
            v = float(losses[k])
            check(np.isfinite(v) and v != 0.0, f"regularizer {k} is {v}")
        check(bool(torch.isfinite(losses["total"])), "non-finite loss")
    last = {k: float(v) for k, v in reg_losses[-1].items()}
    out["regularizers"] = dict(
        weights=REGULARIZERS, steps=steps, launches=launches["regularized"],
        losses=last, regularized_step_ms=steps_ms["regularized"],
        plain_step_ms=steps_ms["plain"])
    print(f"[offline] {steps} regularized steps at {width}x{height}, "
          f"{bench.num_gaussians} Gaussians: "
          + ", ".join(f"{k} {last[k]:.6g}" for k in
                      ("dy_off", "dynamic_offset_std", "lap", "total"))
          + "; ms/step (CUDA events, two alternating rounds) regularized "
          + ", ".join(f"{v:.3f}" for v in steps_ms["regularized"])
          + ", plain " + ", ".join(f"{v:.3f}" for v in steps_ms["plain"])
          + f"; launches {launches['regularized']}")
    out["launches"] = launches
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from gaussianavatars_torch import kernels
    from gaussianavatars_torch.benchmark import (
        HEIGHT, WIDTH, bench_camera, blend_inputs, bound_bench_scene,
        make_bound_bench_model, make_camera,
    )
    from gaussianavatars_torch.config import OptimizationConfig, PipelineConfig
    from gaussianavatars_torch.device import resolve_device
    from gaussianavatars_torch.ops import tile_blend
    from gaussianavatars_torch.ops.rasterize_tiles import rasterize
    from gaussianavatars_torch.profile_render import range_stats
    from gaussianavatars_torch.train.loop import (
        camera_arrays, initial_state, lr_pytree, make_render_fn,
        make_train_step,
    )
    from gaussianavatars_torch.train.optim import tree_leaves

    dev = resolve_device("cuda")
    phase_s, t_phase = {}, [time.perf_counter()]

    def lap(name):
        """Seconds of the phase that just ended (host clock)."""
        now = time.perf_counter()
        phase_s[name] = round(now - t_phase[0], 2)
        t_phase[0] = now

    # ---- 1. device --------------------------------------------------------
    smi = nvidia_smi_line()
    print(f"[device] {smi} | torch {torch.__version__} | CUDA "
          f"{torch.version.cuda} | {torch.cuda.get_device_name(0)}")
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmuls are on")

    lap("device")
    # ---- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:   # the counting build beside it
        counting = pool.submit(kernels.build, None, COUNTING)
        logs = kernels.build()
        counting.result()
    build_s = time.perf_counter() - t0
    print(f"[build] {sorted(logs)} in {build_s:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")

    lap("build")
    # ---- 3. K1 against its plain version ------------------------------------
    def stream(scene, camera, tile_size, row0=0, rows=None, sh_degree=2):
        t = {k: torch.as_tensor(v, device=dev) for k, v in scene.items()}
        return blend_inputs(t, camera, tile_size, sh_degree, row0, rows)

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

    def cotangents(args, seed):
        rng = np.random.default_rng(seed)
        width, height = args[1], args[2]
        return (torch.as_tensor(rng.normal(size=(3, height, width)).astype(
                    np.float32), device=dev),
                torch.as_tensor(rng.normal(size=(height, width)).astype(
                    np.float32), device=dev))

    def compare_bwd(name, inst, ranges, args, tol, seed):
        """K2 against the plain backward; returns (max|d|, the largest
        per-column max|d| / max|plain|, the plain version's ms)."""
        color, trans = tile_blend.blend_image_cuda(inst, ranges, *args)
        g_c, g_t = cotangents(args, seed)
        out = tile_blend.blend_image_bwd_cuda(inst, ranges, *args, color,
                                              trans, g_c, g_t)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        ref = tile_blend.blend_image_bwd_plain(inst, ranges, *args, color,
                                               trans, g_c, g_t)
        end.record()
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out).all()), f"K2 {name}: non-finite")
        diff = (out - ref).abs()
        rel = float((diff.amax(0) / ref.abs().amax(0).clamp(min=1e-30)).max())
        err = float(diff.max())
        print(f"[K2] {name}: {inst.shape[0]} slots, max|d| {err:.3e}, "
              f"column max|d|/max|plain| {rel:.3e} (limit {tol:.0e}), "
              f"nonzero slots {int((ref != 0).any(1).sum())}")
        check(rel <= tol, f"K2 {name}: relative error {rel} above {tol}")
        again = tile_blend.blend_image_bwd_cuda(inst, ranges, *args, color,
                                                trans, g_c, g_t)
        check(torch.equal(out, again),
              f"K2 {name}: two runs gave different bits")
        return err, rel, start.elapsed_time(end)

    small_cam = make_camera(width=48, height=40, device=dev)
    errs, bwd_errs = [], []
    for seed, (name, scene, ts, window) in enumerate((
        ("small tile16", small_scene(128, 0), 16, None),
        ("small tile32", small_scene(128, 4), 32, None),
        ("early-out 0.995", dict(small_scene(128, 9, 0.2, -1.2),
                                 opacities=np.full(128, 0.995, np.float32)),
         16, None),
        ("slab rows 1-2", small_scene(128, 2, 1.0, -2.0), 16, (1, 2)),
    )):
        inst, ranges, args = stream(scene, small_cam, ts,
                                    *(window or (0, None)))
        errs.append(compare(name, inst, ranges, args, TOL_SMALL))
        bwd_errs.append(compare_bwd(name, inst, ranges, args, TOL_BWD_SMALL,
                                    seed))

    seed = 20
    for ts in (16, 32):
        for name, inst, ranges, args in stress_streams(dev, ts):
            seed += 1
            errs.append(compare(f"cull stress, {name}, tile{ts}", inst,
                                ranges, args, TOL_SMALL))
            bwd_errs.append(compare_bwd(f"cull stress, {name}, tile{ts}",
                                        inst, ranges, args, TOL_BWD_SMALL,
                                        seed))
        inst, ranges, args = stream(
            small_scene(512, 6, 1.2, -2.0),
            make_camera(width=801, height=551, device=dev), ts)
        errs.append(compare(f"unaligned 801x551 tile{ts}", inst, ranges, args,
                            TOL_SMALL))
        bwd_errs.append(compare_bwd(f"unaligned 801x551 tile{ts}", inst,
                                    ranges, args, TOL_BWD_SMALL, seed + 10))

    model = make_bound_bench_model(device=dev)
    cam = bench_camera(WIDTH, HEIGHT, device=dev)
    b_inst, b_ranges, b_args = blend_inputs(bound_bench_scene(model, 0), cam,
                                            32)
    errs.append(compare("bench stream 802x550", b_inst, b_ranges, b_args,
                        TOL_BENCH))
    bwd_errs.append(compare_bwd("bench stream 802x550", b_inst, b_ranges,
                                b_args, TOL_BWD_BENCH, 100))
    k2_plain_ms = bwd_errs[-1][2]

    lap("k1_k2_vs_plain")
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

    lap("goldens")
    # ---- 5. the serving path ------------------------------------------------
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

    lap("serving")
    # ---- 6. the training path -----------------------------------------------
    opt_cfg = OptimizationConfig()
    state = initial_state(model)
    flame_fixed = {k: v for k, v in model.flame_param.items()
                   if k not in state.flame_tr}
    check(sorted(state.flame_tr) == sorted(
        ["expr", "rotation", "neck_pose", "jaw_pose", "eyes_pose",
         "translation"]), f"FLAME trainables {sorted(state.flame_tr)}")
    lrs = lr_pytree(opt_cfg, 1e-3, state.flame_tr,
                    model.spatial_lr_scale or 1.0)
    step = make_train_step(model, opt_cfg, PipelineConfig(), WIDTH, HEIGHT,
                           model.active_sh_degree, model.num_timesteps)
    gt = torch.as_tensor(np.random.default_rng(2).random(
        (3, HEIGHT, WIDTH)).astype(np.float32), device=dev)
    flame_before = {k: v.clone() for k, v in state.flame_tr.items()}

    def train(state, i, mark=None):
        return step(state, flame_fixed, model.binding, ca, gt, bg,
                    i % model.num_timesteps, lrs, mark)

    state, first_losses, _ = train(state, 0)          # warm-up
    state, _, _ = train(state, 1)
    torch.cuda.synchronize()
    counted = {"blend_fwd": tile_blend.blend_image_cuda,
               "blend_bwd": tile_blend.blend_image_bwd_cuda}
    for fn in counted.values():
        fn.launches = 0
    step_losses = []
    t_host = time.perf_counter()
    start.record()
    for i in range(TRAIN_STEPS):
        state, losses, total = train(state, i)
        step_losses.append(losses)
    end.record()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t_host
    train_launches = {name: fn.launches for name, fn in counted.items()}
    step_ms = start.elapsed_time(end) / TRAIN_STEPS
    print(f"[train] {TRAIN_STEPS} steps, launches {train_launches}")
    for name, n in train_launches.items():
        check(n == TRAIN_STEPS,
              f"{name} launched {n} times in {TRAIN_STEPS} steps")
    for i, losses in enumerate(step_losses):
        for k, v in losses.items():
            check(bool(torch.isfinite(v)), f"step {i}: loss {k} is {v}")
    for leaf in tree_leaves({"gauss": state.params, "flame": state.flame_tr,
                             "mu": state.mu, "nu": state.nu}):
        check(bool(torch.isfinite(leaf).all()), "non-finite training state")
    state, after_losses, _ = train(state, 0)   # the loss after the 20 steps
    torch.cuda.synchronize()
    first_total = float(first_losses["total"])
    after_total = float(after_losses["total"])
    print(f"[train] timestep 0 loss: first step {first_total:.6f}, after "
          f"{TRAIN_STEPS + 2} steps {after_total:.6f} ("
          + ", ".join(f"{k} {float(v):.5f}" for k, v in after_losses.items())
          + ")")
    check(after_total < first_total, "the training loss did not fall")
    visible = state.denom > 0
    check(bool((state.grad_accum[visible] > 0).any()),
          "no visible Gaussian accumulated a screen gradient")
    print(f"[train] {int(visible.sum())} Gaussians seen, grad_accum mean "
          f"{float(state.grad_accum[visible].mean()):.4e}, max radius "
          f"{float(state.max_radii2d.max()):.0f} px")
    for k, before in flame_before.items():
        check(not torch.equal(state.flame_tr[k], before),
              f"FLAME {k} did not change")
    print(f"[train] {step_ms:.3f} ms/step (CUDA events), "
          f"{1e3 / step_ms:.1f} steps/s; host clock "
          f"{1e3 * host_s / TRAIN_STEPS:.3f} ms/step; forward-only render "
          f"{ms:.3f} ms in this call")

    phases = {}
    for i in range(2 * model.num_timesteps):
        events = [("start", torch.cuda.Event(enable_timing=True))]
        events[0][1].record()

        def mark(name):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append((name, ev))

        state, _, _ = train(state, i, mark)
        torch.cuda.synchronize()
        for (_, a), (name, b) in zip(events, events[1:]):
            phases[name] = phases.get(name, 0.0) + a.elapsed_time(b)
    phases = {k: v / (2 * model.num_timesteps) for k, v in phases.items()}
    print("[train phases] ms: " + ", ".join(f"{k} {v:.3f}" for k, v in
                                            phases.items()))

    lap("training")
    # ---- 7. the kernels at the bench shapes ---------------------------------
    width, height = b_args[1], b_args[2]
    k1_ms = cuda_ms(lambda: tile_blend.blend_image(b_inst, b_ranges, *b_args),
                    50)
    plain_ms = cuda_ms(lambda: tile_blend.blend_image_plain(
        b_inst, b_ranges, *b_args), 1)
    _, work = tile_blend.blend_image_plain(b_inst, b_ranges, *b_args,
                                           count_work=True)
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

    b_color, b_trans = tile_blend.blend_image_cuda(b_inst, b_ranges, *b_args)
    b_gc, b_gt = cotangents(b_args, 100)
    k2_ms = cuda_ms(lambda: tile_blend.blend_image_bwd_cuda(
        b_inst, b_ranges, *b_args, b_color, b_trans, b_gc, b_gt), 50)
    _, bwork = tile_blend.blend_image_bwd_plain(
        b_inst, b_ranges, *b_args, b_color, b_trans, b_gc, b_gt,
        count_work=True)
    # stream, ranges and eight image planes in; the (K, 9) gradient out
    k2_bytes = (2 * b_inst.numel() + b_ranges.numel()
                + 8 * width * height) * 4
    k2_flops = (FLOPS_PER_PAIR * bwork["pairs"]
                + FLOPS_PER_EXP_PAIR * bwork["exps"]
                + BWD_FLOPS_PER_BLENDED * bwork["blended"])
    k2_t_bytes = k2_bytes / PEAK_HBM_BYTES * 1e3
    k2_t_ops = max(k2_flops / PEAK_FP32_FLOPS,
                   bwork["exps"] / PEAK_SFU_OPS) * 1e3
    k2_bound_ms = max(k2_t_bytes, k2_t_ops)
    print(f"[K2] bench: {b_inst.shape[0]} slots, {k2_ms:.4f} ms kernel "
          f"(with the output's zero fill), {k2_plain_ms:.2f} ms plain; "
          f"work {bwork}; bytes {k2_bytes}, fp32 flops {k2_flops}; bound "
          f"{k2_bound_ms:.4f} ms (bytes {k2_t_bytes:.4f}, ops "
          f"{k2_t_ops:.4f})")

    lap("kernels_at_bench")
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    saved_env = os.environ.get("FLAME_ASSET_DIR")
    try:
        # ---- 8. training from a dataset --------------------------------------
        loop_line = loop_phase(dev, WIDTH, HEIGHT, workdir)
        print(json.dumps(dict(what="loop", **loop_line)))
        lap("loop")
        # ---- 9. offline render, reenactment, overlays, metrics, regularizers
        offline_line = offline_phase(dev, WIDTH, HEIGHT, workdir)
        print(json.dumps(dict(what="offline", **offline_line)))
        lap("offline")
    finally:
        if saved_env is None:
            os.environ.pop("FLAME_ASSET_DIR", None)
        else:
            os.environ["FLAME_ASSET_DIR"] = saved_env
        shutil.rmtree(workdir, ignore_errors=True)

    ranges_line = dict(what="ranges", **range_stats(b_ranges))
    print(json.dumps(ranges_line))
    # what the kernels walk, from the counting build of the same sources
    # (not on any timed path), beside what the pixels need (`work`)
    walked = {}
    for name, run in (
            ("blend_fwd", lambda lib: tile_blend.blend_image_cuda(
                b_inst, b_ranges, *b_args, lib=lib)),
            ("blend_bwd", lambda lib: tile_blend.blend_image_bwd_cuda(
                b_inst, b_ranges, *b_args, b_color, b_trans, b_gc, b_gt,
                lib=lib))):
        lib = kernels.load(name, COUNTING)
        read = getattr(lib, name + "_counts")
        out = (ctypes.c_ulonglong * 3)()
        check(read(out) == 0, f"{name}_counts failed")        # zeroes them
        run(lib)
        check(read(out) == 0, f"{name}_counts failed")
        walked[name] = {"cull_tests": out[0], "warp_slots_walked": out[1],
                        "pixel_evaluations": out[2]}
        check(work["blended"] <= out[2] <= work["pairs"],
              f"{name} made {out[2]} pixel evaluations; the pixels need "
              f"{work['blended']} to {work['pairs']}")
    print(json.dumps(dict(
        what="pairs", **walked, plain=work,
        whole_tile_pairs=int(b_inst.shape[0]) * b_args[3] ** 2)))

    # no single PyTorch call computes either function (a depth-sorted
    # front-to-back blend with an early stop, or its VJP), so no library_ms
    kernel_line = {"kernels": [{
        "name": "blend_fwd",
        "route": "cuda",
        "source": "gaussianavatars_torch/csrc/blend_fwd.cu",
        "replaces": "gaussianavatars_tpu/ops/blend_pallas.py:437",
        "launches": launches["blend_fwd"],
        "loop_launches": loop_line["loop_launches"]["blend_fwd"],
        "loop_iterations": LOOP_ITERATIONS,
        "offline_launches": {k: v["blend_fwd"] for k, v in
                             offline_line["launches"].items()},
        "offline_calls": {"splits": offline_line["render"]["images"],
                          "reenact": offline_line["reenact"]["images"],
                          "mesh": offline_line["mesh"]["images"],
                          "plain": REG_STEPS, "regularized": REG_STEPS},
        "max_abs_err": max(errs),
        "pixel_evaluations": walked["blend_fwd"]["pixel_evaluations"],
        "ms": k1_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
    }, {
        "name": "blend_bwd",
        "route": "cuda",
        "source": "gaussianavatars_torch/csrc/blend_bwd.cu",
        "replaces": "gaussianavatars_tpu/ops/blend_pallas.py:763",
        "launches": train_launches["blend_bwd"],
        "loop_launches": loop_line["loop_launches"]["blend_bwd"],
        "loop_iterations": LOOP_ITERATIONS,
        "offline_launches": {k: v["blend_bwd"] for k, v in
                             offline_line["launches"].items()},
        "max_abs_err": max(e[0] for e in bwd_errs),
        "max_column_rel_err": max(e[1] for e in bwd_errs),
        "pixel_evaluations": walked["blend_bwd"]["pixel_evaluations"],
        "ms": k2_ms,
        "plain_ms": k2_plain_ms,
        "bound_ms": k2_bound_ms,
        "bound_by": "bytes" if k2_t_bytes >= k2_t_ops else "operations",
        "library_ms": None,
    }]}
    lap("counting_build")
    print(json.dumps(dict(what="phase_seconds", **phase_s,
                          total=round(sum(phase_s.values()), 2))))
    print(smi)
    print(json.dumps(kernel_line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
