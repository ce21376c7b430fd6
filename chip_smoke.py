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
     ms per render, FPS and the per-stage breakdown (CUDA events), and one
     render with its frame for the wire under
     `torch.cuda.set_sync_debug_mode("warn")`: as many sync warnings as
     the tracer's `host_syncs` (`sync_counts`);
  6. the training path: the same avatar trained through `make_train_step`
     (FLAME finetuning on, L1 + D-SSIM + xyz and scale regularizers, Adam,
     densification statistics) for 2 warm-up and 20 timed steps cycling
     the 4 timesteps, with both kernels' launch counts read around the
     timed steps, finiteness and a falling loss checked, then ms per step
     and its per-phase breakdown (CUDA events), and one step's sync
     warnings against its `host_syncs`;
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
     and K2 one each per step;
 10. the quality protocols and the pipeline options (`recovery_phase`,
     `options_phase`): the bound protocol of
     `gaussianavatars_torch/examples/bound_avatar_recovery.py` at 448x400
     (256 ground-truth renders of the painted avatar, white background, SH
     2) cut in depth to 500 iterations, its val and test PSNR at iteration
     0 and at the end (both must rise); the unbound protocol of
     `synthetic_recovery.py` at 400x400 (32 renders of 20,000 SH-3
     Gaussians, the noisy point-cloud init) cut to 300 iterations (the loss
     must fall); both with K1 and K2 counted around the run (one K2 per
     iteration, one K1 per iteration and eval view); the unbound views
     written again as a COLMAP binary scene and `python -m
     gaussianavatars_torch.train -s <scene> --iterations 30` in a
     subprocess, which must start from the scene's points and write its
     PLY; then on the bench avatar one render and one train step with
     `convert_SHs_python` and with `compute_cov3D_python` against the
     default path (image max|d| <= 1e-4; for the covariance, whose
     rounding moves a few alphas across the blend's thresholds, 1e-4 on
     all but 1e-4 of the values and 2/255 on every one; gradients per leaf
     max|d| / max|default| <= 2e-4), beside the image's float32
     sensitivity (every scale one ulp larger), and one
     render with `scaling_modifier=2.0`, whose longer stream K1 matches its
     plain version on (max|d| <= 1e-3);
 11. the viewers, observability, the FPS benchmarks and JPEG views
     (`viewer_phase`): `local_viewer.LocalViewerCore` on phase 8's PLY
     (101,440 Gaussians) renders 40 orbit frames at 960x540 and 20 with
     the mesh (render and host copy timed apart), and K1 holds its plain
     version on the last frame's stream (max|d| <= 1e-3); a 20-iteration
     `training` on phase 8's dataset with a `NetworkGUI` on a free port,
     whose client (a thread) pauses it for 10 views at 802x550 and then
     asks for one view an iteration: every served frame within 1e-6 of
     `make_render_fn`'s at the same state, round trips timed, and the same
     run without a client for the ms per iteration; its tensorboard event
     file read back here (every record's CRC32C, the scalar tags at every
     log point, the eval's images and histogram); `python -m
     gaussianavatars_torch.train --profile_dir` for 10 iterations, whose
     Chrome trace must name both kernels, and the profiler's cost in
     process; `fps_benchmark_demo --point_path` (100 renders) and
     `fps_benchmark_dataset` on phase 8's model directory (50 renders a
     split), K1 counted; the JPEG fixtures of `fixtures/jpeg/` decoded by
     nvJPEG through the loader's `read_image` against PIL's pixels and the
     plain decoder's, and its ms per 802x550 view beside `read_png`'s;
     phase 10's COLMAP scene re-encoded as baseline JPEGs (`encode_jpeg`
     here: the GPU host has no encoder) and trained 30 iterations, every
     view decoded by nvJPEG in the loader's threads. `--fps-protocol` adds
     both benchmarks' reference protocol (500 renders x 3 rounds) and one
     3840x2160 demo run with its peak device memory;
 12. training across ranks and subjects (`parallel_phase`): two ranks on
     the one card over gloo (NCCL takes no two ranks on one card), spawned
     processes: 8 renders of the bench avatar at 802x550 through
     `parallel.make_sharded_render`, each rank's image against
     `make_render_fn`'s (max|d| <= 1e-5), one `make_sharded_train_step`
     with render_parallel=2 against the one-device step (every gradient
     leaf max|d| / max|single| <= 2e-4, losses 1e-5), K1 (<= 1e-3) and K2
     (<= 5e-4 per column) against their plain versions on each rank's slab
     of the bench stream, one K1 per render and one K1 and one K2 per step
     on each rank; `python -m gaussianavatars_torch.train --distributed`
     with torchrun's variables, NCCL and a world of 1 for 30 iterations on
     phase 8's dataset; `train.multisubject.MultiSubjectTrainer` with the
     bench avatars of seeds 0 and 1 in turn on one rank for 20 iterations
     (every Gaussian cloned or split at 10), each subject within 4x a solo
     run's run-to-run drift of its solo run (the gather's `index_add_` is
     not bit-deterministic on the card), its ms per iteration beside the
     solo run's, and `bench_multisubject`'s steps/s and efficiency;
 13. the sort binning (`sort_phase`, `--binning sort`) on a fresh bench
     avatar: 8 renders through `make_render_fn` with
     `PipelineConfig(binning="sort")` over the 4 timesteps, each image
     within 1e-5 of the dense image (values where an alpha flips at the
     1/255 edge are counted and held to 1e-3, at most 1e-4 of them), a
     longer stream, one K1 per render, ms per render beside the dense
     path's; one sort train step against one dense step from the same
     state (gradient leaves max|d| / max|dense| <= 2e-4, losses rtol
     1e-5, the densification statistics equal), then 2 + 10 sort steps
     with one K1 and one K2 each; K1 and K2 against their plain versions
     on the sort stream (1e-3, 5e-4 per column, K2 twice for the same
     bits), both kernels timed on the sort and the dense stream, the sort
     stream's ranges, bounds and counting-build walk (a `sort_stream`
     JSON line); `python -m gaussianavatars_torch.train --binning sort`
     for 30 iterations on phase 8's dataset; the parity tool
     (`tools/parity_vs_reference.py`: `--check_assets`, `--self_check`,
     a dense and a sort dump of phase 8's PLY and `--compare` of the
     two); `tools/diag_eval_views.py` on phase 10's bound run, every eval
     view listed, each split's mean PSNR within 1e-3 dB of phase 10's
     `evaluate_splits`, the worst triples written.
The `kernels` line is the last but one, the card's name and power limit
the line before it. The last line is {"ok": true, "device": {...}}.
Nothing here imports JAX.
"""

from __future__ import annotations

import ctypes
import hashlib
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
BOUND_ITERATIONS = 500        # phase 10: the bound protocol (of 10,000)
UNBOUND_ITERATIONS = 300      # phase 10: the unbound protocol (of 2000)
COLMAP_CLI_ITERATIONS = 30    # phase 10: `train` on the COLMAP copy
BOUND_SIZE = (448, 400)       # the bound protocol's recorded size
SYNTH_SIZE = (400, 400)       # the unbound protocol's default size
SCALING_MODIFIER = 2.0        # phase 10: the viewer's scale control
VIEWER_FRAMES = 40            # phase 11: orbit frames of the local viewer
MESH_FRAMES = 20              # phase 11: of them again with the mesh
GUI_ITERATIONS = 20           # phase 11: the observed training run
PAUSED_FRAMES = 10            # phase 11: views served while it is paused
GUI_SIZE = (802, 550)         # phase 11: the network viewer's frames
PROFILE_ITERATIONS = 10       # phase 11: `train --profile_dir`
FPS_DEMO = (100, 1)           # phase 11: renders a round, rounds
FPS_DATASET = (50, 1)
JPEG_ITERATIONS = 30          # phase 11: training on JPEG views
# phase 11: a served frame against make_render_fn's at the same state (the
# same path on the same inputs)
TOL_GUI = 1e-6
# phase 11: nvJPEG's pixels against PIL's, per fixture of fixtures/jpeg
# (levels of 255): (max, mean). nvJPEG's IDCT and chroma upsampling are not
# libjpeg's: on an NVIDIA H100 80GB HBM3 (700 W) it differed by
# max / mean 9 / 0.615 on the 4:2:0 render, 26-33 / 4.9-5.6 on the small
# subsampled fixtures (strong chroma noise, every pixel a colour edge),
# 3 / 0.506 on 4:4:4 and 1 / 0.019 on gray; each limit is that measurement
# plus 2 levels and 0.1 level.
JPEG_LIMITS = {"bench_802x550.jpg": (11, 0.72), "gray_45x29.jpg": (3, 0.12),
               "progressive_48x40.jpg": (33, 5.48),
               "restart_57x41.jpg": (35, 5.0), "rgb420_37x29.jpg": (28, 5.28),
               "rgb422_33x17.jpg": (29, 5.67), "rgb444_33x17.jpg": (5, 0.61)}
JPEG_444_MAX = JPEG_LIMITS["rgb444_33x17.jpg"][0]   # the 4:4:4 views
# phase 10, an option path's image against the default path's. Colours
# enter the blend linearly, so precomputed SH colours hold max|d| <=
# TOL_OPTION_IMAGE everywhere. A precomputed covariance rounds otherwise,
# and on the 101k avatar some alpha then lands on the other side of a
# blend threshold (the 1/255 skip, the 0.99 clamp, the early stop): such a
# flip moves its pixel by up to alpha = 1/255 times a colour difference
# (colours reach ~2), and the pixels it touches are few. So the
# covariance path holds TOL_OPTION_IMAGE on all but FLIP_SHARE of the
# image's values, and FLIP_MAX on every value.
TOL_OPTION_IMAGE = 1e-4
FLIP_SHARE = 1e-4
FLIP_MAX = 2.0 / 255.0
TOL_OPTION_GRAD = 2e-4

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


def sync_counts(fn) -> tuple:
    """(sync warnings, host_syncs, warning texts) of one call of `fn`: the
    warnings `torch.cuda.set_sync_debug_mode("warn")` raises for the host
    syncs the call makes, and the host syncs the port's tracer counts."""
    import warnings

    from gaussianavatars_torch.utils import trace

    torch.cuda.synchronize()
    trace.stop()
    tracer = trace.start()
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode("default")
    finally:
        trace.stop()
    texts = [str(w.message) for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    syncs = sum(r.counters.get(trace.HOST_SYNCS, 0)
                for r in tracer.drain())
    return len(texts), syncs, texts


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


def recovery_phase(dev, work, bound_iterations=BOUND_ITERATIONS,
                   unbound_iterations=UNBOUND_ITERATIONS,
                   cli_iterations=COLMAP_CLI_ITERATIONS,
                   bound_size=BOUND_SIZE, synth_size=SYNTH_SIZE,
                   bound_rig=None, synth_views=(28, 4), synth_gaussians=20_000):
    """Phase 10, the quality protocols of `gaussianavatars_torch/examples`
    cut in depth, under the directory `work` (see the module docstring).
    `bound_rig` (timesteps, cameras per ring) and the synthetic protocol's
    views and Gaussians cut the data for a CPU rehearsal only. Returns the
    numbers it measured; raises on any failure."""
    from gaussianavatars_torch.config import (
        ModelConfig, OptimizationConfig, PipelineConfig,
    )
    from gaussianavatars_torch.data.scene import Scene
    from gaussianavatars_torch.examples import bound_avatar_recovery as bound
    from gaussianavatars_torch.examples import steady_rate
    from gaussianavatars_torch.examples import synthetic_recovery as synth
    from gaussianavatars_torch.models.flame_gaussians import (
        FlameGaussianModel,
    )
    from gaussianavatars_torch.ops import tile_blend
    from gaussianavatars_torch.train import loop
    from gaussianavatars_torch.utils.ply import read_ply

    k1, k2 = tile_blend.blend_image_cuda, tile_blend.blend_image_bwd_cuda

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def psnrs(metrics):
        return {split: round(m["psnr"], 4) for split, m in metrics.items()}

    out = {}
    # ---- (a) the bound protocol at 448x400 ----------------------------------
    t0 = time.perf_counter()
    root = os.path.join(work, "bound")
    data, assets = os.path.join(root, "data"), os.path.join(root, "assets")
    rig = {} if bound_rig is None else dict(t_steps=bound_rig[0],
                                            n_cams=bound_rig[1])
    bound.write_dataset(data, assets, *bound_size, **rig)
    os.environ["FLAME_ASSET_DIR"] = assets
    cfg = ModelConfig(source_path=data, model_path=os.path.join(root, "out"),
                      bind_to_mesh=True, eval=True, sh_degree=2,
                      white_background=True, not_finetune_flame_params=True)
    pipe = PipelineConfig()
    os.makedirs(cfg.model_path, exist_ok=True)
    gt_model = FlameGaussianModel.from_assets(cfg.sh_degree, device=dev)
    scene = Scene(cfg, gt_model)
    bound.paint_gt_model(gt_model)
    n_images = bound.render_gt_images(gt_model, scene, cfg, pipe, dev)
    sync()
    gt_s = time.perf_counter() - t0
    n_eval = len(scene.get_val_cameras()) + len(scene.get_test_cameras())
    # iteration 0: the training's own init, scored on the same splits
    init = FlameGaussianModel.from_assets(cfg.sh_degree, device=dev,
                                          not_finetune_flame_params=True)
    init_scene = Scene(cfg, init)
    state0 = loop.initial_state(init)
    first = loop.evaluate_splits(init, init_scene, cfg, pipe, state0, {
        k: v for k, v in init.flame_param.items() if k not in state0.flame_tr})
    it = bound_iterations
    opt = OptimizationConfig(
        iterations=it, densify_from_iter=400, densify_until_iter=int(0.7 * it),
        densification_interval=300, opacity_reset_interval=10 * it,
        position_lr_max_steps=it)
    sync()
    k1.launches = k2.launches = 0
    t0 = time.perf_counter()
    model, _, info = loop.training(cfg, opt, pipe, testing_iterations={it},
                                   saving_iterations={it}, device=dev)
    sync()
    wall = time.perf_counter() - t0
    launches = {"bound": {"blend_fwd": k1.launches, "blend_bwd": k2.launches}}
    last = info["metrics"][it]
    print(f"[recovery] bound protocol at {bound_size[0]}x{bound_size[1]}: "
          f"{n_images} ground-truth renders in {gt_s:.2f} s; {it} iterations "
          f"in {wall:.2f} s ({1e3 * wall / it:.2f} ms/iteration), "
          f"{model.num_gaussians} Gaussians; PSNR at iteration 0 "
          f"{psnrs(first)}, at {it} {psnrs(last)}; launches "
          f"{launches['bound']}")
    check(launches["bound"] == {"blend_fwd": it + n_eval, "blend_bwd": it},
          f"the bound protocol launched {launches['bound']} in {it} "
          f"iterations and {n_eval} eval views")
    for split in ("val", "test"):
        check(last[split]["psnr"] > first[split]["psnr"],
              f"bound {split} PSNR did not rise: {first[split]['psnr']} -> "
              f"{last[split]['psnr']}")
    rate = steady_rate(info["timeline"])
    out["bound"] = dict(
        size=list(bound_size), images=n_images, gt_s=round(gt_s, 2),
        iterations=it, wall_s=round(wall, 2),
        steady_ms_per_iteration=round(1e3 / rate, 3) if rate else None,
        n_gaussians=model.num_gaussians, eval_views=n_eval,
        psnr_first=psnrs(first), psnr_last=psnrs(last),
        ssim_last={k: round(m["ssim"], 4) for k, m in last.items()})

    # ---- (b) the unbound protocol at 400x400 and its COLMAP copy ------------
    root = os.path.join(work, "synthetic")
    data = os.path.join(root, "data")
    w, h = synth_size
    n_train, n_test = synth_views
    t0 = time.perf_counter()
    gt = synth.make_gt_scene(n=synth_gaussians, device=dev)
    synth.render_dataset(data, gt, w, h, n_train=n_train, n_test=n_test)
    xyz, rgb = synth.write_noisy_init(data, gt)
    sync()
    gt_s = time.perf_counter() - t0
    cfg = ModelConfig(source_path=data, model_path=os.path.join(root, "out"),
                      bind_to_mesh=False, eval=True, sh_degree=3,
                      white_background=True)
    it = unbound_iterations
    opt = OptimizationConfig(
        iterations=it, densify_from_iter=500,
        densify_until_iter=int(0.75 * it), densification_interval=300,
        opacity_reset_interval=10 * it, position_lr_max_steps=it)
    sync()
    k1.launches = k2.launches = 0
    t0 = time.perf_counter()
    model, _, info = loop.training(cfg, opt, PipelineConfig(),
                                   testing_iterations={it}, device=dev)
    sync()
    wall = time.perf_counter() - t0
    launches["unbound"] = {"blend_fwd": k1.launches,
                           "blend_bwd": k2.launches}
    hist = info["history"]
    test = info["metrics"][it]["test"]
    print(f"[recovery] unbound protocol at {w}x{h}: {n_train + n_test} "
          f"ground-truth renders of {synth_gaussians} Gaussians in "
          f"{gt_s:.2f} s; {it} iterations in {wall:.2f} s from "
          f"{len(xyz)} points, EMA loss {hist[0][1]:.5f} -> {hist[-1][1]:.5f}"
          f", test PSNR {test['psnr']:.4f}; launches {launches['unbound']}")
    check(launches["unbound"] == {"blend_fwd": it + n_test, "blend_bwd": it},
          f"the unbound protocol launched {launches['unbound']}")
    check(hist[-1][1] < hist[0][1], "the unbound loss did not fall")
    check(np.isfinite(test["psnr"]), f"unbound test PSNR {test['psnr']}")
    rate = steady_rate(info["timeline"])
    out["unbound"] = dict(
        size=[w, h], images=n_train + n_test, gt_s=round(gt_s, 2),
        iterations=it, wall_s=round(wall, 2),
        steady_ms_per_iteration=round(1e3 / rate, 3) if rate else None,
        points=len(xyz), n_gaussians=model.num_gaussians, eval_views=n_test,
        ema_loss=[round(hist[0][1], 6), round(hist[-1][1], 6)],
        test_psnr=round(test["psnr"], 4))

    colmap = synth.write_colmap_scene(data, os.path.join(root, "colmap"), w,
                                      h, xyz, rgb, n_train=n_train,
                                      n_test=n_test)
    model_dir = os.path.join(root, "colmap_out")
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "gaussianavatars_torch.train", "-s", colmap,
         "-m", model_dir, "--iterations", str(cli_iterations), "--device",
         dev.type], cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
        capture_output=True, text=True, timeout=600)
    cli_s = time.perf_counter() - t0
    check(res.returncode == 0,
          f"train on the COLMAP scene failed: {res.stderr[-2000:]}")
    ply = read_ply(os.path.join(model_dir, "point_cloud",
                                f"iteration_{cli_iterations}",
                                "point_cloud.ply"))
    start = read_ply(os.path.join(model_dir, "input.ply"))
    start_xyz = np.stack([start["x"], start["y"], start["z"]], axis=1)
    check(len(ply["x"]) == len(xyz),
          f"the COLMAP run ended with {len(ply['x'])} Gaussians, not its "
          f"{len(xyz)} points")
    check(np.array_equal(start_xyz, np.asarray(xyz, np.float32)),
          "the COLMAP run did not start from the scene's points")
    print(f"[recovery] python -m gaussianavatars_torch.train on the COLMAP "
          f"copy ({n_train + n_test} views, {len(xyz)} points): "
          f"{cli_iterations} iterations in {cli_s:.2f} s, PLY of "
          f"{len(ply['x'])} Gaussians")
    out["colmap_cli"] = dict(iterations=cli_iterations, s=round(cli_s, 2),
                             points=len(xyz), n_gaussians=len(ply["x"]))
    out["launches"] = launches
    return out


def options_phase(dev, model, cam, width, height):
    """Phase 10, the pipeline options on the bench avatar: one render and
    one train step with `convert_SHs_python` and with
    `compute_cov3D_python` against the default path (the image gates
    TOL_OPTION_IMAGE, FLIP_SHARE and FLIP_MAX above; gradients per leaf
    max|d| / max|default| <= TOL_OPTION_GRAD), beside the image's float32 sensitivity (the default
    path with every scale one ulp larger), and one render with
    `scaling_modifier`. Returns the numbers and the (stream, ranges, args)
    of the scaled render for the K1 comparison; raises on any failure."""
    from gaussianavatars_torch.benchmark import (
        blend_inputs, bound_bench_scene,
    )
    from gaussianavatars_torch.config import (
        OptimizationConfig, PipelineConfig,
    )
    from gaussianavatars_torch.ops import tile_blend
    from gaussianavatars_torch.train import loop, optim

    ca = loop.camera_arrays(cam)
    bg = torch.ones(3, device=dev)
    gt = torch.as_tensor(np.random.default_rng(5).random(
        (3, height, width)).astype(np.float32), device=dev)
    opt_cfg = OptimizationConfig()
    variants = {"default": {},
                "convert_SHs_python": dict(convert_SHs_python=True),
                "compute_cov3D_python": dict(compute_cov3D_python=True)}
    images, moments = {}, {}
    for name, opts in variants.items():
        pipe = PipelineConfig(**opts)
        render = loop.make_render_fn(model, pipe, width, height,
                                     model.active_sh_degree)
        images[name] = render(model.params, model.flame_param, model.binding,
                              ca, bg, 0).image
        # a copy of the parameters and zero Adam moments: after one step
        # the first moment is (1 - B1) times the gradient
        state = loop.initial_state(model)
        state = state._replace(
            params=type(state.params)(*[p.clone() for p in state.params]),
            flame_tr={k: v.clone() for k, v in state.flame_tr.items()},
            max_radii2d=state.max_radii2d.clone(),
            grad_accum=state.grad_accum.clone(), denom=state.denom.clone())
        state = state._replace(**dict(zip(("mu", "nu", "count"), optim.init(
            {"gauss": state.params, "flame": state.flame_tr}))))
        step = loop.make_train_step(model, opt_cfg, pipe, width, height,
                                    model.active_sh_degree,
                                    model.num_timesteps)
        fixed = {k: v for k, v in model.flame_param.items()
                 if k not in state.flame_tr}
        state, _, _ = step(state, fixed, model.binding, ca, gt, bg, 0,
                           loop.lr_pytree(opt_cfg, 1e-3, state.flame_tr, 1.0))
        moments[name] = dict(zip(
            list(type(state.params)._fields) + list(state.flame_tr),
            list(state.mu["gauss"]) + list(state.mu["flame"].values())))
    render = loop.make_render_fn(model, PipelineConfig(), width, height,
                                 model.active_sh_degree)
    images["one ulp larger scales"] = render(
        model.params, model.flame_param, model.binding, ca, bg, 0,
        scaling_modifier=1.0 + 2.0 ** -23).image

    def differ(name):
        d = (images[name] - images["default"]).abs()
        return float(d.max()), float((d > TOL_OPTION_IMAGE).float().mean())

    err, share = differ("one ulp larger scales")
    print(f"[options] float32 sensitivity: every scale one ulp larger moves "
          f"the image by max|d| {err:.3e}, {share:.2e} of its values by "
          f"more than {TOL_OPTION_IMAGE:.0e}")
    out = {"ulp_scale_image": dict(max_abs=err, share_above=share)}
    for name in variants:
        if name == "default":
            continue
        err, share = differ(name)
        rel = {leaf: float((g - moments["default"][leaf]).abs().max()
                           / moments["default"][leaf].abs().max().clamp(
                               min=1e-30))
               for leaf, g in moments[name].items()}
        worst = max(rel, key=rel.get)
        flips = name == "compute_cov3D_python"
        print(f"[options] {name}: image max|d| {err:.3e}, {share:.2e} of its "
              f"values above {TOL_OPTION_IMAGE:.0e} (limits "
              + (f"{FLIP_MAX:.2e}, {FLIP_SHARE:.0e}" if flips else
                 f"{TOL_OPTION_IMAGE:.0e}, 0")
              + f"); gradients, worst leaf {worst} {rel[worst]:.3e} (limit "
              f"{TOL_OPTION_GRAD:.0e})")
        check(err <= (FLIP_MAX if flips else TOL_OPTION_IMAGE),
              f"{name}: image max|d| {err}")
        check(share <= (FLIP_SHARE if flips else 0.0),
              f"{name}: {share} of the image above {TOL_OPTION_IMAGE}")
        check(rel[worst] <= TOL_OPTION_GRAD,
              f"{name}: gradient of {worst} off by {rel[worst]}")
        out[name] = dict(image_max_abs=err, image_share_above=share,
                         grad_max_rel=rel[worst], grad_worst_leaf=worst)

    k1 = tile_blend.blend_image_cuda
    k1.launches = 0
    scaled = render(model.params, model.flame_param, model.binding, ca, bg, 0,
                    scaling_modifier=SCALING_MODIFIER)
    check(k1.launches == 1, f"the scaled render launched K1 {k1.launches}")
    plain = render(model.params, model.flame_param, model.binding, ca, bg, 0)
    scene = bound_bench_scene(model, 0)
    stream = blend_inputs(dict(scene, scales=scene["scales"]
                               * SCALING_MODIFIER), cam, 32)
    check(stream[0].shape[0] == scaled.instance_total,
          f"the scaled stream has {stream[0].shape[0]} slots, the render "
          f"{scaled.instance_total}")
    check(scaled.instance_total > plain.instance_total,
          "scaling_modifier did not lengthen the stream")
    print(f"[options] scaling_modifier {SCALING_MODIFIER}: "
          f"{scaled.instance_total} instances against "
          f"{plain.instance_total}")
    out["scaling_modifier"] = dict(value=SCALING_MODIFIER,
                                   instances=scaled.instance_total,
                                   default_instances=plain.instance_total)
    return out, stream


def crc32c_bitwise(data: bytes) -> int:
    """CRC-32C computed bit by bit (independent of the port's table)."""
    crc = 0xFFFFFFFF
    for b in data:
        crc ^= b
        for _ in range(8):
            crc = (crc >> 1) ^ (0x82F63B78 & -(crc & 1))
    return crc ^ 0xFFFFFFFF


def _masked(crc: int) -> int:
    return ((((crc >> 15) | (crc << 17)) & 0xFFFFFFFF) + 0xA282EAD8) \
        & 0xFFFFFFFF


def _proto_fields(buf: bytes):
    """(field number, wire type, value) of a protobuf message."""
    pos, out = 0, []

    def varint():
        nonlocal pos
        shift = value = 0
        while True:
            b = buf[pos]
            pos += 1
            value |= (b & 0x7F) << shift
            shift += 7
            if b < 0x80:
                return value

    while pos < len(buf):
        key = varint()
        field, wire = key >> 3, key & 7
        if wire == 0:
            out.append((field, wire, varint()))
        elif wire == 1:
            out.append((field, wire, buf[pos:pos + 8]))
            pos += 8
        elif wire == 5:
            out.append((field, wire, buf[pos:pos + 4]))
            pos += 4
        elif wire == 2:
            n = varint()
            out.append((field, wire, buf[pos:pos + n]))
            pos += n
        else:
            raise SmokeFailure(f"protobuf wire type {wire}")
    return out


def event_file_steps(path: str) -> dict:
    """{tag: [steps]} of a tensorboard event file, every record's two
    masked CRC32Cs checked here; '<version>' holds the first record's
    file_version."""
    with open(path, "rb") as f:
        buf = f.read()
    pos, tags, first = 0, {}, True
    while pos < len(buf):
        header = buf[pos:pos + 8]
        (length,) = np.frombuffer(header, "<u8")
        length = int(length)
        (crc,) = np.frombuffer(buf[pos + 8:pos + 12], "<u4")
        check(int(crc) == _masked(crc32c_bitwise(header)),
              f"{path}: bad length CRC at byte {pos}")
        data = buf[pos + 12:pos + 12 + length]
        (crc,) = np.frombuffer(buf[pos + 12 + length:pos + 16 + length],
                               "<u4")
        check(int(crc) == _masked(crc32c_bitwise(data)),
              f"{path}: bad data CRC at byte {pos}")
        pos += 16 + length
        fields = _proto_fields(data)
        if first:
            tags["<version>"] = [v.decode() for f, _, v in fields if f == 3]
            first = False
            continue
        step = next((v for f, _, v in fields if f == 2), 0)
        for f, _, summary in fields:
            if f != 5:
                continue
            for vf, _, value in _proto_fields(summary):
                tag = next(v for g, _, v in _proto_fields(value) if g == 1)
                tags.setdefault(tag.decode(), []).append(step)
    return tags


# JPEG baseline encoding for the card's JPEG views (the GPU host has no
# encoder): 4:4:4 YCbCr, the standard (Annex K) quantization tables scaled
# by quality as libjpeg scales them, one interleaved scan, and Huffman
# tables of fixed-length codes (4 bits for the 12 DC categories, 8 bits
# for the 162 AC symbols), which any decoder reads from the file.
_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
_Q_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
_Q_CHROMA = np.full(64, 99)
_Q_CHROMA[[0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 24, 25]] = [
    17, 18, 24, 47, 18, 21, 26, 66, 24, 26, 56, 47, 66]
_AC_SYMBOLS = [0x00, 0xF0] + [(r << 4) | s for r in range(16)
                              for s in range(1, 11)]


def encode_jpeg(rgb: np.ndarray, quality: int = 90) -> bytes:
    """uint8 [H, W, 3] -> baseline JPEG bytes (see the notes above)."""
    h, w, _ = rgb.shape
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    qts = [np.clip((q * scale + 50) // 100, 1, 255) for q in
           (_Q_LUMA, _Q_CHROMA)]
    x = rgb.astype(np.float64)
    ycc = np.stack([
        0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2],
        -0.168736 * x[..., 0] - 0.331264 * x[..., 1] + 0.5 * x[..., 2] + 128,
        0.5 * x[..., 0] - 0.418688 * x[..., 1] - 0.081312 * x[..., 2] + 128,
    ]) - 128.0
    ph, pw = -(-h // 8) * 8, -(-w // 8) * 8
    ycc = np.pad(ycc, ((0, 0), (0, ph - h), (0, pw - w)), mode="edge")
    blocks = ycc.reshape(3, ph // 8, 8, pw // 8, 8).transpose(1, 3, 0, 2, 4)
    k = np.arange(8)
    dct = np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16) * 0.5
    dct[0] /= np.sqrt(2.0)
    coef = dct @ blocks @ dct.T                  # [by, bx, 3, 8, 8]
    coef = coef.reshape(-1, 3, 64)
    q = np.stack([qts[0], qts[1], qts[1]])        # natural order
    quant = np.round(coef / q).astype(np.int64)[:, :, _ZIGZAG]
    quant = quant.reshape(-1, 64)                 # blocks in MCU order
    comp = np.tile(np.arange(3), quant.shape[0] // 3)
    dc = quant[:, 0].copy()
    for c in range(3):
        dc[comp == c] = np.diff(np.concatenate([[0], dc[comp == c]]))

    def size_and_bits(v):
        s = np.frexp(np.abs(v).astype(np.float64))[1].astype(np.int64)
        return s, np.where(v < 0, v + (1 << s) - 1, v)

    ac_code = np.zeros(256, np.int64)
    ac_code[_AC_SYMBOLS] = np.arange(len(_AC_SYMBOLS))
    keys, values, lengths = [], [], []
    nb = quant.shape[0]
    s, bits = size_and_bits(dc)
    keys.append(np.arange(nb) * 1000)
    values.append((s << s) | bits)               # 4-bit code = category
    lengths.append(4 + s)
    blk, kk = np.nonzero(quant[:, 1:])
    kk = kk + 1
    prev = np.zeros_like(kk)
    same = np.concatenate([[False], blk[1:] == blk[:-1]])
    prev[same] = kk[:-1][same[1:]]
    run = kk - prev - 1
    v = quant[blk, kk]
    s, bits = size_and_bits(v)
    for z in range(3):                            # up to three ZRLs
        zrl = run >= 16 * (z + 1)
        keys.append(blk[zrl] * 1000 + kk[zrl] * 10 + z)
        values.append(np.full(int(zrl.sum()), ac_code[0xF0]))
        lengths.append(np.full(int(zrl.sum()), 8))
    sym = ((run % 16) << 4) | s
    keys.append(blk * 1000 + kk * 10 + 5)
    values.append((ac_code[sym] << s) | bits)
    lengths.append(8 + s)
    last = np.zeros(nb, np.int64)
    np.maximum.at(last, blk, kk)                  # the last nonzero k
    eob = last < 63
    keys.append(np.flatnonzero(eob) * 1000 + 999)
    values.append(np.full(int(eob.sum()), ac_code[0x00]))
    lengths.append(np.full(int(eob.sum()), 8))
    order = np.argsort(np.concatenate(keys), kind="stable")
    values = np.concatenate(values)[order]
    lengths = np.concatenate(lengths)[order]
    item = np.repeat(np.arange(len(values)), lengths)
    within = np.arange(len(item)) - np.repeat(np.cumsum(lengths) - lengths,
                                              lengths)
    stream = (values[item] >> (lengths[item] - 1 - within)) & 1
    stream = np.concatenate([stream, np.ones((-len(stream)) % 8, np.int64)])
    scan = np.packbits(stream.astype(np.uint8)).tobytes().replace(
        b"\xff", b"\xff\x00")

    def segment(marker, payload):
        return bytes([0xFF, marker]) + (len(payload) + 2).to_bytes(
            2, "big") + payload

    dqt = b"".join(bytes([i]) + bytes(qt[_ZIGZAG].astype(np.uint8))
                   for i, qt in enumerate(qts))
    dht = (bytes([0x00]) + bytes([0, 0, 0, 12] + [0] * 12) + bytes(range(12))
           + bytes([0x10]) + bytes([0] * 7 + [len(_AC_SYMBOLS)] + [0] * 8)
           + bytes(_AC_SYMBOLS))
    sof = bytes([8]) + h.to_bytes(2, "big") + w.to_bytes(2, "big") + bytes(
        [3, 1, 0x11, 0, 2, 0x11, 1, 3, 0x11, 1])
    sos = bytes([3, 1, 0x00, 2, 0x00, 3, 0x00, 0, 63, 0])
    return (b"\xff\xd8" + segment(0xDB, dqt) + segment(0xC0, sof)
            + segment(0xC4, dht) + segment(0xDA, sos) + scan + b"\xff\xd9")


class TimedWriter:
    """A tensorboard writer whose calls are timed: `seconds` {method:
    seconds}, `calls` {method: count}."""

    def __init__(self, writer):
        self.writer = writer
        self.seconds, self.calls = {}, {}

    def __getattr__(self, name):
        fn = getattr(self.writer, name)

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.seconds[name] = (self.seconds.get(name, 0.0)
                                      + time.perf_counter() - t0)
                self.calls[name] = self.calls.get(name, 0) + 1

        return timed


def _steady_ms(timeline) -> float:
    """ms per iteration from the second logged iteration to the last."""
    (i0, t0), (i1, t1) = timeline[1], timeline[-1]
    return 1e3 * (t1 - t0) / max(i1 - i0, 1)


def viewer_phase(dev, work, frames=VIEWER_FRAMES, mesh_frames=MESH_FRAMES,
                 gui_iterations=GUI_ITERATIONS, paused_frames=PAUSED_FRAMES,
                 gui_size=GUI_SIZE,
                 profile_iterations=PROFILE_ITERATIONS,
                 fps_demo=FPS_DEMO, fps_dataset=FPS_DATASET,
                 jpeg_iterations=JPEG_ITERATIONS, viewer_size=(960, 540),
                 protocol=False):
    """Phase 11: the avatar served to the viewers, observed and timed (see
    the module docstring), on phase 8's model directory (`<work>/io`) and
    dataset (`<work>/data`) and phase 10's COLMAP scene
    (`<work>/synthetic/colmap`). `fps_demo` and `fps_dataset` are (renders
    a round, rounds); `protocol` adds the reference protocol (500 renders x
    3 rounds) of both benchmarks and one 3840x2160 demo run. Returns the
    numbers it measured, with K1's max|d| on the viewer's stream as
    `k1_err`; raises on any failure."""
    import math
    import threading

    from gaussianavatars_torch import fps_benchmark_dataset
    from gaussianavatars_torch import fps_benchmark_demo
    from gaussianavatars_torch.benchmark import (
        blend_inputs, bound_bench_scene,
    )
    from gaussianavatars_torch.config import (
        ModelConfig, OptimizationConfig, PipelineConfig,
    )
    from gaussianavatars_torch.data import colmap, loader
    from gaussianavatars_torch.local_viewer import LocalViewerCore
    from gaussianavatars_torch.ops import tile_blend
    from gaussianavatars_torch.train import loop
    from gaussianavatars_torch.utils.jpeg import read_jpeg
    from gaussianavatars_torch.utils.nvjpeg import NvJpegDecoder
    from gaussianavatars_torch.utils.png import read_png, write_png
    from gaussianavatars_torch.utils.system import profile_trace
    from gaussianavatars_torch.utils.tensorboard import SummaryWriter
    from gaussianavatars_torch.viewer.network_gui import NetworkGUI
    from gaussianavatars_torch.viewer.orbit_camera import OrbitCamera
    from gaussianavatars_torch.viewer.remote_client import (
        RemoteRenderClient, ViewRequest,
    )

    k1, k2 = tile_blend.blend_image_cuda, tile_blend.blend_image_bwd_cuda

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def count():
        return {"blend_fwd": k1.launches, "blend_bwd": k2.launches}

    def reset():
        k1.launches = k2.launches = 0

    out, launches = {}, {}
    io_dir, data = os.path.join(work, "io"), os.path.join(work, "data")
    ply = os.path.join(io_dir, "point_cloud", "iteration_1",
                       "point_cloud.ply")

    # ---- (a) the local viewer at its default size ---------------------------
    t0 = time.perf_counter()
    core = LocalViewerCore(ply, width=viewer_size[0], height=viewer_size[1],
                           device=dev)
    load_s = time.perf_counter() - t0
    n_t = core.model.num_timesteps
    core.render_tensor()
    sync()

    def orbit(i):
        core.cam.orbit_y(2 * math.pi / frames)
        core.timestep = i % n_t

    reset()
    t0 = time.perf_counter()
    for i in range(frames):
        orbit(i)
        img = core.render_tensor()
    sync()
    render_ms = 1e3 * (time.perf_counter() - t0) / frames
    t0 = time.perf_counter()
    for _ in range(frames):
        host = img.cpu()
    copy_ms = 1e3 * (time.perf_counter() - t0) / frames
    t0 = time.perf_counter()
    for i in range(mesh_frames):
        orbit(i)
        meshed = core.render_tensor(show_mesh=True)
    sync()
    mesh_ms = 1e3 * (time.perf_counter() - t0) / mesh_frames
    launches["viewer"] = count()
    check(launches["viewer"] == {"blend_fwd": frames + mesh_frames,
                                 "blend_bwd": 0},
          f"the viewer launched {launches['viewer']} for "
          f"{frames + mesh_frames} frames")
    check(tuple(host.shape) == (3, core.height, core.width),
          f"viewer frame {tuple(host.shape)}")
    check(bool(torch.isfinite(host).all()), "non-finite viewer frame")
    covered = float((host < 0.99).any(0).float().mean())
    check(covered > 0.01, f"the viewer's frame is blank ({covered})")
    check(float((meshed - core.render_tensor()).abs().max()) > 0.05,
          "the mesh overlay changed nothing")
    # K1 against its plain version on the last frame's stream
    inst, ranges, args = blend_inputs(
        bound_bench_scene(core.model, core.timestep),
        core.camera().to_params(device=dev), core.pipe.tile_size)
    kout = tile_blend.blend_image(inst, ranges, *args)
    sync()
    ref = tile_blend.blend_image_plain(inst, ranges, *args)
    k1_err = max(float((kout[0] - ref[0]).abs().max()),
                 float((kout[1] - ref[1]).abs().max()))
    print(f"[viewer] LocalViewerCore: {core.model.num_gaussians} Gaussians "
          f"loaded in {load_s:.2f} s; {frames} orbit frames at "
          f"{core.width}x{core.height}: render {render_ms:.3f} ms/frame, "
          f"copy to the host {copy_ms:.3f} ms/frame; with the mesh "
          f"{mesh_ms:.3f} ms/frame; covered {covered:.3f}; launches "
          f"{launches['viewer']}; K1 vs plain on the frame's stream "
          f"({inst.shape[0]} instances) max|d| {k1_err:.3e} (limit "
          f"{TOL_BENCH:.0e})")
    check(k1_err <= TOL_BENCH, f"K1 on the viewer stream: max|d| {k1_err}")
    out["local"] = dict(size=[core.width, core.height], frames=frames,
                        mesh_frames=mesh_frames, load_s=round(load_s, 3),
                        render_ms=round(render_ms, 3),
                        copy_ms=round(copy_ms, 3),
                        mesh_ms=round(mesh_ms, 3),
                        instances=int(inst.shape[0]), k1_max_abs_err=k1_err)
    del core, inst, ranges, kout, ref

    # ---- (b) the network viewer in training, tensorboard ----------------------
    n_eval = 0
    for split in ("val", "test"):
        with open(os.path.join(data, f"transforms_{split}.json")) as f:
            n_eval += len(json.load(f)["frames"])
    cfg = dict(source_path=data, bind_to_mesh=True, eval=True, sh_degree=3)
    gw, gh = gui_size
    orig_poll = loop.gui_poll

    def observed_run(name, iterations, connect):
        """`training` with a listening NetworkGUI and a timed tensorboard
        writer; with `connect`, a client pauses it at the first poll for
        `paused_frames` views, then asks for one view an iteration and
        lets go at the end. Every served frame is held against
        make_render_fn's at the same state."""
        run_dir = os.path.join(work, name)
        server = NetworkGUI(port=0)
        server.init()
        served = dict(cams=[], images=[], frames=0, max_err=0.0)
        receive, send = server.receive, server.send

        def recording_receive():
            cam, msg = receive()
            if cam is not None:
                served["cams"].append(cam)
            return cam, msg

        def recording_send(image, stats):
            if image is not None:
                served["images"].append(image.detach().clone())
                served["frames"] += 1
            send(image, stats)

        server.receive, server.send = recording_receive, recording_send
        ref_fns = {}

        def checked_poll(gui, model, state, flame_fixed, pipe_cfg,
                         iteration, total, fns):
            orig_poll(gui, model, state, flame_fixed, pipe_cfg, iteration,
                      total, fns)
            before = k1.launches
            for cam, img in zip(served["cams"], served["images"]):
                key = (cam.width, cam.height)
                if key not in ref_fns:
                    ref_fns[key] = loop.make_render_fn(
                        model, pipe_cfg, cam.width, cam.height,
                        model.active_sh_degree)
                ref = ref_fns[key](
                    state.params, {**flame_fixed, **state.flame_tr},
                    model.binding,
                    loop.camera_arrays(cam.to_params(device=dev)),
                    torch.ones(3, device=dev), int(cam.timestep)).image
                served["max_err"] = max(served["max_err"], float(
                    (img - ref.clamp(0.0, 1.0)).abs().max()))
            served["cams"].clear()
            served["images"].clear()
            k1.launches = before        # the references are not the path's

        res, thread = {}, None
        if connect:
            client = RemoteRenderClient(port=server.port, timeout=300.0)
            check(client.connect(retries=20, wait=0.1),
                  "the viewer client did not connect")

            def client_run():
                cam = OrbitCamera(gw, gh, r=1.0, fovy=20.0,
                                  convention="opengl", save_path="")
                res["rtt_paused"], res["rtt_training"] = [], []
                try:
                    for i in range(paused_frames + iterations):
                        cam.orbit_y(2 * math.pi / 16)
                        req = ViewRequest(
                            width=gw, height=gh,
                            fovx=math.radians(cam.fovx),
                            fovy=math.radians(cam.fovy), znear=cam.znear,
                            zfar=cam.zfar,
                            world_view_transform=cam.world_view_transform,
                            full_proj_transform=cam.full_proj_transform,
                            timestep=i % res.get("timesteps", 1),
                            do_training=i >= paused_frames)
                        t0 = time.perf_counter()
                        img, stats = client.request_view(req)
                        res["rtt_paused" if i < paused_frames
                            else "rtt_training"].append(
                                time.perf_counter() - t0)
                        res["timesteps"] = stats["num_timesteps"]
                        res["stats"] = stats
                        res["shape"] = img.shape
                    client._send_json({"resolution_x": 0,
                                       "resolution_y": 0,
                                       "do_training": True,
                                       "keep_alive": False})
                except Exception as exc:   # reported by the main thread
                    res["error"] = repr(exc)
                finally:
                    client.close()

            thread = threading.Thread(target=client_run, daemon=True)
            thread.start()
        tb = TimedWriter(SummaryWriter(run_dir))
        loop.gui_poll = checked_poll
        try:
            reset()
            sync()
            t0 = time.perf_counter()
            model, _, info = loop.training(
                ModelConfig(model_path=run_dir, **cfg),
                OptimizationConfig(iterations=iterations,
                                   position_lr_max_steps=iterations),
                PipelineConfig(), testing_iterations={iterations},
                log_every=1, tb_writer=tb, gui=server, device=dev)
            sync()
            wall = time.perf_counter() - t0
        finally:
            loop.gui_poll = orig_poll
            server.close()
            tb.close()
        if thread is not None:
            thread.join(300)
            check(not thread.is_alive(), "the viewer client hung")
            check("error" not in res, f"viewer client: {res.get('error')}")
        return dict(launches=count(), served=served, client=res, wall=wall,
                    info=info, tb=tb, model=model, run_dir=run_dir)

    con = observed_run("gui_run", gui_iterations, True)
    alone = observed_run("gui_alone", gui_iterations, False)
    frames_served = con["served"]["frames"]
    launches["gui"] = con["launches"]
    check(frames_served == paused_frames + gui_iterations,
          f"{frames_served} frames served")
    check(con["client"]["shape"] == (gh, gw, 3),
          f"GUI frame {con['client']['shape']}")
    check(con["client"]["stats"] == {
        "num_timesteps": con["model"].num_timesteps,
        "num_points": con["model"].num_gaussians},
        f"GUI stats {con['client']['stats']}")
    check(launches["gui"] == {
        "blend_fwd": gui_iterations + frames_served + n_eval,
        "blend_bwd": gui_iterations},
        f"the observed run launched {launches['gui']} ({gui_iterations} "
        f"iterations, {frames_served} frames, {n_eval} eval views)")
    check(alone["launches"] == {"blend_fwd": gui_iterations + n_eval,
                                "blend_bwd": gui_iterations},
          f"the run without a client launched {alone['launches']}")
    gui_err = con["served"]["max_err"]
    check(gui_err <= TOL_GUI, f"GUI frames differ from make_render_fn's "
                              f"by {gui_err}")
    rtt_paused = 1e3 * float(np.mean(con["client"]["rtt_paused"]))
    rtt_training = 1e3 * float(np.mean(con["client"]["rtt_training"]))
    ms_client = _steady_ms(con["info"]["timeline"])
    ms_alone = _steady_ms(alone["info"]["timeline"])
    # the event file: every record's CRC, the tags at every log point
    (events,) = [f for f in os.listdir(con["run_dir"])
                 if f.startswith("events.out.tfevents.")]
    tags = event_file_steps(os.path.join(con["run_dir"], events))
    check(tags["<version>"] == ["brain.Event:2"], f"version {tags}")
    every = list(range(1, gui_iterations + 1))
    for tag in ("total_points", "train_loss_patches/total_loss",
                "train_loss_patches/l1_loss"):
        check(tags.get(tag) == every, f"tag {tag} at steps {tags.get(tag)}")
    for tag in ("val/loss_viewpoint_-_psnr", "test/loss_viewpoint_-_psnr",
                "val_0/render", "val_0/error", "scene/opacity_histogram"):
        check(tags.get(tag) == [gui_iterations],
              f"tag {tag} at steps {tags.get(tag)}")
    tb = con["tb"]
    scalar_ms = 1e3 * tb.seconds["add_scalar"] / tb.calls["add_scalar"]
    per_log_ms = 1e3 * tb.seconds["add_scalar"] / gui_iterations
    per_eval_ms = 1e3 * (tb.seconds["add_images"]
                         + tb.seconds["add_histogram"])
    print(f"[viewer] training with the network viewer at {gw}x{gh}: "
          f"{frames_served} frames served ({paused_frames} paused), each "
          f"within {gui_err:.2e} of make_render_fn's (limit {TOL_GUI:.0e});"
          f" round trip {rtt_paused:.3f} ms paused, {rtt_training:.3f} ms "
          f"with a step; {ms_client:.3f} ms/iteration with a client, "
          f"{ms_alone:.3f} without; launches {launches['gui']}")
    print(f"[viewer] tensorboard: {len(tags) - 1} tags, every record's CRC "
          f"valid; {scalar_ms:.3f} ms per scalar, {per_log_ms:.3f} ms per "
          f"log point, {per_eval_ms:.1f} ms of images and histogram per "
          f"eval ({tb.calls['add_images']} images)")
    out["gui"] = dict(size=[gw, gh], iterations=gui_iterations,
                      frames=frames_served, paused_frames=paused_frames,
                      max_abs_err=gui_err, rtt_paused_ms=round(rtt_paused, 3),
                      rtt_training_ms=round(rtt_training, 3),
                      ms_per_iteration_client=round(ms_client, 3),
                      ms_per_iteration_alone=round(ms_alone, 3),
                      wall_s=[round(con["wall"], 2), round(alone["wall"], 2)])
    out["tensorboard"] = dict(tags=len(tags) - 1,
                              ms_per_scalar=round(scalar_ms, 4),
                              ms_per_log_point=round(per_log_ms, 3),
                              ms_per_eval=round(per_eval_ms, 2),
                              images=tb.calls["add_images"])
    del con, alone

    # ---- (c) the profiler -------------------------------------------------------
    prof_dir = os.path.join(work, "profile")
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "gaussianavatars_torch.train", "-s", data,
         "-m", os.path.join(work, "profile_run"), "--bind_to_mesh",
         "--iterations", str(profile_iterations), "--test_iterations",
         str(profile_iterations), "--save_iterations",
         str(profile_iterations), "--checkpoint_iterations",
         str(profile_iterations), "--no_gui", "--quiet", "--profile_dir",
         prof_dir, "--device", dev.type], cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
        text=True, timeout=600)
    cli_s = time.perf_counter() - t0
    check(res.returncode == 0, f"train --profile_dir failed: "
                               f"{res.stderr[-2000:]}")
    (trace,) = [f for f in os.listdir(prof_dir) if f.endswith(".json")]
    trace_bytes = os.path.getsize(os.path.join(prof_dir, trace))
    with open(os.path.join(prof_dir, trace)) as f:
        trace_events = json.load(f)["traceEvents"]
    named = {}
    for e in trace_events:
        for kernel in ("blend_fwd_kernel", "blend_bwd_kernel"):
            if kernel in e.get("name", "") and e.get("cat") == "kernel":
                named[kernel] = named.get(kernel, 0) + 1
    check(dev.type != "cuda" or (
        named.get("blend_fwd_kernel", 0) >= profile_iterations
        and named.get("blend_bwd_kernel", 0) >= profile_iterations),
        f"the trace names the kernels {named} times")
    del trace_events
    overhead = {}
    for label, scope in (("plain", None),
                         ("profiled", os.path.join(work, "profile_in"))):
        with profile_trace(scope):
            _, _, pinfo = loop.training(
                ModelConfig(model_path=os.path.join(work, f"p_{label}"),
                            **cfg),
                OptimizationConfig(iterations=profile_iterations,
                                   position_lr_max_steps=profile_iterations),
                PipelineConfig(), log_every=1, device=dev)
        overhead[label] = _steady_ms(pinfo["timeline"])
    print(f"[viewer] train --profile_dir: {profile_iterations} iterations "
          f"in {cli_s:.2f} s (process included), trace of "
          f"{trace_bytes} bytes naming the kernels {named}; in process "
          f"{overhead['plain']:.3f} ms/iteration, {overhead['profiled']:.3f}"
          f" ms/iteration profiled")
    out["profiler"] = dict(iterations=profile_iterations,
                           cli_s=round(cli_s, 2), trace_bytes=trace_bytes,
                           kernel_events=named,
                           ms_per_iteration={k: round(v, 3) for k, v in
                                             overhead.items()})

    # ---- (d) the FPS benchmarks --------------------------------------------------
    runs = [("demo", fps_demo, None), ("dataset", fps_dataset, None)]
    if protocol:
        runs += [("demo_protocol", (500, 3), None),
                 ("dataset_protocol", (500, 3), None),
                 ("demo_4k", (20, 1), (3840, 2160))]
    out["fps"] = {}
    for name, (n_iter, rounds), size in runs:
        argv = ["--n_iter", str(n_iter), "--n_rounds", str(rounds),
                "--device", dev.type]
        reset()
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        if name.startswith("demo"):
            argv = ["--point_path", ply] + argv
            if size is not None:
                argv += ["--width", str(size[0]), "--height", str(size[1])]
            fps = {"frame": fps_benchmark_demo.main(argv)}
            renders = n_iter * rounds + 1
        else:
            fps = fps_benchmark_dataset.main(["-m", io_dir] + argv)
            renders = len(fps) * (n_iter * rounds + 1)
        peak = (torch.cuda.max_memory_allocated(dev) / 2 ** 20
                if dev.type == "cuda" else None)
        launches[f"fps_{name}"] = count()
        check(launches[f"fps_{name}"] == {"blend_fwd": renders,
                                          "blend_bwd": 0},
              f"fps {name} launched {launches[f'fps_{name}']}")
        out["fps"][name] = dict(
            n_iter=n_iter, rounds=rounds, size=size,
            fps={k: [round(x, 2) for x in v] for k, v in fps.items()},
            ms={k: round(1e3 / float(np.mean(v)), 3)
                for k, v in fps.items()},
            peak_mib=None if peak is None else round(peak, 1))
        print(f"[viewer] fps_benchmark_{name}: {out['fps'][name]}")

    # ---- (e) JPEG views: nvJPEG against PIL's pixels and the plain decoder --
    fixtures = os.path.join(REPO, "fixtures", "jpeg")
    dec = NvJpegDecoder(dev)
    jpeg = {}
    for name in sorted(f for f in os.listdir(fixtures) if f.endswith(".jpg")):
        path = os.path.join(fixtures, name)
        got = loader.read_image(path, jpeg=dec)
        plain = None if "progressive" in name else read_jpeg(path)
        stem = path[:-4]
        if os.path.exists(stem + ".png"):
            pil = read_png(stem + ".png")
        else:                   # the digest of PIL's pixels: the plain ones
            with open(stem + ".pil.json") as f:
                digest = json.load(f)
            check(hashlib.sha256(plain.tobytes()).hexdigest()
                  == digest["sha256"] and list(plain.shape)
                  == digest["shape"], f"{name}: plain decode != PIL's")
            pil = plain
        if pil.ndim == 2:
            pil = np.repeat(pil[..., None], 3, axis=-1)
            plain = None if plain is None else pil
        check(got.shape == pil.shape, f"{name}: nvJPEG {got.shape} vs "
                                      f"{pil.shape}")
        d = np.abs(got.astype(np.int64) - pil.astype(np.int64))
        row = dict(max=int(d.max()), mean=round(float(d.mean()), 4),
                   share_over_1=round(float((d > 1).mean()), 5))
        if plain is not None:
            row["max_vs_plain"] = int(np.abs(
                got.astype(np.int64) - plain.astype(np.int64)).max())
        jpeg[name] = row
        print(f"[viewer] nvJPEG {name}: vs PIL {row}")
        tol_max, tol_mean = JPEG_LIMITS[name]
        check(row["max"] <= tol_max and row["mean"] <= tol_mean,
              f"nvJPEG {name} vs PIL: {row} (limits {tol_max}, "
              f"{tol_mean})")
    bench_jpg = os.path.join(fixtures, "bench_802x550.jpg")
    bench_png = os.path.join(work, "bench_802x550.png")
    write_png(bench_png, read_jpeg(bench_jpg))
    timings = {}
    for label, fn in (("nvjpeg", lambda: loader.read_image(bench_jpg,
                                                           jpeg=dec)),
                      ("png", lambda: loader.read_image(bench_png)),
                      ("plain_jpeg", lambda: loader.read_image(bench_jpg))):
        fn()
        reps = 2 if label == "plain_jpeg" else 10
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        timings[label] = round(1e3 * (time.perf_counter() - t0) / reps, 3)
    with open(bench_jpg, "rb") as f:
        raw = f.read()
    dec.decode(raw)
    t0 = time.perf_counter()
    for _ in range(10):
        dec.decode(raw)
    torch.cuda.synchronize(dev)
    timings["nvjpeg_decode_only"] = round(
        1e3 * (time.perf_counter() - t0) / 10, 3)
    dec.close()
    print(f"[viewer] 802x550 view, ms per image: {timings}")

    # ---- (f) training on JPEG views: phase 10's COLMAP scene re-encoded ---
    src = os.path.join(work, "synthetic", "colmap")
    dst = os.path.join(work, "synthetic", "colmap_jpeg")
    os.makedirs(os.path.join(dst, "images"))
    os.makedirs(os.path.join(dst, "sparse", "0"))
    for f in ("cameras.bin", "points3D.bin"):
        shutil.copyfile(os.path.join(src, "sparse", "0", f),
                        os.path.join(dst, "sparse", "0", f))
    images = []
    t0 = time.perf_counter()
    for im in colmap.read_images_binary(
            os.path.join(src, "sparse", "0", "images.bin")).values():
        name = im.name.rsplit(".", 1)[0] + ".jpg"
        rgb = read_png(os.path.join(src, "images", im.name))[..., :3]
        with open(os.path.join(dst, "images", name), "wb") as f:
            f.write(encode_jpeg(np.ascontiguousarray(rgb), 90))
        images.append(colmap.ColmapImage(im.id, im.qvec, im.tvec,
                                         im.camera_id, name))
    colmap.write_images_binary(os.path.join(dst, "sparse", "0",
                                            "images.bin"), images)
    encode_s = time.perf_counter() - t0
    lock, decodes = threading.Lock(), [0]
    orig_decode = NvJpegDecoder.decode

    def counting_decode(self, data, path="<bytes>"):
        with lock:
            decodes[0] += 1
        return orig_decode(self, data, path)

    NvJpegDecoder.decode = counting_decode
    try:
        reset()
        jcfg = ModelConfig(source_path=dst,
                           model_path=os.path.join(work, "jpeg_run"),
                           bind_to_mesh=False, eval=True, sh_degree=3,
                           white_background=True)
        writer = SummaryWriter(jcfg.model_path)
        t0 = time.perf_counter()
        jmodel, _, jinfo = loop.training(
            jcfg, OptimizationConfig(iterations=jpeg_iterations,
                                     position_lr_max_steps=jpeg_iterations),
            PipelineConfig(), testing_iterations={jpeg_iterations},
            log_every=1, tb_writer=writer, device=dev)
        sync()
        jpeg_wall = time.perf_counter() - t0
        writer.close()
    finally:
        NvJpegDecoder.decode = orig_decode
    launches["jpeg"] = count()
    hist = jinfo["history"]
    test_psnr = jinfo["metrics"][jpeg_iterations]["test"]["psnr"]
    check(decodes[0] > 0, "no view was decoded by nvJPEG")
    check(all(np.isfinite(v) for _, v in hist), "non-finite JPEG-run loss")
    check(launches["jpeg"]["blend_bwd"] == jpeg_iterations,
          f"the JPEG run launched {launches['jpeg']}")
    # one view of the run: the loader's nvJPEG view against the plain one
    from gaussianavatars_torch.data.readers import read_colmap_scene

    cam = read_colmap_scene(dst, eval_split=True).train_cameras[0]
    dec = NvJpegDecoder(dev)
    view_d = float(np.abs(loader.load_camera_image(cam, jpeg=dec)
                          - loader.load_camera_image(cam)).max()) * 255.0
    dec.close()
    check(view_d <= JPEG_444_MAX + 1e-3,
          f"a JPEG view: nvJPEG vs plain {view_d} levels (limit "
          f"{JPEG_444_MAX})")
    print(f"[viewer] training on {len(images)} JPEG views (re-encoded in "
          f"{encode_s:.2f} s): {jpeg_iterations} iterations in "
          f"{jpeg_wall:.2f} s, {decodes[0]} nvJPEG decodes, EMA loss "
          f"{hist[0][1]:.5f} -> {hist[-1][1]:.5f}, test PSNR "
          f"{test_psnr:.3f}; a view nvJPEG vs plain {view_d:.1f} levels; "
          f"launches {launches['jpeg']}")
    out["jpeg"] = dict(fixtures=jpeg, ms_per_image=timings,
                       views=len(images), iterations=jpeg_iterations,
                       decodes=decodes[0], wall_s=round(jpeg_wall, 2),
                       ema_loss=[round(hist[0][1], 6), round(hist[-1][1], 6)],
                       test_psnr=round(test_psnr, 3),
                       view_max_levels_vs_plain=round(view_d, 3),
                       n_gaussians=jmodel.num_gaussians)
    out["launches"] = launches
    out["k1_err"] = k1_err
    return out


PARALLEL_RENDERS = 8          # phase 12: sharded renders (2 per timestep)
NCCL_ITERATIONS = 30          # phase 12: `train --distributed`, a world of 1
MULTI_ITERATIONS = 20         # phase 12: two subjects, densified at 10
BENCH_MULTI_ITERS = 20        # phase 12: bench_multisubject's iterations
TOL_SHARDED_IMAGE = 1e-5      # sharded vs one-device render, max|d|
TOL_SHARDED_GRAD = 2e-4       # sharded vs one-device step, per leaf
DRIFT_MULTIPLE = 4            # two subjects vs solo: gap <= 4 x solo drift
RANK_TIMEOUT_S = 300


def _kernel_errors(inst, ranges, args, seed):
    """K1's max|d|, K2's max|d| and K2's largest per-column max|d| /
    max|plain| against their plain versions on one stream (random
    cotangents from `seed`)."""
    from gaussianavatars_torch.ops import tile_blend

    color, trans = tile_blend.blend_image_cuda(inst, ranges, *args)
    ref = tile_blend.blend_image_plain(inst, ranges, *args)
    k1 = max(float((color - ref[0]).abs().max()),
             float((trans - ref[1]).abs().max()))
    rng = np.random.default_rng(seed)
    width, height = args[1], args[2]
    g_c = torch.as_tensor(rng.normal(size=(3, height, width)).astype(
        np.float32), device=inst.device)
    g_t = torch.as_tensor(rng.normal(size=(height, width)).astype(
        np.float32), device=inst.device)
    out = tile_blend.blend_image_bwd_cuda(inst, ranges, *args, color, trans,
                                          g_c, g_t)
    ref = tile_blend.blend_image_bwd_plain(inst, ranges, *args, color, trans,
                                           g_c, g_t)
    diff = (out - ref).abs()
    return k1, float(diff.max()), float(
        (diff.amax(0) / ref.abs().amax(0).clamp(min=1e-30)).max())


def _parallel_rank(rank, world, root, device, width, height, n_per_face,
                   renders):
    """One of phase 12's ranks (a spawned process): gloo over one card.
    Writes rank_<rank>.json; exits 1 on any failure."""
    import traceback

    try:
        sys.path.insert(0, REPO)
        from gaussianavatars_torch.benchmark import (
            bench_camera, blend_inputs, bound_bench_scene,
            make_bound_bench_model,
        )
        from gaussianavatars_torch.config import (
            OptimizationConfig, PipelineConfig,
        )
        from gaussianavatars_torch.ops import tile_blend
        from gaussianavatars_torch.ops.binning_dense import tile_grid
        from gaussianavatars_torch.parallel import (
            make_mesh, make_sharded_render, make_sharded_train_step,
        )
        from gaussianavatars_torch.parallel.distributed import (
            initialize_distributed,
        )
        from gaussianavatars_torch.parallel.sharded import shard_state
        from gaussianavatars_torch.train.loop import (
            camera_arrays, initial_state, lr_pytree, make_render_fn,
            make_train_step,
        )

        dev = initialize_distributed(f"file://{root}/rendezvous", world,
                                     rank, backend="gloo", device=device,
                                     timeout_s=RANK_TIMEOUT_S)
        counted = {"blend_fwd": tile_blend.blend_image_cuda,
                   "blend_bwd": tile_blend.blend_image_bwd_cuda}

        def reset():
            for fn in counted.values():
                fn.launches = 0

        def launches():
            return {k: getattr(fn, "launches", 0)
                    for k, fn in counted.items()}

        def sync():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

        mesh = make_mesh(1, world)
        out = {"rank": rank, "device": str(dev),
               "backend": torch.distributed.get_backend()}
        model = make_bound_bench_model(n_per_face=n_per_face, device=dev)
        n = model.num_gaussians
        sh = model.active_sh_degree
        cam_params = bench_camera(width, height, device=dev)
        cam = camera_arrays(cam_params)
        bg = torch.ones(3, device=dev)
        render = make_sharded_render(mesh, width, height, sh)
        single = make_render_fn(model, PipelineConfig(), width, height, sh)

        def frames(t):
            with torch.no_grad():
                return model.face_frames_at(model.flame_param, t)

        render(model.params, model.binding, frames(0), cam, bg)   # warm-up
        sync()
        reset()
        t0 = time.perf_counter()
        images = [render(model.params, model.binding,
                         frames(i % model.num_timesteps), cam, bg)
                  for i in range(renders)]
        sync()
        out["render_ms"] = 1e3 * (time.perf_counter() - t0) / renders
        out["render_launches"] = launches()
        out["image_err"] = max(
            float((images[t] - single(model.params, model.flame_param,
                                      model.binding, cam, bg, t).image)
                  .abs().max())
            for t in range(min(renders, model.num_timesteps)))
        out["image_shape"] = list(images[0].shape)

        # one step: the one-device step and the sharded step from fresh
        # avatars (both update their FLAME tensors in place)
        opt = OptimizationConfig()
        gt = torch.as_tensor(np.random.default_rng(2).random(
            (3, height, width)).astype(np.float32), device=dev)

        def fresh():
            m = make_bound_bench_model(n_per_face=n_per_face, device=dev)
            state = initial_state(m)
            fixed = {k: v for k, v in m.flame_param.items()
                     if k not in state.flame_tr}
            return m, state, fixed, lr_pytree(opt, 1e-3, state.flame_tr, 1.0)

        m1, s1, fixed1, lrs1 = fresh()
        s1, l1, _ = make_train_step(m1, opt, PipelineConfig(), width, height,
                                    sh, m1.num_timesteps)(
            s1, fixed1, m1.binding, cam, gt, bg, 1, lrs1)
        m2, s2, fixed2, lrs2 = fresh()
        rows = mesh.shard(n)
        step = make_sharded_train_step(mesh, m2, opt, PipelineConfig(),
                                       width, height, sh)
        s2 = shard_state(s2, mesh)
        sync()
        reset()
        t0 = time.perf_counter()
        s2, l2, _ = step(s2, fixed2, m2.binding[rows], cam, gt, bg, 1, lrs2,
                         n)
        sync()
        out["step_ms"] = 1e3 * (time.perf_counter() - t0)
        out["step_launches"] = launches()
        rel = {}
        for k in s1.mu["gauss"]._fields:
            ref = getattr(s1.mu["gauss"], k)
            got = getattr(s2.mu["gauss"], k)
            rel[k] = float((got - ref[rows]).abs().max()
                           / ref.abs().max().clamp(min=1e-30))
        for k, ref in s1.mu["flame"].items():
            rel["flame_" + k] = float((s2.mu["flame"][k] - ref).abs().max()
                                      / ref.abs().max().clamp(min=1e-30))
        out["grad_rel"] = rel
        out["loss_rel"] = {k: abs(float(l2[k]) / float(l1[k]) - 1.0)
                           for k in l1}

        # K1 and K2 on this rank's slab of the bench stream
        rows_per = -(-tile_grid(width, height, 32)[1] // world)
        inst, ranges, args = blend_inputs(
            bound_bench_scene(model, 0), cam_params, 32, sh,
            rank * rows_per, rows_per)
        out["slab_instances"] = int(inst.shape[0])
        out["slab_rows"] = [rank * rows_per, rows_per]
        if dev.type == "cuda":
            out["k1_err"], out["k2_err"], out["k2_rel"] = _kernel_errors(
                inst, ranges, args, 200 + rank)
        with open(os.path.join(root, f"rank_{rank}.json"), "w") as f:
            json.dump(out, f)
        torch.distributed.barrier()
        torch.distributed.destroy_process_group()
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        os._exit(1)


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def parallel_phase(dev, work, width, height, n_per_face=10,
                   renders=PARALLEL_RENDERS, nccl_iterations=NCCL_ITERATIONS,
                   multi_iterations=MULTI_ITERATIONS,
                   bench_iters=BENCH_MULTI_ITERS):
    """Phase 12: two ranks on one card over gloo, `train --distributed`
    with NCCL and a world of 1 on phase 8's dataset under `work`, and two
    subjects trained in turn on one rank (see the module docstring).
    Returns the numbers it measured; raises on any failure."""
    import multiprocessing

    from gaussianavatars_torch import bench_multisubject
    from gaussianavatars_torch.benchmark import (
        bench_camera, make_bound_bench_model,
    )
    from gaussianavatars_torch.config import OptimizationConfig, PipelineConfig
    from gaussianavatars_torch.ops import tile_blend
    from gaussianavatars_torch.parallel import make_mesh
    from gaussianavatars_torch.train.loop import camera_arrays
    from gaussianavatars_torch.train.multisubject import MultiSubjectTrainer

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    out = {}
    # ---- two ranks on one card over gloo -----------------------------------
    root = tempfile.mkdtemp(prefix="ranks_", dir=work)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_parallel_rank,
                         args=(r, 2, root, dev.type, width, height,
                               n_per_face, renders)) for r in range(2)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    for p in procs:
        p.join(RANK_TIMEOUT_S)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    out["ranks_s"] = time.perf_counter() - t0
    check([p.exitcode for p in procs] == [0, 0],
          f"phase 12 ranks exited {[p.exitcode for p in procs]}")
    ranks = []
    for r in range(2):
        with open(os.path.join(root, f"rank_{r}.json")) as f:
            ranks.append(json.load(f))
    for r in ranks:
        print(f"[parallel] rank {r['rank']} ({r['backend']}, {r['device']}): "
              f"{renders} sharded renders {r['render_ms']:.2f} ms each, "
              f"max|d| vs make_render_fn {r['image_err']:.3e} (limit "
              f"{TOL_SHARDED_IMAGE:.0e}), launches {r['render_launches']}; "
              f"step {r['step_ms']:.2f} ms, launches {r['step_launches']}, "
              f"worst gradient leaf "
              f"{max(r['grad_rel'].values()):.3e} (limit 2e-04); slab tile "
              f"rows {r['slab_rows']}, {r['slab_instances']} instances, K1 "
              f"{r.get('k1_err', float('nan')):.3e}, K2 "
              f"{r.get('k2_rel', float('nan')):.3e}")
        check(r["image_shape"] == [3, height, width],
              f"sharded image {r['image_shape']}")
        check(r["image_err"] <= TOL_SHARDED_IMAGE,
              f"rank {r['rank']}: sharded render max|d| {r['image_err']}")
        for k, v in r["grad_rel"].items():
            check(v <= TOL_SHARDED_GRAD, f"rank {r['rank']}: sharded step "
                  f"gradient {k} relative error {v}")
        for k, v in r["loss_rel"].items():
            check(v <= 1e-5, f"rank {r['rank']}: loss {k} differs by {v}")
        if dev.type == "cuda":
            check(r["render_launches"] == {"blend_fwd": renders,
                                           "blend_bwd": 0},
                  f"rank {r['rank']}: render launches {r['render_launches']}")
            check(r["step_launches"] == {"blend_fwd": 1, "blend_bwd": 1},
                  f"rank {r['rank']}: step launches {r['step_launches']}")
            check(r["k1_err"] <= TOL_BENCH,
                  f"rank {r['rank']}: K1 on its slab {r['k1_err']}")
            check(r["k2_rel"] <= TOL_BWD_BENCH,
                  f"rank {r['rank']}: K2 on its slab {r['k2_rel']}")
    out["ranks"] = ranks

    # ---- NCCL, a world of 1: the train entry point ---------------------------
    nccl_dir = os.path.join(work, "nccl")
    env = dict(os.environ, PYTHONPATH=REPO, RANK="0", WORLD_SIZE="1",
               LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()),
               FLAME_ASSET_DIR=os.path.join(work, "assets"))
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "gaussianavatars_torch.train",
         "-s", os.path.join(work, "data"), "-m", nccl_dir, "--bind_to_mesh",
         "--eval", "--iterations", str(nccl_iterations), "--device",
         dev.type, "--distributed", "--port", "0"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    out["nccl_s"] = time.perf_counter() - t0
    check(res.returncode == 0, f"train --distributed exited "
          f"{res.returncode}: {res.stderr[-3000:]}")
    for name in (f"point_cloud/iteration_{nccl_iterations}/point_cloud.ply",
                 f"chkpnt{nccl_iterations}.npz"):
        check(os.path.exists(os.path.join(nccl_dir, name)),
              f"train --distributed wrote no {name}")
    check("Training complete" in res.stdout, "train --distributed did not "
          "complete")
    tail = [line for line in res.stdout.splitlines() if line.strip()]
    backend = "nccl" if dev.type == "cuda" else "gloo"
    print(f"[parallel] train --distributed ({backend}, world 1): "
          f"{nccl_iterations} iterations in {out['nccl_s']:.1f} s (process "
          f"included); {tail[-2] if len(tail) > 1 else tail}")

    # ---- two subjects in turn on one rank ------------------------------------
    half = max(1, multi_iterations // 2)
    opt = OptimizationConfig(
        densify_from_iter=0, densification_interval=half,
        densify_until_iter=half + 1,
        # every Gaussian clones or splits: each decision is a function of
        # the parameters, none hangs on a gradient at float32 noise
        densify_grad_threshold=0.0, opacity_reset_interval=10 ** 9)
    cam = camera_arrays(bench_camera(width, height, device=dev))
    bg = torch.ones(3, device=dev)
    gts = [torch.as_tensor(np.random.default_rng(10 + s).random(
        (3, height, width)).astype(np.float32), device=dev)
        for s in range(2)]
    mesh = make_mesh(1, 1)
    counted = {"blend_fwd": tile_blend.blend_image_cuda,
               "blend_bwd": tile_blend.blend_image_bwd_cuda}

    def run(subjects):
        models = [make_bound_bench_model(n_per_face=n_per_face, seed=s,
                                         device=dev) for s in subjects]
        start = models[0].num_gaussians
        trainer = MultiSubjectTrainer(models, mesh, opt, PipelineConfig(),
                                      width, height, [1.0] * len(models))

        def batch_fn(i, iteration):
            return cam, gts[subjects[i]], bg, iteration % 4

        sync()
        for fn in counted.values():
            fn.launches = 0
        t0 = time.perf_counter()
        losses = trainer.train(batch_fn, 1, multi_iterations)
        sync()
        ms = 1e3 * (time.perf_counter() - t0) / multi_iterations
        for k, v in losses.items():
            check(bool(torch.isfinite(v)), f"subjects {subjects}: loss {k}")
        check(all(m.num_gaussians > start for m in models),
              f"subjects {subjects}: the densification added no Gaussians")
        return models, ms, {k: getattr(fn, "launches", 0)
                            for k, fn in counted.items()}

    def max_diff(a, b):
        check(a.num_gaussians == b.num_gaussians,
              f"{a.num_gaussians} vs {b.num_gaussians} Gaussians")
        return max(float((x - y).abs().max())
                   for x, y in zip(a.params, b.params))

    both, both_ms, both_launches = run([0, 1])
    solo = [run([s]) for s in range(2)]
    again = run([0])
    drift = max_diff(solo[0][0][0], again[0][0])
    gaps = [max_diff(both[s], solo[s][0][0]) for s in range(2)]
    counts = [m.num_gaussians for m in both]
    print(f"[parallel] two subjects in turn, {multi_iterations} iterations "
          f"(densified at {half} to {counts} Gaussians): {both_ms:.2f} ms an "
          f"iteration against {solo[0][1]:.2f} ms solo; max|d| from the solo "
          f"runs {gaps[0]:.3e} / {gaps[1]:.3e}, solo run-to-run drift "
          f"{drift:.3e} (limit {DRIFT_MULTIPLE} x drift); launches "
          f"{both_launches}")
    for s, gap in enumerate(gaps):
        check(gap <= DRIFT_MULTIPLE * drift,
              f"subject {s}: {gap} from its solo run, drift {drift}")
    if dev.type == "cuda":
        check(both_launches == {"blend_fwd": 2 * multi_iterations,
                                "blend_bwd": 2 * multi_iterations},
              f"two-subject launches {both_launches}")
    out["multisubject"] = dict(
        iterations=multi_iterations, ms_per_iteration=both_ms,
        solo_ms_per_iteration=solo[0][1], gaps=gaps, drift=drift,
        counts=counts, launches=both_launches)
    bench = bench_multisubject.main([
        "--iters", str(bench_iters), "--rounds", "2", "--width", str(width),
        "--height", str(height), "--n_per_face", str(n_per_face),
        "--device", dev.type])
    out["bench_multisubject"] = bench
    out["launches"] = {
        "ranks_render": ranks[0]["render_launches"],
        "ranks_step": ranks[0]["step_launches"],
        "multisubject": both_launches}
    return out


SORT_RENDERS = 8              # phase 13: served renders (2 per timestep)
SORT_STEPS = 10               # phase 13: timed train steps (after 2 warm-up)
SORT_CLI_ITERATIONS = 30      # phase 13: `train --binning sort`
TOL_SORT_IMAGE = 1e-5         # sort vs dense image, max|d| (JAX's own gate)
TOL_SORT_FLIP = 1e-3          # on the values where an alpha flipped at 1/255
TOL_SORT_GRAD = 2e-4          # sort vs dense step, per gradient leaf
DIAG_TOL_DB = 1e-3            # diag_eval_views vs evaluate_splits, per split


def kernel_bound(inst, ranges, args, work, backward=False) -> dict:
    """K1's (or, with `backward`, K2's) roofline bound on one stream from
    the plain version's work counts: the bytes it must move (stream and
    ranges in, the image planes; K2 also the (K, 9) gradient out) over the
    memory rate, its FP32 operations and exponentials over their peak
    rates, the larger of the two."""
    width, height = args[1], args[2]
    nbytes = ((2 if backward else 1) * inst.numel() + ranges.numel()
              + (8 if backward else 4) * width * height) * 4
    flops = (FLOPS_PER_PAIR * work["pairs"] + FLOPS_PER_EXP_PAIR * work["exps"]
             + (BWD_FLOPS_PER_BLENDED if backward else FLOPS_PER_BLENDED)
             * work["blended"])
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    t_ops = max(flops / PEAK_FP32_FLOPS, work["exps"] / PEAK_SFU_OPS) * 1e3
    return dict(bytes=nbytes, flops=flops, t_bytes=t_bytes, t_ops=t_ops,
                ms=max(t_bytes, t_ops),
                by="bytes" if t_bytes >= t_ops else "operations")


def sort_phase(dev, work, dense, compare, compare_bwd, cotangents,
               renders=SORT_RENDERS, steps=SORT_STEPS,
               cli_iterations=SORT_CLI_ITERATIONS, n_per_face=10):
    """Phase 13: the sort binning (`--binning sort`) on the card, under
    the directory `work` of phases 8 and 10 (see the module docstring).
    `dense` holds phase 5's and 7's dense numbers of this call;
    `compare`, `compare_bwd` and `cotangents` are phase 3's kernel checks.
    Returns the numbers it measured; raises on any failure."""
    from gaussianavatars_torch import kernels
    from gaussianavatars_torch.benchmark import (
        bench_camera, blend_inputs, bound_bench_scene, make_bound_bench_model,
    )
    from gaussianavatars_torch.config import OptimizationConfig, PipelineConfig
    from gaussianavatars_torch.ops import tile_blend
    from gaussianavatars_torch.profile_render import range_stats
    from gaussianavatars_torch.tools import diag_eval_views
    from gaussianavatars_torch.tools import parity_vs_reference as parity
    from gaussianavatars_torch.train import loop, optim

    k1, k2 = tile_blend.blend_image_cuda, tile_blend.blend_image_bwd_cuda
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def timed(fn, n):
        """(results, device ms per call: CUDA events, host clock on the
        CPU) of n calls fn(i)."""
        sync()
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        res = [fn(i) for i in range(n)]
        if cuda:
            end.record()
        sync()
        ms = (start.elapsed_time(end) if cuda
              else 1e3 * (time.perf_counter() - t0))
        return res, ms / n

    out = {}
    model = make_bound_bench_model(n_per_face=n_per_face, device=dev)
    cam = bench_camera(dense["width"], dense["height"], device=dev)
    width, height = dense["width"], dense["height"]
    sh, nt = model.active_sh_degree, model.num_timesteps
    ca, bg = loop.camera_arrays(cam), torch.ones(3, device=dev)

    # ---- (a) serving at full width ------------------------------------------
    fns = {b: loop.make_render_fn(model, PipelineConfig(binning=b), width,
                                  height, sh) for b in ("dense", "sort")}

    def serve(binning):
        return lambda i: fns[binning](model.params, model.flame_param,
                                      model.binding, ca, bg, i % nt)

    ref = [serve("dense")(t) for t in range(nt)]
    for t in range(nt):                                   # warm-up
        serve("sort")(t)
    k1.launches = 0
    outs, sort_ms = timed(serve("sort"), renders)
    launches = {"render": k1.launches}
    check(launches["render"] == renders,
          f"K1 launched {launches['render']} times in {renders} sort renders")
    # two rounds in turns: the host of the call moves both paths alike
    sort_ms, dense_ms = [sort_ms], []
    for _ in range(2):
        dense_ms.append(timed(serve("dense"), renders)[1])
        if len(sort_ms) < 2:
            sort_ms.append(timed(serve("sort"), renders)[1])
    flips, flip_err, worst = 0, 0.0, 0.0
    for t in range(nt):
        img, d_img = outs[t].image, ref[t].image
        check(tuple(img.shape) == (3, height, width), f"shape {img.shape}")
        check(bool(torch.isfinite(img).all()), f"timestep {t}: non-finite")
        check(outs[t].instance_total > ref[t].instance_total,
              f"timestep {t}: sort stream {outs[t].instance_total} not "
              f"longer than the dense {ref[t].instance_total}")
        d = (img - d_img).abs()
        flipped = d > TOL_SORT_IMAGE
        flips += int(flipped.sum())
        if bool(flipped.any()):
            flip_err = max(flip_err, float(d[flipped].max()))
        worst = max(worst, float(d[~flipped].max()))
    share = flips / (nt * 3 * width * height)
    out["serve"] = dict(
        renders=renders, ms_per_render=sort_ms, dense_ms_per_render=dense_ms,
        instances=[o.instance_total for o in outs[:nt]],
        dense_instances=[o.instance_total for o in ref],
        max_abs_err=worst, flipped_values=flips, flipped_share=share,
        flipped_max_abs_err=flip_err)
    print(f"[sort] {renders} renders at {width}x{height} a round: "
          f"{sort_ms} ms/render, dense {dense_ms} in turns with them "
          f"({dense['render_ms']:.3f} in phase 5); instances "
          f"{out['serve']['instances']} vs dense "
          f"{out['serve']['dense_instances']}; image max|d| vs dense "
          f"{worst:.3e} (limit {TOL_SORT_IMAGE:.0e}), {flips} flipped "
          f"values (share {share:.2e}, max|d| {flip_err:.3e}, limit "
          f"{TOL_SORT_FLIP:.0e})")
    check(flip_err <= TOL_SORT_FLIP and share <= FLIP_SHARE,
          f"sort vs dense: {flips} values beyond {TOL_SORT_IMAGE}, max|d| "
          f"{flip_err}")

    # ---- (b) training -------------------------------------------------------
    opt_cfg = OptimizationConfig()
    fresh = loop.initial_state(model)
    flame_fixed = {k: v for k, v in model.flame_param.items()
                   if k not in fresh.flame_tr}
    lrs = loop.lr_pytree(opt_cfg, 1e-3, fresh.flame_tr,
                         model.spatial_lr_scale or 1.0)
    gt = torch.as_tensor(np.random.default_rng(2).random(
        (3, height, width)).astype(np.float32), device=dev)
    steps_fn = {b: loop.make_train_step(model, opt_cfg,
                                        PipelineConfig(binning=b), width,
                                        height, sh, nt)
                for b in ("dense", "sort")}

    def copy(state):
        return optim.tree_map(
            lambda x: x.clone() if isinstance(x, torch.Tensor) else x, state)

    one = {b: steps_fn[b](copy(fresh), flame_fixed, model.binding, ca, gt,
                          bg, 1, lrs) for b in ("dense", "sort")}
    (d_state, d_losses, _), (s_state, s_losses, _) = one["dense"], one["sort"]

    def rel(a, b):
        return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)

    grad_rel = {}
    for k in d_state.params._fields:
        grad_rel[k] = rel(getattr(s_state.mu["gauss"], k),
                          getattr(d_state.mu["gauss"], k))
    for k, v in d_state.mu["flame"].items():
        grad_rel["flame_" + k] = rel(s_state.mu["flame"][k], v)
    grad_rel["grad_accum"] = rel(s_state.grad_accum, d_state.grad_accum)
    loss_rel = {k: abs(float(s_losses[k]) - float(v))
                / max(abs(float(v)), 1e-30) for k, v in d_losses.items()}
    print(f"[sort] one step vs dense: gradient max|d|/max|dense| "
          f"{max(grad_rel.values()):.3e} (limit {TOL_SORT_GRAD:.0e}; "
          + ", ".join(f"{k} {v:.1e}" for k, v in grad_rel.items())
          + f"), losses rel {max(loss_rel.values()):.2e} (limit 1e-05)")
    for k, v in grad_rel.items():
        check(v <= TOL_SORT_GRAD, f"sort step gradient {k}: {v}")
    for k, v in loss_rel.items():
        check(v <= 1e-5, f"sort step loss {k}: rel {v}")
    check(torch.equal(s_state.denom, d_state.denom)
          and torch.equal(s_state.max_radii2d, d_state.max_radii2d),
          "sort step statistics differ from the dense step's")

    box = {b: copy(fresh) for b in ("dense", "sort")}

    def train(binning):
        def run(i):
            box[binning], losses, _ = steps_fn[binning](
                box[binning], flame_fixed, model.binding, ca, gt, bg, i % nt,
                lrs)
            return losses
        return run

    for i in range(2):                                        # warm-up
        train("sort")(i)
    k1.launches = k2.launches = 0
    losses, step_ms = timed(train("sort"), steps)
    launches["step"] = {"blend_fwd": k1.launches, "blend_bwd": k2.launches}
    step_ms, dense_step_ms = [step_ms], []
    for _ in range(2):
        dense_step_ms.append(timed(train("dense"), steps)[1])
        if len(step_ms) < 2:
            step_ms.append(timed(train("sort"), steps)[1])
    check(launches["step"] == {"blend_fwd": steps, "blend_bwd": steps},
          f"{steps} sort steps launched {launches['step']}")
    for lo in losses:
        check(all(bool(torch.isfinite(v)) for v in lo.values()),
              "non-finite sort step loss")
    out["train"] = dict(steps=steps, ms_per_step=step_ms,
                        dense_ms_per_step=dense_step_ms,
                        grad_rel=grad_rel, loss_rel=loss_rel)
    print(f"[sort] {steps} train steps a round: {step_ms} ms/step, dense "
          f"{dense_step_ms} in turns with them ({dense['step_ms']:.3f} in "
          f"phase 6); launches {launches['step']}")

    # ---- (c) the kernels on the sort stream ---------------------------------
    scene = bound_bench_scene(model, 0)
    streams = {b: blend_inputs(scene, cam, 32, binning=b)
               for b in ("dense", "sort")}
    inst, ranges, args = streams["sort"]
    k1_err = compare("sort stream 802x550", inst, ranges, args, TOL_BENCH)
    k2_err, k2_rel, k2_plain_ms = compare_bwd(
        "sort stream 802x550", inst, ranges, args, TOL_BWD_BENCH, 200)
    stream = {}
    for b, (s_inst, s_ranges, s_args) in streams.items():
        color, trans = k1(s_inst, s_ranges, *s_args)
        g_c, g_t = cotangents(s_args, 200)
        row = dict(range_stats(s_ranges))
        row["k1_ms"] = cuda_ms(lambda: k1(s_inst, s_ranges, *s_args), 50)
        row["k2_ms"] = cuda_ms(lambda: k2(s_inst, s_ranges, *s_args, color,
                                          trans, g_c, g_t), 50)
        if b == "sort":
            _, row["k1_plain_ms"] = timed(
                lambda i: tile_blend.blend_image_plain(s_inst, s_ranges,
                                                       *s_args), 1)
            row["k2_plain_ms"] = k2_plain_ms
            _, fwork = tile_blend.blend_image_plain(
                s_inst, s_ranges, *s_args, count_work=True)
            _, bwork = tile_blend.blend_image_bwd_plain(
                s_inst, s_ranges, *s_args, color, trans, g_c, g_t,
                count_work=True)
            for k, counts, backward in (("k1", fwork, False),
                                        ("k2", bwork, True)):
                bound = kernel_bound(s_inst, s_ranges, s_args, counts,
                                     backward)
                row[k + "_bound_ms"], row[k + "_bound_by"] = (bound["ms"],
                                                              bound["by"])
            row["plain_work"] = fwork
            for name, run in (
                    ("blend_fwd", lambda lib: k1(s_inst, s_ranges, *s_args,
                                                 lib=lib)),
                    ("blend_bwd", lambda lib: k2(s_inst, s_ranges, *s_args,
                                                 color, trans, g_c, g_t,
                                                 lib=lib))):
                lib = kernels.load(name, COUNTING)
                read = getattr(lib, name + "_counts")
                cnt = (ctypes.c_ulonglong * 3)()
                check(read(cnt) == 0, f"{name}_counts failed")
                run(lib)
                check(read(cnt) == 0, f"{name}_counts failed")
                row[name] = {"cull_tests": cnt[0],
                             "warp_slots_walked": cnt[1],
                             "pixel_evaluations": cnt[2]}
                check(fwork["blended"] <= cnt[2] <= fwork["pairs"],
                      f"{name} made {cnt[2]} pixel evaluations on the sort "
                      f"stream; the pixels need {fwork['blended']} to "
                      f"{fwork['pairs']}")
        stream[b] = row
    out["kernels"] = dict(k1_err=k1_err, k2_err=k2_err, k2_rel=k2_rel)
    out["stream"] = stream
    print(json.dumps(dict(what="sort_stream", **stream)))

    # ---- (d) the train entry point with --binning sort ----------------------
    cli_dir = os.path.join(work, "sort_cli")
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "gaussianavatars_torch.train", "-s",
         os.path.join(work, "data"), "-m", cli_dir, "--bind_to_mesh",
         "--eval", "--iterations", str(cli_iterations), "--save_iterations",
         str(cli_iterations), "--binning", "sort", "--port", "0",
         "--device", dev.type],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO,
                           FLAME_ASSET_DIR=os.path.join(work, "assets")),
        capture_output=True, text=True, timeout=600)
    out["cli_s"] = time.perf_counter() - t0
    check(res.returncode == 0, f"train --binning sort exited "
          f"{res.returncode}: {res.stderr[-3000:]}")
    check(os.path.exists(os.path.join(
        cli_dir, "point_cloud", f"iteration_{cli_iterations}",
        "point_cloud.ply")), "train --binning sort wrote no PLY")
    print(f"[sort] python -m gaussianavatars_torch.train --binning sort: "
          f"{cli_iterations} iterations in {out['cli_s']:.1f} s (process "
          f"included)")

    # ---- (e) the parity tool ------------------------------------------------
    def tool(argv):
        t0 = time.perf_counter()
        try:
            parity.main(argv + ["--device", dev.type])
        except SystemExit as exc:
            check(exc.code == 0, f"parity_vs_reference {argv} exited "
                  f"{exc.code}")
        return round(time.perf_counter() - t0, 2)

    os.environ["FLAME_ASSET_DIR"] = os.path.join(work, "assets")
    ply = os.path.join(work, "io", "point_cloud", "iteration_1",
                       "point_cloud.ply")
    dumps = {b: os.path.join(work, f"parity_{b}") for b in ("dense", "sort")}
    out["parity_s"] = {"check_assets": tool(
        ["--check_assets", os.path.join(work, "assets")])}
    if cuda:
        out["parity_s"]["self_check"] = tool(["--self_check"])
    for b, d in dumps.items():
        out["parity_s"][f"dump_{b}"] = tool(
            ["--point_path", ply, "--out", d, "--binning", b])
    out["parity_s"]["compare"] = tool(["--compare", dumps["dense"],
                                       dumps["sort"]])
    print(f"[sort] parity_vs_reference: {out['parity_s']} s")

    # ---- (f) the per-view diagnostics ---------------------------------------
    diag_dir = os.path.join(work, "diag")
    t0 = time.perf_counter()
    rows = diag_eval_views.main(["--run", os.path.join(work, "bound"),
                                 "--out", diag_dir, "--device", dev.type])
    out["diag_s"] = round(time.perf_counter() - t0, 2)
    check(len(rows) == dense["eval_views"],
          f"diag_eval_views listed {len(rows)} views of "
          f"{dense['eval_views']}")
    means = {}
    for split, want in dense["psnr_last"].items():
        means[split] = float(np.mean([r[3] for r in rows if r[0] == split]))
        check(abs(means[split] - want) <= DIAG_TOL_DB,
              f"diag_eval_views {split} mean PSNR {means[split]} vs "
              f"evaluate_splits {want}")
    written = sorted(os.listdir(diag_dir))
    check(len(written) == 3 * min(4, len(rows)),
          f"diag_eval_views wrote {written}")
    out["diag"] = dict(views=len(rows), mean_psnr=means,
                       eval_psnr=dense["psnr_last"], files=len(written))
    print(f"[sort] diag_eval_views: {len(rows)} views, mean PSNR {means} "
          f"vs evaluate_splits {dense['psnr_last']} (limit {DIAG_TOL_DB} "
          f"dB); {len(written)} PNGs in {out['diag_s']} s")
    out["launches"] = launches
    return out


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description="chip smoke test of the "
                                                 "port")
    parser.add_argument("--fps-protocol", action="store_true",
                        help="phase 11 also runs both FPS benchmarks' "
                             "reference protocol (500 renders x 3 rounds) "
                             "and one 3840x2160 demo run")
    opts = parser.parse_args(argv)
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
    from gaussianavatars_torch.viewer.network_gui import to_wire

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
    warned, syncs, texts = sync_counts(lambda: to_wire(serve(0).image))
    print(f"[syncs] a render and its frame: {warned} sync warnings, "
          f"host_syncs {syncs}")
    check(warned == syncs, f"a render and to_wire: {warned} sync warnings "
          f"against host_syncs {syncs}: {texts}")

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

    def one_step():
        nonlocal state
        state, _, _ = train(state, 0)

    warned, syncs, texts = sync_counts(one_step)
    print(f"[syncs] a train step: {warned} sync warnings, host_syncs "
          f"{syncs}")
    check(warned == syncs, f"a train step: {warned} sync warnings against "
          f"host_syncs {syncs}: {texts}")

    lap("training")
    # ---- 7. the kernels at the bench shapes ---------------------------------
    k1_ms = cuda_ms(lambda: tile_blend.blend_image(b_inst, b_ranges, *b_args),
                    50)
    plain_ms = cuda_ms(lambda: tile_blend.blend_image_plain(
        b_inst, b_ranges, *b_args), 1)
    _, work = tile_blend.blend_image_plain(b_inst, b_ranges, *b_args,
                                           count_work=True)
    k1_bound = kernel_bound(b_inst, b_ranges, b_args, work)
    print(f"[K1] bench: {b_inst.shape[0]} instances, {k1_ms:.4f} ms kernel, "
          f"{plain_ms:.2f} ms plain; work {work}; bytes {k1_bound['bytes']}, "
          f"fp32 flops {k1_bound['flops']}; bound {k1_bound['ms']:.4f} ms "
          f"(bytes {k1_bound['t_bytes']:.4f}, ops {k1_bound['t_ops']:.4f})")

    b_color, b_trans = tile_blend.blend_image_cuda(b_inst, b_ranges, *b_args)
    b_gc, b_gt = cotangents(b_args, 100)
    k2_ms = cuda_ms(lambda: tile_blend.blend_image_bwd_cuda(
        b_inst, b_ranges, *b_args, b_color, b_trans, b_gc, b_gt), 50)
    _, bwork = tile_blend.blend_image_bwd_plain(
        b_inst, b_ranges, *b_args, b_color, b_trans, b_gc, b_gt,
        count_work=True)
    # stream, ranges and eight image planes in; the (K, 9) gradient out
    k2_bound = kernel_bound(b_inst, b_ranges, b_args, bwork, backward=True)
    print(f"[K2] bench: {b_inst.shape[0]} slots, {k2_ms:.4f} ms kernel "
          f"(with the output's zero fill), {k2_plain_ms:.2f} ms plain; "
          f"work {bwork}; bytes {k2_bound['bytes']}, fp32 flops "
          f"{k2_bound['flops']}; bound {k2_bound['ms']:.4f} ms (bytes "
          f"{k2_bound['t_bytes']:.4f}, ops {k2_bound['t_ops']:.4f})")

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
        # ---- 10. the quality protocols, COLMAP and the pipeline options -----
        recovery_line = recovery_phase(dev, workdir)
        options_line, (s_inst, s_ranges, s_args) = options_phase(
            dev, model, cam, WIDTH, HEIGHT)
        errs.append(compare(f"bench stream, scaling_modifier "
                            f"{SCALING_MODIFIER}", s_inst, s_ranges, s_args,
                            TOL_BENCH))
        print(json.dumps(dict(what="recovery", **recovery_line,
                              options=options_line)))
        lap("recovery")
        # ---- 11. the viewers, observability, FPS and JPEG views --------------
        viewer_line = viewer_phase(dev, workdir, protocol=opts.fps_protocol)
        errs.append(viewer_line.pop("k1_err"))
        print(json.dumps(dict(what="viewer", **viewer_line)))
        lap("viewer")
        # ---- 12. ranks over gloo and NCCL, two subjects ---------------------
        parallel_line = parallel_phase(dev, workdir, WIDTH, HEIGHT)
        errs.extend(r["k1_err"] for r in parallel_line["ranks"])
        bwd_errs.extend((r["k2_err"], r["k2_rel"], 0.0)
                        for r in parallel_line["ranks"])
        print(json.dumps(dict(what="parallel", **parallel_line)))
        lap("parallel")
        # ---- 13. the sort binning -------------------------------------------
        sort_line = sort_phase(dev, workdir, dict(
            width=WIDTH, height=HEIGHT, render_ms=ms, step_ms=step_ms,
            eval_views=recovery_line["bound"]["eval_views"],
            psnr_last=recovery_line["bound"]["psnr_last"]),
            compare, compare_bwd, cotangents)
        errs.append(sort_line["kernels"]["k1_err"])
        bwd_errs.append((sort_line["kernels"]["k2_err"],
                         sort_line["kernels"]["k2_rel"], 0.0))
        print(json.dumps(dict(what="sort", **{
            k: v for k, v in sort_line.items() if k != "stream"})))
        lap("sort")
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

    sort_stream = sort_line["stream"]["sort"]
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
        "recovery_launches": {k: v["blend_fwd"] for k, v in
                              recovery_line["launches"].items()},
        "viewer_launches": viewer_line["launches"]["viewer"]["blend_fwd"],
        "gui_launches": viewer_line["launches"]["gui"]["blend_fwd"],
        "viewer_phase_launches": {k: v["blend_fwd"] for k, v in
                                  viewer_line["launches"].items()},
        "parallel_launches": {
            k: v["blend_fwd"] for k, v in parallel_line["launches"].items()},
        "parallel_calls": {
            "ranks_render": PARALLEL_RENDERS, "ranks_step": 1,
            "multisubject_steps": 2 * MULTI_ITERATIONS},
        "viewer_calls": {
            "viewer_frames": viewer_line["local"]["frames"]
            + viewer_line["local"]["mesh_frames"],
            "gui_iterations": viewer_line["gui"]["iterations"],
            "gui_frames": viewer_line["gui"]["frames"]},
        "recovery_calls": {
            "bound_iterations": BOUND_ITERATIONS,
            "bound_eval_views": recovery_line["bound"]["eval_views"],
            "unbound_iterations": UNBOUND_ITERATIONS,
            "unbound_eval_views": recovery_line["unbound"]["eval_views"]},
        "sort_launches": {"render": sort_line["launches"]["render"],
                          "step": sort_line["launches"]["step"]["blend_fwd"]},
        "sort_calls": {"renders": SORT_RENDERS, "steps": SORT_STEPS},
        "sort_ms": sort_stream["k1_ms"],
        "sort_dense_ms": sort_line["stream"]["dense"]["k1_ms"],
        "sort_plain_ms": sort_stream["k1_plain_ms"],
        "sort_bound_ms": sort_stream["k1_bound_ms"],
        "sort_bound_by": sort_stream["k1_bound_by"],
        "sort_slots": sort_stream["slots"],
        "sort_longest_tile": sort_stream["max"],
        "sort_pixel_evaluations":
            sort_stream["blend_fwd"]["pixel_evaluations"],
        "max_abs_err": max(errs),
        "pixel_evaluations": walked["blend_fwd"]["pixel_evaluations"],
        "ms": k1_ms,
        "plain_ms": plain_ms,
        "bound_ms": k1_bound["ms"],
        "bound_by": k1_bound["by"],
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
        "recovery_launches": {k: v["blend_bwd"] for k, v in
                              recovery_line["launches"].items()},
        "viewer_launches": viewer_line["launches"]["viewer"]["blend_bwd"],
        "gui_launches": viewer_line["launches"]["gui"]["blend_bwd"],
        "viewer_phase_launches": {k: v["blend_bwd"] for k, v in
                                  viewer_line["launches"].items()},
        "parallel_launches": {
            k: v["blend_bwd"] for k, v in parallel_line["launches"].items()},
        "sort_launches": {"step": sort_line["launches"]["step"]["blend_bwd"]},
        "sort_calls": {"steps": SORT_STEPS},
        "sort_ms": sort_stream["k2_ms"],
        "sort_dense_ms": sort_line["stream"]["dense"]["k2_ms"],
        "sort_plain_ms": sort_stream["k2_plain_ms"],
        "sort_bound_ms": sort_stream["k2_bound_ms"],
        "sort_bound_by": sort_stream["k2_bound_by"],
        "sort_pixel_evaluations":
            sort_stream["blend_bwd"]["pixel_evaluations"],
        "max_abs_err": max(e[0] for e in bwd_errs),
        "max_column_rel_err": max(e[1] for e in bwd_errs),
        "pixel_evaluations": walked["blend_bwd"]["pixel_evaluations"],
        "ms": k2_ms,
        "plain_ms": k2_plain_ms,
        "bound_ms": k2_bound["ms"],
        "bound_by": k2_bound["by"],
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
