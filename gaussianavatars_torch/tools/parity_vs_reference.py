"""Numeric parity harness against the reference implementation (port of
the root `tools/parity_vs_reference.py`).

The reference's FLAME pickles and trained avatars are license-gated
downloads (reference doc/download.md:5-10), so this is the ready-to-run
harness for when they are present:

  1. `--check_assets DIR`: structural checks of the real FLAME assets
     (vertex and face counts with the teeth, the teeth faces' sha256), the
     invariants a saved binding depends on (reference
     flame_model/flame.py:228-253, 480-483).
  2. `--point_path PLY`: load a point_cloud.ply (and the flame_param.npz
     beside it), render the exchange cameras at 802x550 and write the
     renders and the per-Gaussian gradients of a fixed probe loss to
     `--out`.
  3. `--compare DIR_A DIR_B`: diff two dumps (this tool's, the JAX tool's,
     or one made by `tools/reference_side_dump.py` inside the reference's
     own CUDA environment): per view max|d| and PSNR, per gradient the
     relative max|d|, against the BASELINE.md correctness target.
  4. `--self_check`: the card's gate of kernels K1 / K2 against their
     plain PyTorch versions on the bench scene (the JAX tool's
     Pallas-against-jnp gate).

Exchange format: <out>/view_<i>.npy (float32 [3, H, W] render),
<out>/grads.npz (d_xyz, d_opacity, d_scaling, d_rotation, d_f_dc as
[N, 1, 3]) and <out>/manifest.json (camera matrices, shapes). The cameras
are a fixed 8-view orbit.

    python -m gaussianavatars_torch.tools.parity_vs_reference \\
        [--check_assets DIR] [--point_path PLY --out DIR] \\
        [--compare DIR_A DIR_B] [--self_check] [--binning dense|sort] \\
        [--device cuda]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import math
import os
import sys

import numpy as np
import torch

WIDTH, HEIGHT = 802, 550
N_VIEWS = 8
PROBE_SEED = 123
GRAD_KEYS = ("xyz", "opacity", "scaling", "rotation", "features_dc")
# --compare: the BASELINE.md target; --self_check: the JAX tool's gate
VIEW_MAX_ABS, VIEW_MIN_PSNR, GRAD_REL = 2e-2, 45.0, 1e-2
SELF_IMAGE_MAX_ABS, SELF_GRAD_REL = 2e-3, 5e-4


def exchange_cameras() -> list[dict]:
    """The fixed orbit: N_VIEWS yaw angles, radius 1, fovy 20 degrees (the
    reference demo benchmark's camera)."""
    from gaussianavatars_torch.viewer.orbit_camera import OrbitCamera

    cams = []
    for i in range(N_VIEWS):
        cam = OrbitCamera(WIDTH, HEIGHT, r=1.0, fovy=20.0,
                          convention="opencv",
                          save_path="/nonexistent_camera.json")
        cam.orbit_y(2.0 * math.pi * i / N_VIEWS)
        cams.append({
            "world_view_transform": cam.world_view_transform.T.tolist(),
            "full_proj_transform": cam.full_proj_transform.T.tolist(),
            "fovx": math.radians(cam.fovx), "fovy": math.radians(cam.fovy),
            "znear": cam.znear, "zfar": cam.zfar,
        })
    return cams


def check_assets(asset_dir: str, device: str = "cuda") -> bool:
    """Structural invariants of the FLAME assets in `asset_dir`."""
    from gaussianavatars_torch.models.flame import (
        FlameHead,
        _teeth_strip_faces,
    )

    ok = True
    fu, fl = _teeth_strip_faces()
    h = hashlib.sha256(np.ascontiguousarray(
        np.concatenate([fu, fl])).astype(np.int64).tobytes()).hexdigest()
    expect = "c68158e59906bf9dd28654a0058caa7b60d8ee7561590de4b405aa78ec6dbd13"
    print(f"teeth-strip sha256: {h} "
          f"({'OK' if h == expect else 'MISMATCH vs reference tables'})")
    ok &= h == expect

    head = FlameHead(
        300, 100,
        flame_model_path=os.path.join(asset_dir, "flame2023.pkl"),
        flame_template_mesh_path=os.path.join(asset_dir,
                                              "head_template_mesh.obj"),
        device=device,
        flame_lmk_embedding_path=os.path.join(
            asset_dir, "landmark_embedding_with_eyes.npy"),
        flame_parts_path=os.path.join(asset_dir, "FLAME_masks.pkl"))
    checks = {
        "num_verts (5023+120)": (head.num_verts, 5143),
        "num_faces (9976+168)": (head.num_faces, 10144),
        "shapedirs": (tuple(head.shapedirs.shape), (5143, 3, 400)),
        "lbs_weights": (tuple(head.lbs_weights.shape), (5143, 5)),
    }
    for name, (got, want) in checks.items():
        good = got == want
        ok &= good
        print(f"{name}: {got} ({'OK' if good else f'want {want}'})")
    return ok


def load_model(point_path: str, sh_degree: int, device: str = "cuda"):
    """A FLAME-bound model when flame_param.npz lies beside the PLY (the
    FLAME head from $FLAME_ASSET_DIR), else an unbound one."""
    from gaussianavatars_torch.device import resolve_device
    from gaussianavatars_torch.models.flame_gaussians import (
        FlameGaussianModel,
    )
    from gaussianavatars_torch.models.gaussians import GaussianModel

    dev = resolve_device(device)
    bound = os.path.exists(os.path.join(os.path.dirname(point_path),
                                        "flame_param.npz"))
    model = (FlameGaussianModel.from_assets(sh_degree, device=dev) if bound
             else GaussianModel(sh_degree, device=dev))
    model.load_ply(point_path)
    return model


def _mini_cam(c: dict, timestep: int):
    from gaussianavatars_torch.data.cameras import MiniCam

    return MiniCam(
        width=WIDTH, height=HEIGHT, fovx=c["fovx"], fovy=c["fovy"],
        znear=c["znear"], zfar=c["zfar"],
        world_view_transform=np.asarray(c["world_view_transform"]),
        full_proj_transform=np.asarray(c["full_proj_transform"]),
        timestep=timestep)


def dump(model, out_dir: str, timestep: int = 0, binning: str = "dense"):
    """Render the exchange cameras and the probe gradients with
    `make_render_fn` on the model's device; write the dump."""
    from gaussianavatars_torch.config import PipelineConfig
    from gaussianavatars_torch.models.gaussians import GaussianParams
    from gaussianavatars_torch.train.loop import camera_arrays, make_render_fn

    os.makedirs(out_dir, exist_ok=True)
    dev = model.device
    bound = getattr(model, "binding", None) is not None
    cams = exchange_cameras()
    render = make_render_fn(model, PipelineConfig(binning=binning), WIDTH,
                            HEIGHT, model.active_sh_degree,
                            differentiable=True)
    flame_param = dict(model.flame_param) if bound else {}
    binding = model.binding if bound else None
    bg = torch.ones(3, device=dev)

    for i, c in enumerate(cams):
        with torch.no_grad():
            img = render(model.params, flame_param, binding,
                         camera_arrays(_mini_cam(c, timestep).to_params(dev)),
                         bg, timestep).image
        np.save(os.path.join(out_dir, f"view_{i}.npy"),
                img.cpu().numpy().astype(np.float32))
        print(f"rendered view {i}")

    # probe gradients: sum((render - probe)^2) on view 0, a fixed stand-in
    # for a training step's image loss
    rng = np.random.default_rng(PROBE_SEED)
    probe = torch.as_tensor(rng.random((3, HEIGHT, WIDTH)).astype(np.float32),
                            device=dev)
    params = GaussianParams(*[p.detach().requires_grad_()
                              for p in model.params])
    img = render(params, flame_param, binding,
                 camera_arrays(_mini_cam(cams[0], timestep).to_params(dev)),
                 bg, timestep).image
    leaves = [getattr(params, k) for k in GRAD_KEYS]
    g = dict(zip(GRAD_KEYS, torch.autograd.grad(
        torch.sum((img - probe) ** 2), leaves, allow_unused=True)))
    g = {k: (torch.zeros_like(x) if g[k] is None else g[k]).cpu().numpy()
         for k, x in zip(GRAD_KEYS, leaves)}
    n = params.xyz.shape[0]
    np.savez(
        os.path.join(out_dir, "grads.npz"),
        d_xyz=g["xyz"], d_opacity=g["opacity"], d_scaling=g["scaling"],
        d_rotation=g["rotation"],
        # the reference dumps _features_dc.grad as [N, 1, 3]; the port's
        # parameter is flat [N, 3] (models/gaussians.py::GaussianParams)
        d_f_dc=g["features_dc"].reshape(n, 1, 3))
    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump({
            "width": WIDTH, "height": HEIGHT, "n_gaussians": int(n),
            "timestep": timestep, "probe_seed": PROBE_SEED,
            "cameras": cams,
        }, f, indent=2)
    print(f"dump written to {out_dir}")


def compare(dir_a: str, dir_b: str) -> bool:
    """Diff two dumps; True when within the BASELINE.md tolerances (per
    view max|d| < 2e-2 and PSNR > 45 dB, per gradient max|d| / max|b| <
    1e-2)."""
    ok = True
    for i in range(N_VIEWS):
        pa = os.path.join(dir_a, f"view_{i}.npy")
        pb = os.path.join(dir_b, f"view_{i}.npy")
        if not (os.path.exists(pa) and os.path.exists(pb)):
            print(f"view {i}: missing "
                  f"({pa if not os.path.exists(pa) else pb})")
            ok = False
            continue
        d = np.abs(np.load(pa) - np.load(pb))
        mse = float((d ** 2).mean())
        psnr = 10 * math.log10(1.0 / max(mse, 1e-12))
        good = d.max() < VIEW_MAX_ABS and psnr > VIEW_MIN_PSNR
        ok &= good
        print(f"view {i}: max|d|={d.max():.2e} psnr={psnr:.1f} dB "
              f"{'OK' if good else 'DIVERGES'}")
    ga = np.load(os.path.join(dir_a, "grads.npz"))
    gb = np.load(os.path.join(dir_b, "grads.npz"))
    for k in ga.files:
        if k not in gb.files:
            print(f"{k}: missing in {dir_b}")
            ok = False
            continue
        d = np.abs(ga[k] - gb[k]).max()
        scale = max(np.abs(gb[k]).max(), 1e-12)
        good = d / scale < GRAD_REL
        ok &= good
        print(f"{k}: max|d|={d:.3e} (rel {d / scale:.2e}) "
              f"{'OK' if good else 'DIVERGES'}")
    return ok


def self_check(binning: str = "dense", device: str = "cuda"):
    """Kernels K1 / K2 against their plain versions on the same CUDA
    tensors: the bench scene (`benchmark.make_bench_scene`, 100,000
    Gaussians) at 802x550, tile 32. The image's max|d| must be <= 2e-3 and,
    for the loss sum(image * w) with a fixed normal w, each scene leaf's
    gradient max|d| / max|plain| <= 5e-4 (the JAX tool's gate: deep
    float32 front-to-back blending sums in another order). Returns (ok,
    image max|d|, worst gradient relative max|d|)."""
    from gaussianavatars_torch.benchmark import (
        SH_DEGREE,
        bench_camera,
        blend_inputs,
        make_bench_scene,
    )
    from gaussianavatars_torch.device import resolve_device
    from gaussianavatars_torch.ops import tile_blend

    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("the self check holds the CUDA kernels against "
                         "their plain versions; it needs device 'cuda'")
    print(f"[self_check] {torch.cuda.get_device_name(dev)}, binning "
          f"{binning}")
    scene = {k: v.requires_grad_() for k, v in
             make_bench_scene(device=dev).items()}
    with torch.enable_grad():
        inst, ranges, args = blend_inputs(scene, bench_camera(device=dev), 32,
                                          SH_DEGREE, binning=binning)
    bg = torch.ones(3, device=dev)
    w = torch.as_tensor(np.random.default_rng(PROBE_SEED).normal(
        size=(3, HEIGHT, WIDTH)).astype(np.float32), device=dev)
    g_trans = (w * bg[:, None, None]).sum(0)
    out = {}
    for name, fwd, bwd in (
            ("kernels", tile_blend.blend_image_cuda,
             tile_blend.blend_image_bwd_cuda),
            ("plain", tile_blend.blend_image_plain,
             tile_blend.blend_image_bwd_plain)):
        x = inst.detach()
        color, trans = fwd(x, ranges, *args)
        g_inst = bwd(x, ranges, *args, color, trans, w, g_trans)
        grads = torch.autograd.grad(inst, list(scene.values()), g_inst,
                                    retain_graph=True)
        out[name] = (color + trans[None] * bg[:, None, None],
                     dict(zip(scene, grads)))
    img_d = float((out["kernels"][0] - out["plain"][0]).abs().max())
    ok = img_d <= SELF_IMAGE_MAX_ABS
    print(f"[self_check] {inst.shape[0]} instances; image max|d| "
          f"kernels-vs-plain: {img_d:.3e} {'OK' if ok else 'DIVERGES'}")
    worst = 0.0
    for k in scene:
        g1, g2 = out["kernels"][1][k], out["plain"][1][k]
        scale = float(g2.abs().max()) or 1.0
        rd = float((g1 - g2).abs().max()) / scale
        good = rd <= SELF_GRAD_REL
        ok &= good
        worst = max(worst, rd)
        print(f"[self_check] grad rel max|d| {k}: {rd:.2e} "
              f"{'OK' if good else 'DIVERGES'}")
    return ok, img_d, worst


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--check_assets", type=str, default=None,
                    help="FLAME asset dir with the real downloads")
    ap.add_argument("--point_path", type=str, default=None)
    ap.add_argument("--sh_degree", type=int, default=3)
    ap.add_argument("--timestep", type=int, default=0)
    ap.add_argument("--out", type=str, default="parity_dump")
    ap.add_argument("--compare", nargs=2, metavar=("DIR_A", "DIR_B"),
                    default=None)
    ap.add_argument("--self_check", action="store_true",
                    help="K1 / K2 against their plain versions, image and "
                         "gradients, on the 100k bench scene at 802x550")
    ap.add_argument("--binning", default="dense", choices=("dense", "sort"),
                    help="the instance stream of --point_path and "
                         "--self_check; it serves a check of the port's two "
                         "binnings (a dense dump against a sort dump of the "
                         "same model), not the reference comparison")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    ok = True
    if args.check_assets:
        ok &= check_assets(args.check_assets, args.device)
    if args.point_path:
        model = load_model(args.point_path, args.sh_degree, args.device)
        dump(model, args.out, args.timestep, args.binning)
    if args.compare:
        ok &= compare(*args.compare)
    if args.self_check:
        ok &= self_check(args.binning, args.device)[0]
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
