"""Render a trained avatar offline (the port's counterpart of the root
`render.py`; reference render.py:104-146):

    python -m gaussianavatars_torch.render -m <model> [--iteration N] \\
        [--skip_train] [--skip_val] [--skip_test] [--render_mesh] \\
        [-t <target dataset>] [--device cuda]

The flags are the root tool's: the ModelConfig group (defaults filled in
from the run's cfg.json), the PipelineConfig group, --iteration (default
-1, the latest), --skip_train, --skip_val, --skip_test, --quiet and
--render_mesh, plus --device (default cuda; without a GPU the run raises
unless it is cpu). Each split, or with --target_path the target's cameras
and FLAME motion (reenactment), goes to
`<model>/<split or target name>[_<camera id>]/ours_<iteration>/` as
`renders/`, `gt/` and, with --render_mesh, `renders_mesh/` (the FLAME mesh
over the ground truth), one `%05d.png` per camera. Pixels are
clip(image * 255 + 0.5) as uint8, as the root tool writes them; PNGs are
encoded by `utils/png.py` on a thread pool, and `renders.mp4` / `gt.mp4`
are assembled when `ffmpeg` is on the PATH.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import os
import shutil
import subprocess
import time
from argparse import ArgumentParser
from pathlib import Path

import numpy as np
import torch

from gaussianavatars_torch.config import (
    ModelConfig,
    PipelineConfig,
    get_combined_config,
)
from gaussianavatars_torch.data.loader import iterate_once
from gaussianavatars_torch.data.scene import Scene
from gaussianavatars_torch.device import resolve_device
from gaussianavatars_torch.models.flame_gaussians import FlameGaussianModel
from gaussianavatars_torch.models.gaussians import GaussianModel
from gaussianavatars_torch.render.mesh_renderer import render_mesh_overlay
from gaussianavatars_torch.train.loop import camera_arrays, make_render_fn
from gaussianavatars_torch.utils.png import write_png


def to_uint8(img: torch.Tensor) -> torch.Tensor:
    """[3, H, W] in [0, 1] to [H, W, 3] uint8 on the same device:
    clip(img * 255 + 0.5, 0, 255) truncated, the root tool's rounding."""
    return (img * 255.0 + 0.5).clamp(0.0, 255.0).to(torch.uint8).permute(
        1, 2, 0)


def _write(path: Path, pixels: np.ndarray) -> float:
    """Encode and write one PNG; returns the seconds it took."""
    t0 = time.perf_counter()
    path.parent.mkdir(parents=True, exist_ok=True)
    write_png(str(path), pixels)
    return time.perf_counter() - t0


def render_set(model_cfg: ModelConfig, pipe_cfg: PipelineConfig, name: str,
               iteration: int, cameras: list, model,
               render_mesh: bool = False) -> dict:
    """Render `cameras` with `model` (on its device) into
    `<model_path>/<name>[_<camera id>]/ours_<iteration>/`. Returns the
    counts and seconds: images, render_s (render and copy to the host, per
    split), mesh_s (the overlays), write_s (PNG encoding summed over the
    pool's threads) and wall_s."""
    if model_cfg.select_camera_id != -1:
        name = f"{name}_{model_cfg.select_camera_id}"
    iter_path = Path(model_cfg.model_path) / name / f"ours_{iteration}"
    dev = model.device
    bound = model.binding is not None
    flame_param = model.flame_param if bound else {}

    render_fns, bgs, futures = {}, {}, []
    stats = dict(images=0, render_s=0.0, mesh_s=0.0, write_s=0.0)
    t_start = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(os.cpu_count()) as pool:
        for idx, (cam, gt) in enumerate(
                iterate_once(cameras, model_cfg.resolution)):
            t0 = time.perf_counter()
            w, h = cam.resolution(model_cfg.resolution)
            if (w, h) not in render_fns:
                render_fns[w, h] = make_render_fn(
                    model, pipe_cfg, w, h, model.active_sh_degree)
            bg = bgs.get(cam.bg.tobytes())
            if bg is None:
                bg = bgs[cam.bg.tobytes()] = torch.tensor(
                    cam.bg, dtype=torch.float32, device=dev)
            params = cam.to_params(w, h, device=dev)
            img = render_fns[w, h](
                model.params, flame_param, model.binding,
                camera_arrays(params), bg, cam.timestep or 0).image
            pixels = to_uint8(img.clamp(0.0, 1.0)).cpu().numpy()
            stats["render_s"] += time.perf_counter() - t0
            fname = f"{idx:05d}.png"
            futures.append(pool.submit(_write, iter_path / "renders" / fname,
                                       pixels))
            futures.append(pool.submit(
                _write, iter_path / "gt" / fname,
                np.clip(gt * 255.0 + 0.5, 0, 255).astype(
                    np.uint8).transpose(1, 2, 0)))
            if render_mesh and bound:
                t0 = time.perf_counter()
                with torch.no_grad():
                    verts = model.verts_at(flame_param, cam.timestep or 0)
                overlay = render_mesh_overlay(
                    verts[0], model.flame_model.faces, params,
                    background=torch.tensor(gt, device=dev), opacity=0.5)
                overlay = to_uint8(overlay).cpu().numpy()
                stats["mesh_s"] += time.perf_counter() - t0
                futures.append(pool.submit(
                    _write, iter_path / "renders_mesh" / fname, overlay))
            stats["images"] += 1
        stats["write_s"] = sum(f.result() for f in futures)
    stats["wall_s"] = time.perf_counter() - t_start

    if shutil.which("ffmpeg"):
        for sub, out in (("renders", "renders.mp4"), ("gt", "gt.mp4")):
            subprocess.run(
                ["ffmpeg", "-y", "-framerate", "25", "-f", "image2",
                 "-pattern_type", "glob", "-i", f"{iter_path / sub}/*.png",
                 "-pix_fmt", "yuv420p", str(iter_path / out)],
                check=False, capture_output=True)
    print(f"[render] {name}: {stats['images']} images in "
          f"{stats['wall_s']:.2f} s")
    return stats


def main(argv=None) -> dict:
    """Run the tool; returns {set name: `render_set` stats}."""
    parser = ArgumentParser(description="Testing script parameters")
    ModelConfig.add_to_parser(parser, sentinel=True)
    PipelineConfig.add_to_parser(parser)
    parser.add_argument("--iteration", default=-1, type=int)
    parser.add_argument("--skip_train", action="store_true")
    parser.add_argument("--skip_val", action="store_true")
    parser.add_argument("--skip_test", action="store_true")
    parser.add_argument("--quiet", action="store_true", help="print nothing")
    parser.add_argument("--render_mesh", action="store_true")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    args = get_combined_config(parser, argv)
    dev = resolve_device(args.device)
    model_cfg = ModelConfig.extract(args)
    pipe_cfg = PipelineConfig.extract(args)
    results = {}
    with contextlib.ExitStack() as stack:
        if args.quiet:
            stack.enter_context(contextlib.redirect_stdout(
                stack.enter_context(open(os.devnull, "w"))))
        print("Rendering " + model_cfg.model_path)
        if model_cfg.bind_to_mesh:
            model = FlameGaussianModel.from_assets(model_cfg.sh_degree,
                                                   device=dev)
        else:
            model = GaussianModel(model_cfg.sh_degree, device=dev)
        scene = Scene(model_cfg, model, load_iteration=args.iteration,
                      shuffle=False)

        if model_cfg.target_path:
            sets = [(os.path.basename(os.path.normpath(
                model_cfg.target_path)), scene.get_train_cameras())]
        else:
            sets = [(split, cams) for split, cams, skip in (
                ("train", scene.get_train_cameras(), args.skip_train),
                ("val", scene.get_val_cameras(), args.skip_val),
                ("test", scene.get_test_cameras(), args.skip_test))
                if not skip]
        for name, cameras in sets:
            results[name] = render_set(model_cfg, pipe_cfg, name,
                                       scene.loaded_iter, cameras, model,
                                       args.render_mesh)
    return results


if __name__ == "__main__":
    main()
