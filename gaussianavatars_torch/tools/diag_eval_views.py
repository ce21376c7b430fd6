"""Per-view evaluation diagnostics of a bound-avatar recovery run (port of
the root `tools/diag_eval_views.py`): renders every val and test view of
the run's latest PLY, prints each view's PSNR with its (split, timestep,
camera), worst first, and writes render / ground truth / error PNGs of the
worst views.

    python -m gaussianavatars_torch.tools.diag_eval_views \\
        --run <bound_avatar_recovery --out dir> --out <dir> [--worst 4] \\
        [--device cuda]

The run directory holds `data/`, `assets/` and `out/`, as
`examples/bound_avatar_recovery.py` writes them. The configuration is the
protocol's (SH degree 2, every degree active, white background, the eval
splits); the PSNR is `evaluate_splits`' (the clamped render against the
clamped ground truth, on the device). PNG pixels are the JAX tool's:
uint8(image * 255), and the error image uint8(clip(4 * mean_c |d|) * 255),
written by `utils/png.py`. A view without a camera id shows -1 (the JAX
tool shows -1 for camera 0 as well).
"""

from __future__ import annotations

import os
from argparse import ArgumentParser

import numpy as np
import torch


def view_psnrs(run: str, device: str = "cuda") -> list[tuple]:
    """(split, timestep, camera id, PSNR, render [3, H, W], ground truth
    [3, H, W]) of every val and test view of the run, in the splits'
    order; the images are clamped float32 numpy arrays."""
    from gaussianavatars_torch.config import ModelConfig, PipelineConfig
    from gaussianavatars_torch.data.loader import iterate_once
    from gaussianavatars_torch.data.scene import Scene
    from gaussianavatars_torch.device import resolve_device
    from gaussianavatars_torch.models.flame_gaussians import (
        FlameGaussianModel,
    )
    from gaussianavatars_torch.train.loop import camera_arrays, make_render_fn
    from gaussianavatars_torch.utils.image import psnr

    dev = resolve_device(device)
    model_cfg = ModelConfig(source_path=os.path.join(run, "data"),
                            model_path=os.path.join(run, "out"),
                            bind_to_mesh=True, eval=True, sh_degree=2,
                            white_background=True)
    pipe_cfg = PipelineConfig()
    model = FlameGaussianModel.from_assets(
        model_cfg.sh_degree, asset_dir=os.path.join(run, "assets"),
        device=dev)
    scene = Scene(model_cfg, model, load_iteration=-1, shuffle=False)
    print(f"loaded iteration {scene.loaded_iter} model: "
          f"n={model.num_gaussians}, sh={model.active_sh_degree}")
    model.active_sh_degree = model.max_sh_degree

    render_fns, rows = {}, []
    for split, cams in (("val", scene.get_val_cameras()),
                        ("test", scene.get_test_cameras())):
        for cam, gt in iterate_once(cams, model_cfg.resolution, device=dev):
            w, h = cam.resolution(model_cfg.resolution)
            if (w, h) not in render_fns:
                render_fns[w, h] = make_render_fn(model, pipe_cfg, w, h,
                                                  model.active_sh_degree)
            img = render_fns[w, h](
                model.params, model.flame_param, model.binding,
                camera_arrays(cam.to_params(w, h, device=dev)),
                torch.tensor(cam.bg, dtype=torch.float32, device=dev),
                cam.timestep or 0).image.clamp(0.0, 1.0)
            gt_t = torch.tensor(gt, device=dev).clamp(0.0, 1.0)
            rows.append((split, int(cam.timestep or 0),
                         -1 if cam.camera_id is None else int(cam.camera_id),
                         float(psnr(img, gt_t)[0]), img.cpu().numpy(),
                         gt_t.cpu().numpy()))
    return rows


def write_worst(rows: list[tuple], out: str, worst: int) -> list[str]:
    """The PNG triples `worst<i>_<split>_t<t>_c<cam>_{render,gt,err}.png`
    of the `worst` lowest-PSNR rows; returns the paths written."""
    from gaussianavatars_torch.utils.png import write_png

    os.makedirs(out, exist_ok=True)
    paths = []
    for i, (split, t, c, _, img, gt) in enumerate(
            sorted(rows, key=lambda r: r[3])[:worst]):
        base = os.path.join(out, f"worst{i}_{split}_t{t}_c{c}")
        err = np.clip(np.abs(img - gt).mean(0) * 4, 0, 1)
        for suffix, arr in (("render", img.transpose(1, 2, 0)),
                            ("gt", gt.transpose(1, 2, 0)), ("err", err)):
            paths.append(f"{base}_{suffix}.png")
            write_png(paths[-1], (arr * 255).astype(np.uint8))
    return paths


def main(argv=None) -> list[tuple]:
    ap = ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--run", required=True,
                    help="bound_avatar_recovery --out dir (has data/, "
                         "assets/, out/)")
    ap.add_argument("--out", default="diag_views")
    ap.add_argument("--worst", type=int, default=4)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    rows = view_psnrs(args.run, args.device)
    print(f"{'split':5} {'t':>2} {'cam':>4} {'psnr':>7}")
    for split, t, c, p_db, _, _ in sorted(rows, key=lambda r: r[3]):
        print(f"{split:5} {t:>2} {c:>4} {p_db:7.2f}")
    write_worst(rows, args.out, args.worst)
    print(f"wrote {min(args.worst, len(rows))} worst-view image triples "
          f"to {args.out}")
    return rows


if __name__ == "__main__":
    main()
