"""Score rendered images against their ground truth (the port's counterpart
of the root `metrics.py`; reference metrics.py:36-103):

    python -m gaussianavatars_torch.metrics -m <model dir> [<model dir> ...] \\
        [--splits test val train] [--device cuda]

For every `<model dir>/<split>/<method>/` that `render` wrote, the PNGs of
`renders/` and `gt/` (read by `utils/png.py`, as RGB) are compared pair by
pair on the device: SSIM, PSNR and, when the LPIPS weights exist
(`metrics_lib/lpips.py`), LPIPS. Each model directory gets the root tool's
`results.json` ({method: {"SSIM", "PSNR"[, "LPIPS"]}}, the means) and
`per_view.json` ({method: {metric: {image name: value}}}). Without a GPU the
run raises unless --device is cpu.
"""

from __future__ import annotations

import json
import os
from argparse import ArgumentParser
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from gaussianavatars_torch.device import resolve_device
from gaussianavatars_torch.metrics_lib.lpips import LPIPS, lpips_available
from gaussianavatars_torch.ops.ssim import ssim
from gaussianavatars_torch.utils.image import psnr
from gaussianavatars_torch.utils.png import read_png


def read_rgb(path: Path) -> np.ndarray:
    """A PNG as float32 [3, H, W] in [0, 1]: gray repeated, alpha dropped
    (PIL's convert("RGB"), as the root tool reads them)."""
    arr = read_png(str(path))
    if arr.ndim == 2:
        arr = np.repeat(arr[..., None], 3, axis=-1)
    return np.ascontiguousarray(
        arr[..., :3].transpose(2, 0, 1), np.float32) / 255.0


def evaluate(model_paths, splits=("test",), device="cuda",
             lpips_fn=None) -> dict:
    """Score every method of `splits` in each of `model_paths` and write
    its results.json and per_view.json. `lpips_fn` (an `LPIPS`) is built
    from the default weights when not given, and left out with a warning
    when there are none. Returns {model path: results}."""
    dev = resolve_device(device)
    if lpips_fn is None and lpips_available():
        lpips_fn = LPIPS(device=dev)
    if lpips_fn is None:
        print("[warn] LPIPS weights unavailable; reporting SSIM/PSNR only")

    out = {}
    with ThreadPoolExecutor(os.cpu_count()) as pool:
        for scene_dir in model_paths:
            print("Scene:", scene_dir)
            full_dict, per_view = {}, {}
            for split in splits:
                split_dir = Path(scene_dir) / split
                if not split_dir.exists():
                    continue
                for method in sorted(os.listdir(split_dir)):
                    method_dir = split_dir / method
                    names = sorted(os.listdir(method_dir / "renders"))
                    renders = pool.map(read_rgb, [method_dir / "renders" / n
                                                  for n in names])
                    gts = pool.map(read_rgb, [method_dir / "gt" / n
                                              for n in names])
                    scores = {"SSIM": [], "PSNR": []}
                    if lpips_fn is not None:
                        scores["LPIPS"] = []
                    with torch.no_grad():
                        for i, (r, g) in enumerate(zip(renders, gts)):
                            r = torch.from_numpy(r).to(dev)
                            g = torch.from_numpy(g).to(dev)
                            scores["SSIM"].append(ssim(r, g))
                            scores["PSNR"].append(psnr(r, g)[0])
                            if lpips_fn is not None:
                                scores["LPIPS"].append(lpips_fn(r, g)[0])
                            if (i + 1) % 50 == 0 or i + 1 == len(names):
                                print(f"  {split}/{method}: {i + 1}/"
                                      f"{len(names)}")
                    scores = {k: torch.stack(v).cpu().numpy().tolist()
                              if v else [] for k, v in scores.items()}
                    full_dict[method] = {k: float(np.mean(v))
                                         for k, v in scores.items()}
                    per_view[method] = {k: dict(zip(names, v))
                                        for k, v in scores.items()}
                    for k, v in full_dict[method].items():
                        print(f"  {k:<5}: {v:>12.7f}")

            with open(os.path.join(scene_dir, "results.json"), "w") as f:
                json.dump(full_dict, f, indent=True)
            with open(os.path.join(scene_dir, "per_view.json"), "w") as f:
                json.dump(per_view, f, indent=True)
            out[scene_dir] = full_dict
    return out


def main(argv=None) -> dict:
    parser = ArgumentParser(description="Metric evaluation parameters")
    parser.add_argument("--model_paths", "-m", required=True, nargs="+",
                        type=str, default=[])
    parser.add_argument("--splits", nargs="+", type=str,
                        default=["test", "val", "train"])
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    return evaluate(args.model_paths, args.splits, args.device)


if __name__ == "__main__":
    main()
