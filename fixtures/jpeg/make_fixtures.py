"""Write the JPEG fixtures of this directory and, beside each, PIL's
decoded pixels: as a PNG (`<name>.png`) for the small files, and as the
SHA-256 of the uint8 [H, W, 3] array with its shape
(`bench_802x550.pil.json`) for the 802x550 render, whose pixels do not
fit the directory's 300 KB as a PNG.

    python fixtures/jpeg/make_fixtures.py

Needs PIL (the GPU host has none: the fixtures are committed) and the
port on the CPU, which renders the bench avatar for `bench_802x550.jpg`
(under a minute). Every image comes from a fixed seed; PIL writes each
JPEG with the quality and subsampling in FIXTURES.
"""

import hashlib
import json
import os
import sys

import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))

# name -> (width, height, PIL save options); subsampling 0 = 4:4:4,
# 1 = 4:2:2, 2 = 4:2:0
FIXTURES = {
    "rgb444_33x17.jpg": (33, 17, dict(quality=90, subsampling=0)),
    "rgb422_33x17.jpg": (33, 17, dict(quality=90, subsampling=1)),
    "rgb420_37x29.jpg": (37, 29, dict(quality=75, subsampling=2)),
    "gray_45x29.jpg": (45, 29, dict(quality=85)),
    "restart_57x41.jpg": (57, 41, dict(quality=75, subsampling=2,
                                       restart_marker_blocks=2)),
    "progressive_48x40.jpg": (48, 40, dict(quality=80, progressive=True)),
    "bench_802x550.jpg": (802, 550, dict(quality=90, subsampling=2)),
}


def synthetic(width, height, seed):
    """Smooth colour waves with noise: edges for the chroma filters."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:height, 0:width]
    img = np.stack([128 + 100 * np.sin(x / 5.0 + c) * np.cos(y / 4.0 - c)
                    for c in range(3)], -1)
    img += rng.normal(0, 25, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def bench_render(width, height):
    """The bound bench avatar (101,440 Gaussians) from the bench camera on
    a white background, rendered by the port on the CPU."""
    import torch

    from gaussianavatars_torch.benchmark import (
        bench_camera, make_bound_bench_model,
    )
    from gaussianavatars_torch.config import PipelineConfig
    from gaussianavatars_torch.train.loop import camera_arrays, make_render_fn

    model = make_bound_bench_model(device="cpu")
    render = make_render_fn(model, PipelineConfig(), width, height, 3)
    img = render(model.params, model.flame_param, model.binding,
                 camera_arrays(bench_camera(width, height, device="cpu")),
                 torch.ones(3), 0).image.clamp(0.0, 1.0)
    return (img * 255.0 + 0.5).to(torch.uint8).permute(1, 2, 0).numpy()


def pixel_digest(pixels: np.ndarray) -> dict:
    return {"shape": list(pixels.shape),
            "sha256": hashlib.sha256(np.ascontiguousarray(
                pixels, np.uint8).tobytes()).hexdigest()}


def main():
    for seed, (name, (w, h, opts)) in enumerate(sorted(FIXTURES.items())):
        if name.startswith("bench"):
            img = bench_render(w, h)
        else:
            img = synthetic(w, h, seed)
            if name.startswith("gray"):
                img = img[..., 1]
        path = os.path.join(HERE, name)
        Image.fromarray(img).save(path, "JPEG", **opts)
        with Image.open(path) as im:
            pixels = np.asarray(im)
        if name.startswith("bench"):
            with open(path[:-4] + ".pil.json", "w") as f:
                json.dump(pixel_digest(pixels), f)
        else:
            Image.fromarray(pixels).save(path[:-4] + ".png")
        print(name, os.path.getsize(path), "bytes", pixels.shape)


if __name__ == "__main__":
    main()
