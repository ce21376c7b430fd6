"""Shared inputs of the port's loop tests: a DynamicNerf dataset on the
synthetic FLAME head, written by the port's own dataset writer."""

import numpy as np

from gaussianavatars_torch.benchmark import (
    bench_meshes,
    make_flame_assets,
    write_avatar_dataset,
)

W, H = 96, 72


def make_port_avatar_dataset(root):
    """2 timesteps, 2 training cameras each plus one val and one test
    camera, noise images at 96x72. The cameras sit close (distance 0.3),
    so that the head's 10,144 initial Gaussians spread over the 16-pixel
    tiles and the port's plain CPU blend stays quick. Returns
    (dataset_dir, flame_asset_dir)."""
    assets = f"{root}/assets"
    make_flame_assets(assets, seed=0)
    data = write_avatar_dataset(f"{root}/data",
                                bench_meshes(np.random.default_rng(0), 2),
                                W, H, n_train_cams=2, dist=0.3)
    return data, assets
