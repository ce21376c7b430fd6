"""Scene container: dataset detection, camera sets and model set-up (port
of `gaussianavatars_tpu/data/scene.py`; reference scene/__init__.py:31-166).
"""

from __future__ import annotations

import json
import os
import random
import shutil
from typing import Optional

from gaussianavatars_torch.data.cameras import Camera, camera_to_json
from gaussianavatars_torch.data.readers import (
    read_blender_scene,
    read_dynamic_nerf_scene,
)
from gaussianavatars_torch.utils.system import (  # noqa: F401
    search_for_max_iteration as search_max_iteration,
)


class Scene:
    def __init__(self, cfg, gaussians, load_iteration: Optional[int] = None,
                 shuffle: bool = True):
        """Read the dataset at `cfg.source_path` and set up `gaussians`.

        cfg: ModelConfig; gaussians: GaussianModel or FlameGaussianModel.
        The dataset type follows the sentinel files (reference
        scene/__init__.py:90-99): `canonical_flame_param.npz` marks
        DynamicNerf data, `transforms_train.json` Blender data; a `sparse/`
        folder (COLMAP) raises, its reader is not ported yet. With
        `load_iteration` (-1: the latest) the model is read from
        `<model_path>/point_cloud/iteration_N/point_cloud.ply`, else made
        from the scene (`create_from_pcd`). `shuffle` shuffles the training
        cameras with the process-global `random` (reference :79).
        """
        self.model_path = cfg.model_path
        self.gaussians = gaussians
        self.loaded_iter = None

        if load_iteration is not None:
            if load_iteration == -1:
                self.loaded_iter = search_max_iteration(
                    os.path.join(self.model_path, "point_cloud"))
            else:
                self.loaded_iter = load_iteration
            print(f"Loading trained model at iteration {self.loaded_iter}")

        src = cfg.source_path
        if os.path.exists(os.path.join(src, "sparse")):
            raise NotImplementedError(
                f"{src} is a COLMAP scene; the COLMAP reader "
                "(data/readers.py::read_colmap_scene, data/colmap.py) is not "
                "ported yet")
        if os.path.exists(os.path.join(src, "canonical_flame_param.npz")):
            print("Found canonical_flame_param.npz, assuming DynamicNerf data")
            info = read_dynamic_nerf_scene(
                src, cfg.white_background, cfg.eval,
                target_path=cfg.target_path)
        elif os.path.exists(os.path.join(src, "transforms_train.json")):
            print("Found transforms_train.json, assuming Blender data")
            info = read_blender_scene(src, cfg.white_background, cfg.eval)
        else:
            raise ValueError(f"Could not recognize scene type for {src}")
        self.scene_info = info

        if not self.loaded_iter:
            os.makedirs(self.model_path, exist_ok=True)
            if info.ply_path is not None:
                shutil.copyfile(info.ply_path,
                                os.path.join(self.model_path, "input.ply"))
            cam_json = [camera_to_json(i, cam) for i, cam in
                        enumerate(info.test_cameras + info.train_cameras)]
            with open(os.path.join(self.model_path, "cameras.json"), "w") as f:
                json.dump(cam_json, f)

        if shuffle:
            random.shuffle(info.train_cameras)

        self.cameras_extent = info.nerf_normalization["radius"]

        # optional camera filter (reference scene/__init__.py:124-128)
        if getattr(cfg, "select_camera_id", -1) != -1:
            info.train_cameras[:] = [
                c for c in info.train_cameras
                if c.camera_id == cfg.select_camera_id]

        self.train_cameras = info.train_cameras
        self.val_cameras = info.val_cameras
        self.test_cameras = info.test_cameras
        self.resolution_arg = cfg.resolution

        if hasattr(gaussians, "load_meshes") and (
                info.train_meshes or info.tgt_train_meshes):
            gaussians.load_meshes(info.train_meshes, info.test_meshes,
                                  info.tgt_train_meshes, info.tgt_test_meshes)

        if self.loaded_iter:
            gaussians.load_ply(
                os.path.join(self.model_path, "point_cloud",
                             f"iteration_{self.loaded_iter}",
                             "point_cloud.ply"),
                has_target=bool(cfg.target_path))
        else:
            gaussians.create_from_pcd(info.points, info.colors,
                                      self.cameras_extent)

    def get_train_cameras(self) -> list[Camera]:
        return self.train_cameras

    def get_val_cameras(self) -> list[Camera]:
        return self.val_cameras

    def get_test_cameras(self) -> list[Camera]:
        return self.test_cameras

    def save(self, iteration: int):
        path = os.path.join(self.model_path, "point_cloud",
                            f"iteration_{iteration}", "point_cloud.ply")
        self.gaussians.save_ply(path)
