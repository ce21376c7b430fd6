"""Dataset readers: COLMAP, Blender-synthetic and DynamicNerf (FLAME
avatar) scenes (port of `gaussianavatars_tpu/data/readers.py`; reference
scene/dataset_readers.py:42-358). Return host-side `SceneInfo` records;
pixels load later, in the data loader. Image sizes come from the file
headers (`utils/png.py::image_size`), so a COLMAP scene of JPEGs reads,
although its views raise when the loader reaches them.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

import numpy as np

from gaussianavatars_torch.data.cameras import Camera
from gaussianavatars_torch.data.colmap import (
    qvec2rotmat,
    read_cameras_binary,
    read_cameras_text,
    read_images_binary,
    read_images_text,
    read_points3d_binary,
    read_points3d_text,
)
from gaussianavatars_torch.ops.transforms import focal2fov, fov2focal
from gaussianavatars_torch.utils import ply as plyio
from gaussianavatars_torch.utils.png import image_size, png_size


@dataclass
class SceneInfo:
    """reference scene/dataset_readers.py:42-52."""

    train_cameras: list
    test_cameras: list
    nerf_normalization: dict
    points: Optional[np.ndarray] = None
    colors: Optional[np.ndarray] = None
    ply_path: Optional[str] = None
    val_cameras: list = field(default_factory=list)
    train_meshes: dict = field(default_factory=dict)
    test_meshes: dict = field(default_factory=dict)
    tgt_train_meshes: dict = field(default_factory=dict)
    tgt_test_meshes: dict = field(default_factory=dict)


def get_nerfpp_norm(cameras: list[Camera]) -> dict:
    """Camera-extent normalization (reference dataset_readers.py:54-75)."""
    centers = []
    for cam in cameras:
        w2c = np.zeros((4, 4))
        w2c[:3, :3] = cam.R.T
        w2c[:3, 3] = cam.T
        w2c[3, 3] = 1.0
        c2w = np.linalg.inv(w2c)
        centers.append(c2w[:3, 3:4])
    centers = np.hstack(centers)
    avg = centers.mean(axis=1, keepdims=True)
    diagonal = np.linalg.norm(centers - avg, axis=0).max()
    return {"translate": -avg.flatten(), "radius": diagonal * 1.1}


def read_colmap_scene(path: str, images_dir: str = "images",
                      eval_split: bool = False,
                      llffhold: int = 8) -> SceneInfo:
    """A COLMAP scene (reference :142-187): `sparse/0/{cameras,images}`
    as `.bin`, else `.txt`; SIMPLE_PINHOLE and PINHOLE cameras only
    (undistort others first); cameras sorted by image name, every
    `llffhold`-th one a test camera with `eval_split`; the points from
    `sparse/0/points3D.ply`, written once from `points3D.bin` or `.txt`."""
    sparse = os.path.join(path, "sparse/0")
    try:
        extr = read_images_binary(os.path.join(sparse, "images.bin"))
        intr = read_cameras_binary(os.path.join(sparse, "cameras.bin"))
    except FileNotFoundError:
        extr = read_images_text(os.path.join(sparse, "images.txt"))
        intr = read_cameras_text(os.path.join(sparse, "cameras.txt"))

    cams = []
    for key in extr:
        im = extr[key]
        cam = intr[im.camera_id]
        if cam.model == "SIMPLE_PINHOLE":
            fovx = focal2fov(cam.params[0], cam.width)
            fovy = focal2fov(cam.params[0], cam.height)
        elif cam.model == "PINHOLE":
            fovx = focal2fov(cam.params[0], cam.width)
            fovy = focal2fov(cam.params[1], cam.height)
        else:
            raise ValueError(f"unsupported COLMAP camera model {cam.model}: "
                             "undistort first")
        image_path = os.path.join(path, images_dir, os.path.basename(im.name))
        width, height = image_size(image_path)
        cams.append(Camera(
            uid=cam.id, R=qvec2rotmat(im.qvec).T, T=np.array(im.tvec),
            fovx=fovx, fovy=fovy, width=width, height=height,
            image_path=image_path,
            image_name=os.path.basename(image_path).split(".")[0]))
    cams.sort(key=lambda c: c.image_name)

    if eval_split:
        train = [c for i, c in enumerate(cams) if i % llffhold != 0]
        test = [c for i, c in enumerate(cams) if i % llffhold == 0]
    else:
        train, test = cams, []

    ply_path = os.path.join(sparse, "points3D.ply")
    if not os.path.exists(ply_path):
        try:
            xyz, rgb, _ = read_points3d_binary(
                os.path.join(sparse, "points3D.bin"))
        except FileNotFoundError:
            xyz, rgb, _ = read_points3d_text(
                os.path.join(sparse, "points3D.txt"))
        plyio.store_point_cloud(ply_path, xyz, rgb)
    points, colors, _ = plyio.fetch_point_cloud(ply_path)
    return SceneInfo(train_cameras=train, test_cameras=test,
                     nerf_normalization=get_nerfpp_norm(train),
                     points=points, colors=colors, ply_path=ply_path)


def read_cameras_from_transforms(path: str, transforms_file: str,
                                 white_background: bool,
                                 extension: str = ".png") -> list[Camera]:
    """Cameras of a transforms.json (reference :189-245); the image size
    comes from the frame's `w`/`h` or from the PNG header."""
    cams = []
    with open(os.path.join(path, transforms_file)) as f:
        contents = json.load(f)
    fovx_shared = contents.get("camera_angle_x")

    for idx, frame in enumerate(contents["frames"]):
        file_path = frame["file_path"]
        if extension not in file_path:
            file_path += extension
        image_path = os.path.join(path, file_path)

        c2w = np.array(frame["transform_matrix"])
        # OpenGL/Blender (Y up, Z back) -> COLMAP (Y down, Z forward)
        c2w[:3, 1:3] *= -1
        w2c = np.linalg.inv(c2w)
        R = np.transpose(w2c[:3, :3])
        T = w2c[:3, 3]

        bg = (np.ones(3, np.float32) if white_background
              else np.zeros(3, np.float32))
        if "w" in frame and "h" in frame:
            width, height = frame["w"], frame["h"]
        else:
            width, height = png_size(image_path)

        fovx = frame.get("camera_angle_x", fovx_shared)
        fovy = focal2fov(fov2focal(fovx, width), height)

        cams.append(Camera(
            uid=idx, R=R, T=T, fovx=fovx, fovy=fovy,
            width=width, height=height,
            image_path=image_path,
            image_name=Path(file_path).stem,
            bg=bg,
            timestep=frame.get("timestep_index"),
            camera_id=frame.get("camera_index"),
        ))
    return cams


def read_meshes_from_transforms(path: str, transforms_file: str) -> dict:
    """Per-timestep FLAME parameters (reference :283-295)."""
    with open(os.path.join(path, transforms_file)) as f:
        contents = json.load(f)
    meshes = {}
    for frame in contents["frames"]:
        t = frame.get("timestep_index")
        if t is None or t in meshes:
            continue
        meshes[t] = dict(np.load(os.path.join(path,
                                              frame["flame_param_path"])))
    return meshes


def read_blender_scene(path: str, white_background: bool,
                       eval_split: bool, extension: str = ".png") -> SceneInfo:
    """reference :247-281: cameras of transforms_{train,test}.json and the
    point cloud `points3d.ply` (100k random points, made once, when it is
    missing)."""
    train = read_cameras_from_transforms(
        path, "transforms_train.json", white_background, extension)
    test = read_cameras_from_transforms(
        path, "transforms_test.json", white_background, extension)
    if not eval_split:
        train = train + test
        test = []

    ply_path = os.path.join(path, "points3d.ply")
    if not os.path.exists(ply_path):
        num_pts = 100_000
        rng = np.random.default_rng(0)
        xyz = rng.random((num_pts, 3)) * 2.6 - 1.3
        shs = rng.random((num_pts, 3)) / 255.0
        # sh2rgb of ops/sh.py, in numpy float32
        rgb = shs.astype(np.float32) * np.float32(0.28209479177387814) + 0.5
        plyio.store_point_cloud(ply_path, xyz, rgb * 255)
    points, colors, _ = plyio.fetch_point_cloud(ply_path)

    return SceneInfo(
        train_cameras=train, test_cameras=test,
        nerf_normalization=get_nerfpp_norm(train),
        points=points, colors=colors, ply_path=ply_path,
    )


def read_dynamic_nerf_scene(path: str, white_background: bool,
                            eval_split: bool, extension: str = ".png",
                            target_path: str = "") -> SceneInfo:
    """FLAME avatar data (reference :297-352), with cross-reenactment
    through `target_path`."""
    cam_src = target_path if target_path else path

    train = read_cameras_from_transforms(
        cam_src, "transforms_train.json", white_background, extension)
    train_meshes = read_meshes_from_transforms(path, "transforms_train.json")
    tgt_train_meshes = (
        read_meshes_from_transforms(target_path, "transforms_train.json")
        if target_path else {}
    )

    val = read_cameras_from_transforms(
        cam_src, "transforms_val.json", white_background, extension)
    test = read_cameras_from_transforms(
        cam_src, "transforms_test.json", white_background, extension)
    test_meshes = read_meshes_from_transforms(path, "transforms_test.json")
    tgt_test_meshes = (
        read_meshes_from_transforms(target_path, "transforms_test.json")
        if target_path else {}
    )

    if target_path or not eval_split:
        train = train + val + test
        val, test = [], []
        train_meshes.update(test_meshes)
        test_meshes = {}

    return SceneInfo(
        train_cameras=train, val_cameras=val, test_cameras=test,
        nerf_normalization=get_nerfpp_norm(train),
        train_meshes=train_meshes, test_meshes=test_meshes,
        tgt_train_meshes=tgt_train_meshes, tgt_test_meshes=tgt_test_meshes,
    )
