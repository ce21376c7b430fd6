"""COLMAP sparse-reconstruction parsers, binary and text (port of
`gaussianavatars_tpu/data/colmap.py`; reference scene/colmap_loader.py).

The COLMAP on-disk formats of its public specification: cameras, images
and points3D, each as `.bin` or `.txt`, and the quaternion <-> rotation
matrix helpers; also writers of the three binary files (the port's own, for
scenes it builds). numpy and the standard library only.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass

import numpy as np

# model_id -> (name, num_params) per the COLMAP camera model table
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
MODEL_NAME_TO_ID = {name: mid for mid, (name, _) in CAMERA_MODELS.items()}


@dataclass
class ColmapCamera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


@dataclass
class ColmapImage:
    id: int
    qvec: np.ndarray
    tvec: np.ndarray
    camera_id: int
    name: str


def qvec2rotmat(qvec) -> np.ndarray:
    """wxyz quaternion -> 3x3 rotation (reference scene/colmap_loader.py:43)."""
    w, x, y, z = qvec
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def rotmat2qvec(R) -> np.ndarray:
    """3x3 rotation -> wxyz quaternion (eigenvector method)."""
    Rxx, Ryx, Rzx, Rxy, Ryy, Rzy, Rxz, Ryz, Rzz = R.flat
    K = np.array([
        [Rxx - Ryy - Rzz, 0, 0, 0],
        [Ryx + Rxy, Ryy - Rxx - Rzz, 0, 0],
        [Rzx + Rxz, Rzy + Ryz, Rzz - Rxx - Ryy, 0],
        [Ryz - Rzy, Rzx - Rxz, Rxy - Ryx, Rxx + Ryy + Rzz],
    ]) / 3.0
    eigvals, eigvecs = np.linalg.eigh(K)
    q = eigvecs[[3, 0, 1, 2], np.argmax(eigvals)]
    return -q if q[0] < 0 else q


def _read(f, fmt: str):
    size = struct.calcsize(fmt)
    return struct.unpack(fmt, f.read(size))


def read_cameras_binary(path: str) -> dict[int, ColmapCamera]:
    cams = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            cam_id, model_id, width, height = _read(f, "<iiQQ")
            name, n_params = CAMERA_MODELS[model_id]
            params = np.array(_read(f, f"<{n_params}d"))
            cams[cam_id] = ColmapCamera(cam_id, name, width, height, params)
    return cams


def read_images_binary(path: str) -> dict[int, ColmapImage]:
    images = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            img_id = _read(f, "<i")[0]
            qvec = np.array(_read(f, "<4d"))
            tvec = np.array(_read(f, "<3d"))
            cam_id = _read(f, "<i")[0]
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (n_pts,) = _read(f, "<Q")
            f.seek(24 * n_pts, os.SEEK_CUR)  # skip 2D points (x, y, id3d)
            images[img_id] = ColmapImage(
                img_id, qvec, tvec, cam_id, name.decode()
            )
    return images


def read_points3d_binary(path: str):
    """Returns (xyz [N,3], rgb [N,3], err [N])."""
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        xyz = np.empty((n, 3))
        rgb = np.empty((n, 3), np.uint8)
        err = np.empty(n)
        for i in range(n):
            data = _read(f, "<QdddBBBd")
            xyz[i] = data[1:4]
            rgb[i] = data[4:7]
            err[i] = data[7]
            (track_len,) = _read(f, "<Q")
            f.seek(8 * track_len, os.SEEK_CUR)
    return xyz, rgb, err


def read_cameras_text(path: str) -> dict[int, ColmapCamera]:
    cams = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            tok = line.split()
            cams[int(tok[0])] = ColmapCamera(
                int(tok[0]), tok[1], int(tok[2]), int(tok[3]),
                np.array([float(x) for x in tok[4:]]),
            )
    return cams


def read_images_text(path: str) -> dict[int, ColmapImage]:
    images = {}
    with open(path) as f:
        lines = [l.strip() for l in f
                 if l.strip() and not l.startswith("#")]
    for meta in lines[0::2]:     # every other line is 2D point data
        tok = meta.split()
        images[int(tok[0])] = ColmapImage(
            int(tok[0]),
            np.array([float(x) for x in tok[1:5]]),
            np.array([float(x) for x in tok[5:8]]),
            int(tok[8]),
            tok[9],
        )
    return images


def read_points3d_text(path: str):
    xyz_l, rgb_l, err_l = [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            tok = line.split()
            xyz_l.append([float(x) for x in tok[1:4]])
            rgb_l.append([int(x) for x in tok[4:7]])
            err_l.append(float(tok[7]))
    return (np.array(xyz_l), np.array(rgb_l, np.uint8), np.array(err_l))


def write_cameras_binary(path: str, cams: list[ColmapCamera]) -> None:
    """`cameras.bin` of `cams` (the inverse of `read_cameras_binary`)."""
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cams)))
        for cam in cams:
            f.write(struct.pack("<iiQQ", cam.id, MODEL_NAME_TO_ID[cam.model],
                                cam.width, cam.height))
            f.write(struct.pack(f"<{len(cam.params)}d", *cam.params))


def write_images_binary(path: str, images: list[ColmapImage]) -> None:
    """`images.bin` of `images`, each without 2D points."""
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for im in images:
            f.write(struct.pack("<i4d3di", im.id, *im.qvec, *im.tvec,
                                im.camera_id))
            f.write(im.name.encode() + b"\x00")
            f.write(struct.pack("<Q", 0))


def write_points3d_binary(path: str, xyz: np.ndarray,
                          rgb: np.ndarray) -> None:
    """`points3D.bin` of points `xyz` [N, 3] with colours `rgb` [N, 3]
    uint8, each with error 0 and an empty track."""
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(xyz)))
        for i, (p, c) in enumerate(zip(xyz, rgb)):
            f.write(struct.pack("<QdddBBBdQ", i + 1, *map(float, p),
                                *map(int, c), 0.0, 0))
