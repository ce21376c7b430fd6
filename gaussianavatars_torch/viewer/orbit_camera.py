"""Orbit camera of the interactive viewers (the port's own numpy copy of
`gaussianavatars_tpu/viewer/orbit_camera.py`; reference
utils/viewer_utils.py:73-202).

The same `camera.json` format (keys: rotation matrix, look_at, radius,
fovy), matrix conventions and interaction sensitivities (zoom 1.1^-delta,
pan scaled by radius * tan(fovy / 2) / H) as the JAX package's camera, so
a camera saved by either package loads in the other. The orientation is a
unit quaternion (wxyz); numpy float64 throughout.

Kept on purpose from the reference viewers: `look_at` is SUBTRACTED from
the orbit position, and the trackball rotation vector is cross(p, q) *
arccos(p.q) with the unnormalized cross.
"""

from __future__ import annotations

import json
import math
import os
from typing import Literal, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# Minimal numpy quaternion algebra (wxyz). Self-contained so the viewers do
# not pull scipy into their import path.
# ---------------------------------------------------------------------------

_QID = np.array([1.0, 0.0, 0.0, 0.0])


def _qmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return np.array([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ])


def _q_from_rotvec(v: np.ndarray) -> np.ndarray:
    angle = float(np.linalg.norm(v))
    if angle < 1e-12:
        return _QID.copy()
    half = 0.5 * angle
    return np.concatenate([[math.cos(half)],
                           (math.sin(half) / angle) * np.asarray(v)])


def _q_to_mat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def _q_from_mat(m: np.ndarray) -> np.ndarray:
    """Shepperd's method: stable for every rotation-matrix branch."""
    m = np.asarray(m, dtype=np.float64)
    tr = m[0, 0] + m[1, 1] + m[2, 2]
    if tr > 0.0:
        s = math.sqrt(tr + 1.0) * 2.0
        return np.array([0.25 * s,
                         (m[2, 1] - m[1, 2]) / s,
                         (m[0, 2] - m[2, 0]) / s,
                         (m[1, 0] - m[0, 1]) / s])
    i = int(np.argmax([m[0, 0], m[1, 1], m[2, 2]]))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = math.sqrt(max(m[i, i] - m[j, j] - m[k, k] + 1.0, 0.0)) * 2.0
    q = np.empty(4)
    q[0] = (m[k, j] - m[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (m[j, i] + m[i, j]) / s
    q[1 + k] = (m[k, i] + m[i, k]) / s
    return q


# ---------------------------------------------------------------------------
# Projection
# ---------------------------------------------------------------------------

def perspective_from_pinhole(fx: float, fy: float, cx: float, cy: float,
                             width: int, height: int,
                             near: float, far: float,
                             z_sign: int = -1) -> np.ndarray:
    """Clip-space projection of a pinhole camera (x right, y up).

    Matches the matrix the GUI wire protocol expects (the reference's
    intrinsics->projection at utils/viewer_utils.py:20-71), including the
    off-center terms from an integer principal point.
    """
    zr = far - near
    proj = np.zeros((4, 4))
    proj[0, 0] = 2.0 * fx / width
    proj[1, 1] = 2.0 * fy / height
    proj[0, 2] = (width - 2.0 * cx) / width
    proj[1, 2] = (height - 2.0 * cy) / height
    proj[2, 2] = z_sign * (far + near) / zr
    proj[2, 3] = -2.0 * far * near / zr
    proj[3, 2] = z_sign
    return proj


def projection_from_intrinsics(K: np.ndarray, image_size: Tuple[int, int],
                               near: float = 0.01, far: float = 10.0,
                               flip_y: bool = False, z_sign=-1) -> np.ndarray:
    """Batched wrapper kept for callers holding (N,3,3) or (N,4) K."""
    h, w = image_size
    K = np.asarray(K)
    rows = []
    for k in K:
        if k.shape == (3, 3):
            fx, fy, cx, cy = k[0, 0], k[1, 1], k[0, 2], k[1, 2]
        elif k.shape == (4,):
            fx, fy, cx, cy = k
        else:
            raise ValueError(f"bad intrinsics shape {K.shape}")
        p = perspective_from_pinhole(fx, fy, cx, cy, w, h, near, far, z_sign)
        if flip_y:
            p[1, 1] *= -1
        rows.append(p)
    return np.stack(rows)


# ---------------------------------------------------------------------------
# Orbit camera
# ---------------------------------------------------------------------------

class OrbitCamera:
    """Trackball orbit camera with `camera.json` persistence.

    Orientation lives as a unit quaternion (wxyz); the saved file stores it
    as a 3x3 matrix for interchange with reference-produced camera.json.
    """

    def __init__(self, width: int, height: int, r: float = 2.0,
                 fovy: float = 60.0, znear: float = 0.01, zfar: float = 10.0,
                 convention: Literal["opengl", "opencv"] = "opengl",
                 save_path: str = "camera.json"):
        if convention not in ("opengl", "opencv"):
            raise ValueError(f"unknown convention: {convention}")
        self.image_width = width
        self.image_height = height
        self.radius_default = r
        self.fovy_default = fovy
        self.znear = znear
        self.zfar = zfar
        self.convention = convention
        self.save_path = save_path
        self.reset()
        self.load()

    def reset(self):
        self._q = _QID.copy()
        self.look_at = np.zeros(3, np.float32)
        self.radius = self.radius_default
        self.fovy = self.fovy_default
        self.z_sign = 1 if self.convention == "opencv" else -1
        self.y_sign = 1 if self.convention == "opencv" else -1

    # -- persistence (reference-compatible camera.json) ----------------------

    def save(self):
        payload = {
            "rotation": _q_to_mat(self._q).tolist(),
            "look_at": np.asarray(self.look_at, dtype=float).tolist(),
            "radius": self.radius,
            "fovy": self.fovy,
        }
        with open(self.save_path, "w") as f:
            json.dump(payload, f, indent=4)

    def load(self):
        if not os.path.exists(self.save_path):
            return
        with open(self.save_path) as f:
            payload = json.load(f)
        self._q = _q_from_mat(np.asarray(payload["rotation"]))
        self.look_at = np.asarray(payload["look_at"])
        self.radius = payload["radius"]
        self.fovy = payload["fovy"]

    def clear(self):
        if os.path.exists(self.save_path):
            os.remove(self.save_path)

    # -- derived quantities ---------------------------------------------------

    @property
    def _focal(self) -> float:
        return self.image_height / (2.0 * math.tan(math.radians(self.fovy) / 2))

    @property
    def fovx(self) -> float:
        return math.degrees(
            2.0 * math.atan(self.image_width / (2.0 * self._focal))
        )

    @property
    def intrinsics(self) -> np.ndarray:
        f = self._focal
        return np.array(
            [f, f, self.image_width // 2, self.image_height // 2]
        )

    @property
    def projection_matrix(self) -> np.ndarray:
        f = self._focal
        return perspective_from_pinhole(
            f, f, self.image_width // 2, self.image_height // 2,
            self.image_width, self.image_height,
            self.znear, self.zfar, z_sign=self.z_sign,
        )

    @property
    def rotation_matrix(self) -> np.ndarray:
        return _q_to_mat(self._q)

    @property
    def pose(self) -> np.ndarray:
        """camera-to-world in the selected convention.

        Orbit position = R @ [0, 0, radius] with `look_at` subtracted (the
        reference viewers' sign convention; saved cameras depend on it).
        """
        rot = self.rotation_matrix
        pose = np.eye(4, dtype=np.float32)
        pose[:3, :3] = rot
        pose[:3, 3] = rot @ np.array([0.0, 0.0, self.radius]) - self.look_at
        if self.convention == "opencv":
            pose[:, 1] *= -1
            pose[:, 2] *= -1
        return pose

    @property
    def world_view_transform(self) -> np.ndarray:
        return np.linalg.inv(self.pose)

    @property
    def full_proj_transform(self) -> np.ndarray:
        return self.projection_matrix @ self.world_view_transform

    # -- interaction -----------------------------------------------------------

    def _orbit_about_axis(self, column: int, angle: float):
        """Rotate about the current frame's `column`-th basis vector."""
        axis = self.rotation_matrix[:, column]
        self._q = _qmul(_q_from_rotvec(axis * angle), self._q)

    def orbit_x(self, angle: float):
        self._orbit_about_axis(0, angle)

    def orbit_y(self, angle: float):
        self._orbit_about_axis(1, angle)

    def orbit_z(self, angle: float):
        self._orbit_about_axis(2, angle)

    def trackball(self, p: np.ndarray, q: np.ndarray, rot_begin=None):
        """Drag rotation between two sphere points (unnormalized-cross
        rotvec, matching the reference viewers' drag feel)."""
        rotvec = np.cross(p, q) * math.acos(float(np.clip(np.dot(p, q),
                                                          -1.0, 1.0)))
        base = self._q if rot_begin is None else np.asarray(rot_begin)
        self._q = _qmul(base, _q_from_rotvec(rotvec))

    @property
    def orientation(self) -> np.ndarray:
        """Unit quaternion (wxyz) — pass back to trackball(rot_begin=...)."""
        return self._q.copy()

    @orientation.setter
    def orientation(self, q):
        q = np.asarray(q, dtype=np.float64)
        self._q = q / np.linalg.norm(q)

    def scale(self, delta: float):
        self.radius *= 1.1 ** (-delta)

    def pan(self, dx=0.0, dy=0.0, dz=0.0):
        """Translate look_at in the camera frame; sensitivity scales with
        subtended height (radius * tan(fovy/2) / image_height)."""
        step = 2.0 * self.radius * math.tan(math.radians(self.fovy) / 2)
        step /= self.image_height
        self.look_at = self.look_at + step * (
            self.rotation_matrix @ np.array([dx, -dy, dz])
        )
