"""Headless client of the training viewer's protocol (port of
`gaussianavatars_tpu/viewer/remote_client.py`; reference
remote_viewer.py:48-156).

The communication core of the remote viewer, without its dearpygui shell
(`gaussianavatars_torch/remote_viewer.py`), so that scripts and tests can
drive a training process: the same messages, fields and defaults as the
JAX package's client.
"""

from __future__ import annotations

import json
import socket
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np


@dataclass
class ViewRequest:
    width: int
    height: int
    fovx: float                 # radians
    fovy: float                 # radians
    znear: float
    zfar: float
    world_view_transform: np.ndarray   # [4,4] (pre-transpose convention)
    full_proj_transform: np.ndarray
    timestep: int = 0
    do_training: bool = True
    keep_alive: bool = True
    scaling_modifier: float = 1.0
    show_splatting: bool = True
    show_mesh: bool = False
    mesh_opacity: float = 0.5
    use_original_mesh: bool = False


class RemoteRenderClient:
    def __init__(self, host: str = "127.0.0.1", port: int = 6009,
                 timeout: float = 5.0):
        self.host = host
        self.port = port
        self.timeout = timeout
        self.socket: Optional[socket.socket] = None

    def connect(self, retries: int = 10, wait: float = 0.3) -> bool:
        for _ in range(retries):
            try:
                s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
                s.settimeout(self.timeout)
                s.connect((self.host, self.port))
                self.socket = s
                return True
            except OSError:
                time.sleep(wait)
        return False

    def close(self):
        if self.socket is not None:
            self.socket.close()
            self.socket = None

    def _send_json(self, message: dict):
        payload = json.dumps(message).encode("utf-8")
        self.socket.sendall(len(payload).to_bytes(4, "little"))
        self.socket.sendall(payload)

    def _recv_exact(self, n: int) -> bytes:
        chunks, got = [], 0
        while got < n:
            chunk = self.socket.recv(min(n - got, 65536))
            if not chunk:
                raise ConnectionError("server closed")
            chunks.append(chunk)
            got += len(chunk)
        return b"".join(chunks)

    def request_pause(self, do_training: bool = True) -> None:
        """resolution 0x0 message: no render, keeps the loop alive.

        NOTE: the reference server sends no reply for a 0x0 request
        (train.py:72-97 replies only when a camera was provided), so
        neither do we — and this client doesn't wait for one."""
        self._send_json({
            "resolution_x": 0, "resolution_y": 0,
            "do_training": do_training, "keep_alive": True,
        })

    def request_view(self, req: ViewRequest):
        """-> (image [H,W,3] uint8 | None, stats dict).

        Matrix fields are sent transposed (flattened), matching the
        reference client (remote_viewer.py:75-76).
        """
        message = {
            "resolution_x": req.width,
            "resolution_y": req.height,
            "do_training": req.do_training,
            "fov_y": req.fovy,
            "fov_x": req.fovx,
            "z_near": req.znear,
            "z_far": req.zfar,
            "keep_alive": req.keep_alive,
            "scaling_modifier": req.scaling_modifier,
            "show_splatting": req.show_splatting,
            "show_mesh": req.show_mesh,
            "mesh_opacity": req.mesh_opacity,
            "use_original_mesh": req.use_original_mesh,
            "view_matrix":
                np.asarray(req.world_view_transform).T.flatten().tolist(),
            "view_projection_matrix":
                np.asarray(req.full_proj_transform).T.flatten().tolist(),
            "timestep": req.timestep,
        }
        self._send_json(message)

        img = None
        if req.show_splatting or req.show_mesh:
            raw = self._recv_exact(req.width * req.height * 3)
            img = np.frombuffer(raw, np.uint8).reshape(
                req.height, req.width, 3
            )
        length = int.from_bytes(self._recv_exact(4), "little")
        stats = json.loads(self._recv_exact(length).decode("utf-8"))
        return img, stats
