"""The training process's viewer server (port of
`gaussianavatars_tpu/viewer/network_gui.py`; reference
gaussian_renderer/network_gui.py:26-88 and remote_viewer.py:48-156).

The wire format is the JAX package's, byte for byte: a non-blocking TCP
listener polled from the train loop; each message is a 4-byte
little-endian length and then UTF-8 JSON; a reply is the image as raw
uint8 H x W x 3 bytes (row-major), then a length-prefixed JSON stats
message. The client's view and projection matrices arrive in the OpenGL
convention: columns 1 and 2 of the view matrix and column 1 of the
projection are negated here, as the reference does.

`port=0` binds a free port; `init` stores the port it bound in `port`.
"""

from __future__ import annotations

import json
import socket
from typing import Optional

import numpy as np
import torch

from gaussianavatars_torch.data.cameras import MiniCam
from gaussianavatars_torch.utils.trace import span, sync


class NetworkGUI:
    def __init__(self, host: str = "127.0.0.1", port: int = 6009):
        self.host = host
        self.port = port
        self.listener: Optional[socket.socket] = None
        self.conn: Optional[socket.socket] = None

    def init(self):
        """Bind and listen; raises OSError when the address is taken."""
        listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        try:
            listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            listener.bind((self.host, self.port))
            listener.listen()
        except OSError:
            listener.close()
            raise
        listener.settimeout(0)
        self.listener = listener
        self.port = listener.getsockname()[1]

    def try_connect(self):
        """Accept a waiting client, if there is one."""
        if self.listener is None:
            return
        try:
            self.conn, addr = self.listener.accept()
        except (BlockingIOError, socket.timeout):
            return
        print(f"\nConnected by {addr}")
        self.conn.settimeout(None)

    def _read_exact(self, n: int) -> bytes:
        chunks, got = [], 0
        while got < n:
            chunk = self.conn.recv(n - got)
            if not chunk:
                raise ConnectionError("client disconnected")
            chunks.append(chunk)
            got += len(chunk)
        return b"".join(chunks)

    def read(self) -> dict:
        length = int.from_bytes(self._read_exact(4), "little")
        return json.loads(self._read_exact(length).decode("utf-8"))

    def receive(self):
        """The next request: (MiniCam, or None for a 0x0 resolution, and
        the message dict)."""
        msg = self.read()
        width = msg["resolution_x"]
        height = msg["resolution_y"]
        msg["do_training"] = bool(msg["do_training"])
        msg["keep_alive"] = bool(msg["keep_alive"])
        if width == 0 or height == 0:
            return None, msg
        wv = np.asarray(msg["view_matrix"], np.float32).reshape(4, 4)
        wv[:, 1] = -wv[:, 1]
        wv[:, 2] = -wv[:, 2]
        proj = np.asarray(msg["view_projection_matrix"],
                          np.float32).reshape(4, 4)
        proj[:, 1] = -proj[:, 1]
        cam = MiniCam(width=width, height=height, fovy=msg["fov_y"],
                      fovx=msg["fov_x"], znear=msg["z_near"],
                      zfar=msg["z_far"], world_view_transform=wv,
                      full_proj_transform=proj,
                      timestep=msg.get("timestep", 0))
        return cam, msg

    def send(self, image, stats: dict):
        """Reply with `image` (None: stats only), then the JSON-encodable
        `stats`. `image` is the wire's uint8 [H, W, 3] array, or a [3, H,
        W] image in [0, 1] (array or tensor) that `to_wire` converts."""
        if image is not None:
            if not (isinstance(image, np.ndarray) and image.dtype == np.uint8
                    and image.ndim == 3 and image.shape[2] == 3):
                image = to_wire(image)
            self.conn.sendall(np.ascontiguousarray(image).tobytes())
        payload = json.dumps(stats).encode("utf-8")
        self.conn.sendall(len(payload).to_bytes(4, "little"))
        self.conn.sendall(payload)

    def drop(self):
        """Close the client's connection (the listener stays)."""
        if self.conn is not None:
            try:
                self.conn.close()
            except OSError:
                pass
        self.conn = None

    def close(self):
        self.drop()
        if self.listener is not None:
            self.listener.close()
            self.listener = None


def to_wire(image) -> np.ndarray:
    """A [3, H, W] image in [0, 1] (tensor or array) as the wire's uint8
    [H, W, 3]: clip(x * 255, 0, 255) truncated, as the JAX server sends
    it. A tensor is converted on its device and copied to the host once,
    the span "to_wire" of `utils/trace.py` with the host sync
    "sync.to_host"."""
    if isinstance(image, torch.Tensor):
        with span("to_wire"):
            wire = (image * 255.0).clamp(0.0, 255.0).to(torch.uint8).permute(
                1, 2, 0)
            with sync("sync.to_host"):
                return wire.cpu().numpy()
    return np.clip(np.asarray(image) * 255.0, 0, 255).astype(
        np.uint8).transpose(1, 2, 0)
