"""Host-side prefetching camera and image loader (port of
`gaussianavatars_tpu/data/loader.py`; reference train.py:55 and
scene/__init__.py:31-67).

Images decode on host threads (`utils/png.py`; zlib releases the
interpreter lock while it inflates) while the device runs the previous
step, and arrive as float32 [3, H, W] arrays. Delivery follows the
shuffled epoch order exactly, whatever order the threads finish in.
"""

from __future__ import annotations

import os
import queue
import random
import threading
from typing import Iterator, Optional

import numpy as np
import torch

from gaussianavatars_torch.data.cameras import Camera
from gaussianavatars_torch.utils.png import read_png

_CACHE_LOCK = threading.Lock()
_IMAGE_CACHE: dict = {}     # (path, w, h, bg bytes) -> [3, H, W] float32
_CACHE_BYTES = [0]
_CACHE_BUDGET = int(float(os.environ.get("GA_IMAGE_CACHE_GB", "4"))
                    * (1 << 30))


def _resize(arr: np.ndarray, width: int, height: int) -> np.ndarray:
    """[H, W, C] float32 to [height, width, C]: bilinear with antialiasing
    (`torch.nn.functional.interpolate`). Not PIL's resampler, which the
    JAX package uses: resized images differ from its by up to a few
    levels."""
    t = torch.from_numpy(np.ascontiguousarray(arr.transpose(2, 0, 1)))[None]
    out = torch.nn.functional.interpolate(t, size=(height, width),
                                          mode="bilinear", antialias=True,
                                          align_corners=False)
    return out[0].clamp_(0.0, 1.0).permute(1, 2, 0).numpy()


def load_camera_image(cam: Camera, resolution_arg: int = -1,
                      resolution_scale: float = 1.0) -> np.ndarray:
    """Decode, resize and composite one view: [3, H, W] float32.

    Follows reference scene/__init__.py:38-63: RGBA images are composited
    onto the camera background, gray ones repeated to three channels, and
    the size follows the 1600 px auto-cap (`Camera.resolution`). Decoded
    views stay in host memory (the reference keeps every image resident)
    under a byte budget, GA_IMAGE_CACHE_GB (default 4), and the whole cache
    is dropped when it would overflow.
    """
    w, h = cam.resolution(resolution_arg, resolution_scale)
    key = (cam.image_path, w, h, cam.bg.tobytes())
    with _CACHE_LOCK:
        hit = _IMAGE_CACHE.get(key)
    if hit is not None:
        return hit

    arr = read_png(cam.image_path).astype(np.float32) / 255.0
    if arr.ndim == 2:
        arr = arr[..., None].repeat(3, axis=-1)
    if arr.shape[:2] != (h, w):
        arr = _resize(arr, w, h)
    if arr.shape[-1] == 4:
        rgb, alpha = arr[..., :3], arr[..., 3:4]
        arr = rgb * alpha + cam.bg[None, None, :] * (1.0 - alpha)
    out = np.ascontiguousarray(np.transpose(arr[..., :3], (2, 0, 1)),
                               np.float32)
    out.setflags(write=False)
    with _CACHE_LOCK:
        if _CACHE_BYTES[0] + out.nbytes > _CACHE_BUDGET:
            _IMAGE_CACHE.clear()
            _CACHE_BYTES[0] = 0
        if out.nbytes <= _CACHE_BUDGET:
            _IMAGE_CACHE[key] = out
            _CACHE_BYTES[0] += out.nbytes
    return out


class CameraLoader:
    """Iterates (camera, gt_image) pairs forever with background prefetch.

    Decoding is parallel, but delivery is strictly the shuffled epoch order
    (`random.Random(seed)`, one shuffle per epoch): each draw carries a
    sequence number and the consumer reorders, so every camera comes once
    per epoch in an order that repeats from run to run.
    """

    def __init__(self, cameras: list[Camera], resolution_arg: int = -1,
                 shuffle: bool = True, prefetch: int = 4,
                 num_threads: int = 4, seed: int = 0,
                 loop: bool = True):
        if not cameras:
            raise ValueError("CameraLoader needs at least one camera")
        self.cameras = cameras
        self.resolution_arg = resolution_arg
        self.shuffle = shuffle
        self.loop = loop
        self.rng = random.Random(seed)
        self._queue: queue.Queue = queue.Queue(maxsize=max(prefetch,
                                                           num_threads))
        self._stop = threading.Event()
        self._order_lock = threading.Lock()
        self._order: list[int] = []
        self._epoch_pos = 0
        self._served = 0
        self._next_seq = 0
        self._reorder: dict = {}
        self._threads = [threading.Thread(target=self._worker, daemon=True)
                         for _ in range(num_threads)]
        for t in self._threads:
            t.start()

    def _next_index(self) -> Optional[tuple[int, int]]:
        with self._order_lock:
            if self._epoch_pos >= len(self._order):
                if not self.loop and self._served >= len(self.cameras):
                    return None
                self._order = list(range(len(self.cameras)))
                if self.shuffle:
                    self.rng.shuffle(self._order)
                self._epoch_pos = 0
            idx = self._order[self._epoch_pos]
            seq = self._served
            self._epoch_pos += 1
            self._served += 1
            return seq, idx

    def _worker(self):
        while not self._stop.is_set():
            drawn = self._next_index()
            if drawn is None:
                return
            seq, idx = drawn
            cam = self.cameras[idx]
            try:
                item = (seq, cam, load_camera_image(cam, self.resolution_arg))
            except Exception as exc:   # handed to the consumer, raised there
                item = (seq, cam, exc)
            while not self._stop.is_set():
                try:
                    self._queue.put(item, timeout=0.5)
                    break
                except queue.Full:
                    continue

    def __iter__(self) -> Iterator[tuple[Camera, np.ndarray]]:
        return self

    def __next__(self):
        while self._next_seq not in self._reorder:
            seq, cam, img = self._queue.get()
            self._reorder[seq] = (cam, img)
        cam, img = self._reorder.pop(self._next_seq)
        self._next_seq += 1
        if isinstance(img, Exception):
            raise img
        return cam, img

    def stop(self):
        """Stop the threads (each ends within half a second)."""
        self._stop.set()
        for t in self._threads:
            t.join(timeout=2.0)


def iterate_once(cameras: list[Camera], resolution_arg: int = -1):
    """Sequential iteration (eval sweeps)."""
    for cam in cameras:
        yield cam, load_camera_image(cam, resolution_arg)
