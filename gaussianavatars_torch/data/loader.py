"""Host-side prefetching camera and image loader (port of
`gaussianavatars_tpu/data/loader.py`; reference train.py:55 and
scene/__init__.py:31-67).

Images decode on host threads while the device runs the previous step,
and arrive as float32 [3, H, W] arrays. A view's format comes from its
first bytes: a PNG decodes with `utils/png.py` (zlib releases the
interpreter lock while it inflates); a JPEG with nvJPEG on the card when
the loader's device is CUDA (`utils/nvjpeg.py`, one decoder, state and
stream per thread, the pixels copied back to the host once) and with the
plain decoder (`utils/jpeg.py`) when it is the CPU. A CUDA loader never
decodes a JPEG on the CPU. Resizing and compositing are the same for both
formats. Delivery follows the shuffled epoch order exactly, whatever order
the threads finish in.
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
from gaussianavatars_torch.utils.jpeg import decode_jpeg, is_jpeg
from gaussianavatars_torch.utils.nvjpeg import NvJpegDecoder
from gaussianavatars_torch.utils.png import decode_png

_CACHE_LOCK = threading.Lock()
_IMAGE_CACHE: dict = {}     # (path, w, h, bg bytes, plain?) -> [3, H, W]
_CACHE_BYTES = [0]
_CACHE_BUDGET = int(float(os.environ.get("GA_IMAGE_CACHE_GB", "4"))
                    * (1 << 30))


_PRECISION_BITS = 22      # Pillow's fixed point for 8-bit resampling


def _bicubic(x: np.ndarray) -> np.ndarray:
    """Pillow's bicubic filter (a = -0.5, support 2)."""
    a = -0.5
    x = np.abs(x)
    return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0,
                    np.where(x < 2.0, (((x - 5.0) * x + 8.0) * x - 4.0) * a,
                             0.0))


def _resample_axis(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One pass of Pillow's 8-bit bicubic resampler along `axis` of a uint8
    image: the filter widened by the downscale factor, each output's
    weights normalised and rounded to 22-bit fixed point, the sum rounded
    half up and clipped to 0..255."""
    in_size = img.shape[axis]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    # Pillow's C casts truncate toward zero, as astype does; a negative
    # lower bound is clamped to 0 either way
    lo = np.maximum((center - support + 0.5).astype(np.int64), 0)
    hi = np.minimum((center + support + 0.5).astype(np.int64), in_size)
    taps = np.arange(ksize)
    live = taps[None, :] < (hi - lo)[:, None]
    w = _bicubic((lo[:, None] + taps[None, :] - center[:, None] + 0.5)
                 / filterscale) * live
    ww = w.sum(axis=1, keepdims=True)
    w = np.where(ww != 0.0, w / np.where(ww != 0.0, ww, 1.0), w)
    one = float(1 << _PRECISION_BITS)
    k = np.where(w < 0, -0.5 + w * one, 0.5 + w * one).astype(np.int64)
    src = np.moveaxis(img, axis, 0).astype(np.int64)
    acc = np.full((out_size,) + src.shape[1:], 1 << (_PRECISION_BITS - 1),
                  np.int64)
    idx = np.minimum(lo[:, None] + taps[None, :], in_size - 1)
    extra = (1,) * (src.ndim - 1)
    for t in range(ksize):
        acc += src[idx[:, t]] * k[:, t].reshape((out_size,) + extra)
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def _resize(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """uint8 [H, W, C] to [height, width, C] as PIL's `Image.resize((width,
    height))` does, which the JAX loader calls (bicubic by default): a
    horizontal pass and then a vertical one, each rounded to uint8, a pass
    skipped when its size does not change. RGBA is premultiplied by alpha
    first and divided by it after (Pillow's RGBA -> RGBa -> RGBA, in
    integers), so the composite sees what the JAX loader's does."""
    if img.shape[:2] == (height, width):
        return img
    rgba = img.shape[-1] == 4
    if rgba:
        alpha = img[..., 3:4].astype(np.int64)
        tmp = img[..., :3].astype(np.int64) * alpha + 128
        img = np.concatenate(
            [(((tmp >> 8) + tmp) >> 8).astype(np.uint8), img[..., 3:4]], -1)
    if img.shape[1] != width:
        img = _resample_axis(img, width, axis=1)
    if img.shape[0] != height:
        img = _resample_axis(img, height, axis=0)
    if rgba:
        alpha = img[..., 3:4].astype(np.int64)
        rgb = img[..., :3].astype(np.int64)
        keep = (alpha == 0) | (alpha == 255)
        div = np.clip(255 * rgb // np.maximum(alpha, 1), 0, 255)
        img = np.concatenate([np.where(keep, rgb, div).astype(np.uint8),
                              img[..., 3:4]], -1)
    return img


def jpeg_decoder(device: str | torch.device = "cpu"):
    """The JPEG decoder of a loader on `device`: an nvJPEG decoder for
    CUDA (one per thread), None (the plain decoder) for the CPU."""
    device = torch.device(device)
    return NvJpegDecoder(device) if device.type == "cuda" else None


def read_image(path: str, jpeg=None) -> np.ndarray:
    """Decode a PNG or a JPEG file by its first bytes: uint8 [H, W] or
    [H, W, C]. A JPEG goes to `jpeg` (an `NvJpegDecoder`) when given, else
    to the plain decoder; any other format raises naming the file."""
    with open(path, "rb") as f:
        buf = f.read()
    if is_jpeg(buf):
        return jpeg.read(buf, path) if jpeg is not None else \
            decode_jpeg(buf, path)
    return decode_png(buf, path)


def load_camera_image(cam: Camera, resolution_arg: int = -1,
                      resolution_scale: float = 1.0,
                      jpeg=None) -> np.ndarray:
    """Decode, resize and composite one view: [3, H, W] float32.

    Follows reference scene/__init__.py:38-63: RGBA images are composited
    onto the camera background, gray ones repeated to three channels, and
    the size follows the 1600 px auto-cap (`Camera.resolution`). Decoded
    views stay in host memory (the reference keeps every image resident)
    under a byte budget, GA_IMAGE_CACHE_GB (default 4), and the whole cache
    is dropped when it would overflow. `jpeg` decodes JPEG views (see
    `read_image`); a gray JPEG becomes RGB as a gray PNG does.
    """
    w, h = cam.resolution(resolution_arg, resolution_scale)
    key = (cam.image_path, w, h, cam.bg.tobytes(), jpeg is None)
    with _CACHE_LOCK:
        hit = _IMAGE_CACHE.get(key)
    if hit is not None:
        return hit

    raw = read_image(cam.image_path, jpeg)
    if raw.shape[:2] != (h, w):
        raw = _resize(raw if raw.ndim == 3 else raw[..., None], w, h)
    arr = raw.astype(np.float32) / 255.0
    if arr.ndim == 2 or arr.shape[-1] == 1:
        arr = arr.reshape(h, w, 1).repeat(3, axis=-1)
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
                 loop: bool = True, device: str | torch.device = "cpu"):
        if not cameras:
            raise ValueError("CameraLoader needs at least one camera")
        self.cameras = cameras
        self.resolution_arg = resolution_arg
        self.shuffle = shuffle
        self.loop = loop
        self.device = torch.device(device)
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
        jpeg = jpeg_decoder(self.device)        # this thread's own
        try:
            self._serve(jpeg)
        finally:
            if jpeg is not None:
                jpeg.close()

    def _serve(self, jpeg):
        while not self._stop.is_set():
            drawn = self._next_index()
            if drawn is None:
                return
            seq, idx = drawn
            cam = self.cameras[idx]
            try:
                item = (seq, cam, load_camera_image(
                    cam, self.resolution_arg, jpeg=jpeg))
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


def iterate_once(cameras: list[Camera], resolution_arg: int = -1,
                 device: str | torch.device = "cpu"):
    """Sequential iteration (eval sweeps); JPEG views decode as a loader
    on `device` decodes them."""
    jpeg = jpeg_decoder(device)
    try:
        for cam in cameras:
            yield cam, load_camera_image(cam, resolution_arg, jpeg=jpeg)
    finally:
        if jpeg is not None:
            jpeg.close()
