"""JPEG decoding on the card with nvJPEG, through ctypes.

The CUDA loader's JPEG path (`data/loader.py`). The JAX package decodes
JPEGs with libjpeg on the host (`gaussianavatars_tpu/native`, or PIL); no
Pallas kernel is involved, so the port calls NVIDIA's library here as the
JAX package calls libjpeg. The CPU decodes with the plain decoder
(`utils/jpeg.py`) instead.

The library is loaded the way `kernels.py` loads the kernels: found under
$CUDA_HOME (default /usr/local/cuda) as `lib64/libnvjpeg.so.12` (or
`libnvjpeg.so`) with ctypes, at first use, never at import. The constants
(the RGBI output format, the status names, the component count and the
pitch type of `nvjpegImage_t`) are read from `include/nvjpeg.h` beside it.

There is no fallback: a missing library or header, or a call that returns
a status other than NVJPEG_STATUS_SUCCESS, raises `NvJpegError` naming the
file and the status. The decoder never hands a file to the plain decoder.

nvJPEG decodes progressive JPEGs too (on its hybrid backend, the one
`nvjpegCreateSimple` picks for them), which the plain decoder refuses. Its
chroma upsampling is its own, not libjpeg's fancy filter, so on subsampled
files its pixels may differ from PIL's by more than a level at colour
edges: `chip_smoke.py` measures how far.

A `NvJpegDecoder` holds one handle, one decode state and one CUDA stream,
and is not thread-safe (nvJPEG's states are not): each loader thread owns
one.
"""

from __future__ import annotations

import ctypes
import os
import re
import threading
from pathlib import Path

import numpy as np
import torch


class NvJpegError(RuntimeError):
    """nvJPEG is missing or failed on a file."""


_LOCK = threading.Lock()
_LIB: dict = {}            # "lib" -> (ctypes.CDLL, constants)


def _constants(header: Path) -> dict:
    text = header.read_text()
    status = {int(v): f"NVJPEG_STATUS_{k}" for k, v in re.findall(
        r"NVJPEG_STATUS_(\w+)\s*=\s*(\d+)", text)}
    rgbi = re.search(r"NVJPEG_OUTPUT_RGBI\s*=\s*(\d+)", text)
    maxc = re.search(r"#define\s+NVJPEG_MAX_COMPONENT\s+(\d+)", text)
    image = re.search(r"typedef\s+struct\s*\{([^}]*)\}\s*nvjpegImage_t",
                      text)
    pitch = image and re.search(r"([\w ]+?)\s+pitch\s*\[", image.group(1))
    if not (status and rgbi and maxc and pitch):
        raise NvJpegError(f"{header}: could not read nvJPEG's constants")
    pitch_type = {"size_t": ctypes.c_size_t,
                  "unsigned int": ctypes.c_uint}.get(pitch.group(1).strip())
    if pitch_type is None:
        raise NvJpegError(f"{header}: unknown pitch type {pitch.group(1)!r}")
    return dict(status=status, rgbi=int(rgbi.group(1)),
                max_component=int(maxc.group(1)), pitch_type=pitch_type)


def load_library():
    """(ctypes library, constants), loaded once a process."""
    with _LOCK:
        if "lib" not in _LIB:
            home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
            candidates = [home / "lib64" / "libnvjpeg.so.12",
                          home / "lib64" / "libnvjpeg.so"]
            path = next((p for p in candidates if p.exists()), None)
            header = home / "include" / "nvjpeg.h"
            if path is None or not header.exists():
                raise NvJpegError(
                    "nvJPEG not found: need one of "
                    f"{[str(p) for p in candidates]} and {header}")
            consts = _constants(header)
            lib = ctypes.CDLL(str(path))
            vp, ip = ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)

            class Image(ctypes.Structure):
                _fields_ = [
                    ("channel", ctypes.c_void_p * consts["max_component"]),
                    ("pitch", consts["pitch_type"] * consts["max_component"])]

            consts["image"] = Image
            lib.nvjpegCreateSimple.argtypes = [ctypes.POINTER(vp)]
            lib.nvjpegJpegStateCreate.argtypes = [vp, ctypes.POINTER(vp)]
            lib.nvjpegGetImageInfo.argtypes = [
                vp, ctypes.c_char_p, ctypes.c_size_t, ip, ip, ip, ip]
            lib.nvjpegDecode.argtypes = [
                vp, vp, ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int,
                ctypes.POINTER(Image), vp]
            lib.nvjpegJpegStateDestroy.argtypes = [vp]
            lib.nvjpegDestroy.argtypes = [vp]
            for fn in (lib.nvjpegCreateSimple, lib.nvjpegJpegStateCreate,
                       lib.nvjpegGetImageInfo, lib.nvjpegDecode,
                       lib.nvjpegJpegStateDestroy, lib.nvjpegDestroy):
                fn.restype = ctypes.c_int
            _LIB["lib"] = (lib, consts)
    return _LIB["lib"]


class NvJpegDecoder:
    """Decodes JPEG bytes on `device` (a CUDA device) into uint8 [H, W, 3]
    RGB (a gray JPEG comes out with R = G = B). The handle, state and
    stream are made at the first decode; `close` releases them."""

    def __init__(self, device: str | torch.device = "cuda"):
        self.device = torch.device(device)
        if self.device.type != "cuda":
            raise ValueError(f"nvJPEG decodes on a CUDA device, not "
                             f"{self.device}")
        self._handle = None
        self._state = None
        self._stream = None

    def _check(self, status: int, call: str, path: str):
        if status != 0:
            name = self._consts["status"].get(status, "unknown status")
            raise NvJpegError(f"{path}: {call} failed with {name} ({status})")

    def _open(self, path: str):
        try:
            self._lib, self._consts = load_library()
        except NvJpegError as exc:
            raise NvJpegError(f"{path}: {exc}") from exc
        handle, state = ctypes.c_void_p(), ctypes.c_void_p()
        self._check(self._lib.nvjpegCreateSimple(ctypes.byref(handle)),
                    "nvjpegCreateSimple", path)
        self._handle = handle
        self._check(self._lib.nvjpegJpegStateCreate(handle,
                                                    ctypes.byref(state)),
                    "nvjpegJpegStateCreate", path)
        self._state = state
        self._stream = torch.cuda.Stream(self.device)

    def decode(self, data: bytes, path: str = "<bytes>") -> torch.Tensor:
        """uint8 [H, W, 3] on the card, written on this decoder's stream
        (synchronise it, or use `read`, before reading the tensor on
        another stream)."""
        if self._handle is None:
            self._open(path)
        lib, consts = self._lib, self._consts
        n, css = ctypes.c_int(), ctypes.c_int()
        ws = (ctypes.c_int * consts["max_component"])()
        hs = (ctypes.c_int * consts["max_component"])()
        self._check(lib.nvjpegGetImageInfo(self._handle, data, len(data),
                                           ctypes.byref(n), ctypes.byref(css),
                                           ws, hs),
                    "nvjpegGetImageInfo", path)
        w, h = ws[0], hs[0]
        with torch.cuda.stream(self._stream):
            out = torch.empty((h, w, 3), dtype=torch.uint8,
                              device=self.device)
        image = consts["image"]()
        image.channel[0] = out.data_ptr()
        image.pitch[0] = 3 * w
        self._check(lib.nvjpegDecode(self._handle, self._state, data,
                                     len(data), consts["rgbi"],
                                     ctypes.byref(image),
                                     self._stream.cuda_stream),
                    "nvjpegDecode", path)
        return out

    def read(self, data: bytes, path: str = "<bytes>") -> np.ndarray:
        """Decode on the card and copy the pixels to the host once:
        uint8 [H, W, 3]."""
        out = self.decode(data, path)
        self._stream.synchronize()
        with torch.cuda.stream(self._stream):
            host = out.cpu()
        return host.numpy()

    def close(self):
        if self._state is not None:
            self._lib.nvjpegJpegStateDestroy(self._state)
            self._state = None
        if self._handle is not None:
            self._lib.nvjpegDestroy(self._handle)
            self._handle = None
