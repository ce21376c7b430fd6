"""The port's JPEG decoding on the CPU.

  * the plain decoder (`utils/jpeg.py`) against PIL on files PIL writes
    here: 4:4:4, 4:2:2 and 4:2:0 at several qualities, gray, restart
    markers, sizes that are not multiples of 16 (33x17, 37x29, ...) and
    one-component scans: every pixel within 1 level (measured: equal);
  * the committed fixtures of `fixtures/jpeg/` (which `chip_smoke.py`
    decodes with nvJPEG) against the PIL pixels committed beside them:
    equal;
  * progressive, CMYK / Adobe, 12-bit-table and truncated files raise
    naming the file;
  * the port loader's view of a JPEG (RGB and gray, at its size and
    resized) against the JAX loader's: within 1/255 (the JAX loader turns
    a gray JPEG into three equal channels, and so does the port);
  * a loader on a CUDA device decodes JPEGs with nvJPEG only: without the
    library it raises naming the file, it never falls back to the plain
    decoder; nvJPEG's constants are read from its header.
"""

import glob
import hashlib
import io
import json
import os
import struct

import numpy as np
import pytest
from PIL import Image

from gaussianavatars_tpu.data.cameras import Camera as JaxCamera
from gaussianavatars_tpu.data.loader import (
    load_camera_image as jax_load_camera_image,
)
from gaussianavatars_torch.data import loader
from gaussianavatars_torch.data.cameras import Camera
from gaussianavatars_torch.utils import nvjpeg
from gaussianavatars_torch.utils.jpeg import JPEGError, decode_jpeg, read_jpeg
from gaussianavatars_torch.utils.png import read_png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "fixtures", "jpeg")


def _image(w, h, seed, gray=False):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 110 * np.sin(x / 3.0 + c) * np.cos(y / 5.0 - c)
                    for c in range(3)], -1) + rng.normal(0, 30, (h, w, 3))
    img = np.clip(img, 0, 255).astype(np.uint8)
    return img[..., 0] if gray else img


def _jpeg(img, **opts):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", **opts)
    return buf.getvalue()


def _pil(data):
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im)


CASES = {
    "444_q95_33x17": ((33, 17), dict(quality=95, subsampling=0)),
    "422_q90_33x17": ((33, 17), dict(quality=90, subsampling=1)),
    "420_q75_37x29": ((37, 29), dict(quality=75, subsampling=2)),
    "420_q50_64x48": ((64, 48), dict(quality=50, subsampling=2)),
    "422_q30_17x33": ((17, 33), dict(quality=30, subsampling=1)),
    "420_q100_8x8": ((8, 8), dict(quality=100, subsampling=2)),
    "420_q85_3x2": ((3, 2), dict(quality=85, subsampling=2)),
    "420_optimized_71x53": ((71, 53), dict(quality=80, optimize=True)),
    "restart_blocks_57x41": ((57, 41), dict(quality=75,
                                            restart_marker_blocks=1)),
    "restart_rows_444_40x41": ((40, 41), dict(quality=70, subsampling=0,
                                              restart_marker_rows=1)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_decoder_matches_pil(case):
    (w, h), opts = CASES[case]
    data = _jpeg(_image(w, h, seed=len(case)), **opts)
    got, ref = decode_jpeg(data, case), _pil(data)
    assert got.shape == ref.shape == (h, w, 3)
    assert got.dtype == np.uint8
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1


@pytest.mark.parametrize("size", [(45, 29), (16, 16), (33, 17)])
def test_plain_decoder_gray_matches_pil(size):
    data = _jpeg(_image(*size, seed=7, gray=True), quality=85)
    got, ref = decode_jpeg(data), _pil(data)
    assert got.shape == ref.shape == size[::-1]
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1


def _digest(pixels):
    return {"shape": list(pixels.shape),
            "sha256": hashlib.sha256(np.ascontiguousarray(
                pixels, np.uint8).tobytes()).hexdigest()}


def test_fixtures_match_their_pil_pixels():
    """Each fixture's PIL pixels are what is committed beside it (a PNG,
    or for the 802x550 render the SHA-256 of the array), and the plain
    decoder gives them to the bit (progressive: it raises)."""
    paths = sorted(glob.glob(os.path.join(FIXTURES, "*.jpg")))
    assert len(paths) == 7
    total = sum(os.path.getsize(p) for p in glob.glob(
        os.path.join(FIXTURES, "*")))
    assert total < 300_000
    for path in paths:
        with Image.open(path) as im:
            pil = np.asarray(im)
        if os.path.exists(path[:-4] + ".png"):
            np.testing.assert_array_equal(pil, read_png(path[:-4] + ".png"))
        else:
            with open(path[:-4] + ".pil.json") as f:
                assert _digest(pil) == json.load(f)
        if "progressive" in path:
            with pytest.raises(JPEGError, match=f"{path}.*progressive"):
                read_jpeg(path)
            continue
        np.testing.assert_array_equal(read_jpeg(path), pil)


def test_unsupported_files_raise_naming_the_file(tmp_path):
    img = _image(24, 16, seed=1)
    cases = {"progressive.jpg": (_jpeg(img, progressive=True),
                                 "progressive")}
    cmyk = io.BytesIO()
    Image.fromarray(img).convert("CMYK").save(cmyk, "JPEG")
    cases["cmyk.jpg"] = (cmyk.getvalue(), "Adobe|components")
    good = _jpeg(img, quality=90)
    cases["truncated.jpg"] = (good[:len(good) // 2], "truncated")
    cases["no_eoi.jpg"] = (good[:-2], "truncated")
    # a 16-bit quantization table (what 12-bit JPEGs carry)
    pos = good.index(b"\xff\xdb")
    (length,) = struct.unpack(">H", good[pos + 2:pos + 4])
    table = good[pos + 4:pos + 2 + length]
    wide = bytes([0x10 | (table[0] & 15)]) + bytes(
        b for v in table[1:65] for b in (0, v))
    cases["wide_dqt.jpg"] = (good[:pos] + b"\xff\xdb"
                             + struct.pack(">H", len(wide) + 2) + wide
                             + good[pos + 2 + length:], "16-bit")
    cases["png.jpg"] = (b"\x89PNG\r\n\x1a\n" + bytes(16), "not a JPEG")
    for name, (data, what) in cases.items():
        path = str(tmp_path / name)
        with open(path, "wb") as f:
            f.write(data)
        with pytest.raises(JPEGError, match=f"{path}: .*({what})"):
            read_jpeg(path)


def _cams(path, w, h):
    kw = dict(uid=0, R=np.eye(3), T=np.array([0.0, 0.0, 2.0]), fovx=0.8,
              fovy=0.6, width=w, height=h, image_path=path,
              bg=np.array([1.0, 0.0, 0.0], np.float32))
    return Camera(**kw), JaxCamera(**kw)


@pytest.mark.parametrize("kind", ["rgb", "gray"])
@pytest.mark.parametrize("resolution", [1, 2])
def test_loader_view_matches_jax(tmp_path, kind, resolution):
    """The port's loader on the CPU and the JAX loader give the same
    [3, H, W] view of a JPEG, at its size (the JAX loader's libjpeg path)
    and resized (its PIL path)."""
    w, h = 38, 26
    path = str(tmp_path / f"{kind}.jpg")
    Image.fromarray(_image(w, h, seed=3, gray=kind == "gray")).save(
        path, "JPEG", quality=85)
    tcam, jcam = _cams(path, w, h)
    got = loader.load_camera_image(tcam, resolution)
    ref = jax_load_camera_image(jcam, resolution)
    assert got.shape == ref.shape == (3, h // resolution, w // resolution)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1.0 / 255 + 1e-6)
    if kind == "gray":
        np.testing.assert_array_equal(got[0], got[1])
        np.testing.assert_array_equal(got[0], got[2])


def test_cuda_loader_never_decodes_on_the_cpu(tmp_path, monkeypatch):
    """A loader on a CUDA device hands JPEGs to nvJPEG alone: without the
    library (an empty CUDA_HOME) every path raises naming the file."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    monkeypatch.setattr(nvjpeg, "_LIB", {})
    path = str(tmp_path / "view.jpg")
    Image.fromarray(_image(16, 16, seed=2)).save(path, "JPEG")
    tcam, _ = _cams(path, 16, 16)
    with pytest.raises(nvjpeg.NvJpegError, match=f"{path}: nvJPEG not found"):
        next(iter(loader.iterate_once([tcam], device="cuda")))
    stream = loader.CameraLoader([tcam], device="cuda", num_threads=1)
    try:
        with pytest.raises(nvjpeg.NvJpegError, match=path):
            next(stream)
    finally:
        stream.stop()
    # the CPU loader decodes the same file
    assert loader.load_camera_image(tcam).shape == (3, 16, 16)
    with pytest.raises(ValueError, match="CUDA device"):
        nvjpeg.NvJpegDecoder("cpu")


def test_nvjpeg_constants_from_the_header(tmp_path):
    header = tmp_path / "nvjpeg.h"
    header.write_text("""
#define NVJPEG_MAX_COMPONENT 4
typedef enum
{
    NVJPEG_STATUS_SUCCESS                       = 0,
    NVJPEG_STATUS_NOT_INITIALIZED               = 1,
    NVJPEG_STATUS_BAD_JPEG                      = 3,
} nvjpegStatus_t;
typedef struct
{
    int other;
} nvjpegOther_t;
typedef enum
{
    NVJPEG_OUTPUT_UNCHANGED   = 0,
    NVJPEG_OUTPUT_RGB         = 3,
    NVJPEG_OUTPUT_RGBI        = 5,
} nvjpegOutputFormat_t;
typedef struct
{
    unsigned char * channel[NVJPEG_MAX_COMPONENT];
    size_t    pitch[NVJPEG_MAX_COMPONENT];
} nvjpegImage_t;
""")
    consts = nvjpeg._constants(header)
    assert consts["rgbi"] == 5 and consts["max_component"] == 4
    assert consts["status"][3] == "NVJPEG_STATUS_BAD_JPEG"
    assert consts["pitch_type"] is nvjpeg.ctypes.c_size_t
    header.write_text("typedef enum { NVJPEG_OUTPUT_RGB = 3 } x;")
    with pytest.raises(nvjpeg.NvJpegError, match="constants"):
        nvjpeg._constants(header)
