"""8-bit PNG decoder and encoder on `zlib` and numpy alone.

The port's counterpart of the PIL and libpng (`gaussianavatars_tpu/native`)
image IO of the JAX loader (`gaussianavatars_tpu/data/loader.py:47-74`).
The GPU host the port runs on has numpy but no PIL and no libpng headers,
so the port reads and writes its PNGs with this module; `read_png` raises
naming the file on any other format. JPEG views decode elsewhere
(`utils/jpeg.py` on the CPU, `utils/nvjpeg.py` on the card; the loader's
`read_image` picks by the file's first bytes). `image_size` reads the
size of a PNG or a JPEG from its header.

Supported: non-interlaced PNGs of bit depth 8, gray (color type 0), RGB (2)
and RGBA (6), with any of the five row filters. An image whose rows use
only the none, sub and up filters is rebuilt row by row (a running sum
for sub). With average or Paeth rows, decoding undoes the filters for the
whole image in one pass over its anti-diagonals: a byte depends only on
its left, upper and upper-left neighbours, so every pixel of one
anti-diagonal can be rebuilt at once (H + W - 1 numpy steps).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}            # color type -> channels
_COLOR_TYPE = {1: 0, 3: 2, 4: 6}          # channels -> color type
_FORMATS = ((b"\xff\xd8\xff", "JPEG"), (b"GIF8", "GIF"), (b"BM", "BMP"),
            (b"RIFF", "WEBP"), (b"II*\x00", "TIFF"), (b"MM\x00*", "TIFF"))


class PNGError(ValueError):
    """The file is not an 8-bit gray, RGB or RGBA PNG this module reads."""


def _unsupported(path: str, head: bytes) -> PNGError:
    fmt = next((name for magic, name in _FORMATS if head.startswith(magic)),
               "an unknown format")
    return PNGError(f"{path}: {fmt} images are not supported; the port reads "
                    "8-bit gray, RGB and RGBA PNGs only")


def _chunks(buf: bytes, path: str):
    """Yield (type, data) of each chunk after the signature."""
    pos = len(SIGNATURE)
    while pos + 8 <= len(buf):
        length, ctype = struct.unpack(">I4s", buf[pos:pos + 8])
        data = buf[pos + 8:pos + 8 + length]
        crc = buf[pos + 8 + length:pos + 12 + length]
        if len(data) != length or len(crc) != 4:
            raise PNGError(f"{path}: truncated {ctype!r} chunk")
        if zlib.crc32(ctype + data) != struct.unpack(">I", crc)[0]:
            raise PNGError(f"{path}: bad CRC in the {ctype!r} chunk")
        yield ctype, data
        if ctype == b"IEND":
            return
        pos += 12 + length
    raise PNGError(f"{path}: no IEND chunk")


def _header(data: bytes, path: str):
    w, h, depth, ctype, comp, filt, interlace = struct.unpack(">IIBBBBB",
                                                               data)
    if depth != 8 or ctype not in _CHANNELS or interlace or comp or filt:
        raise PNGError(
            f"{path}: PNG of bit depth {depth}, color type {ctype}, "
            f"interlace {interlace} is not supported; the port reads "
            "8-bit gray, RGB and RGBA PNGs without interlacing only")
    return w, h, _CHANNELS[ctype]


def png_size(path: str) -> tuple[int, int]:
    """(width, height) from the PNG header of `path`."""
    with open(path, "rb") as f:
        head = f.read(33)
    if not head.startswith(SIGNATURE):
        raise _unsupported(path, head)
    length, ctype = struct.unpack(">I4s", head[8:16])
    if ctype != b"IHDR" or length != 13:
        raise PNGError(f"{path}: the first chunk is not IHDR")
    w, h, _ = _header(head[16:29], path)
    return w, h


_JPEG_SOF = (0xC0, 0xC1, 0xC2)      # baseline, extended, progressive


def _jpeg_size(path: str, buf: bytes) -> tuple[int, int]:
    """(width, height) from the first SOF0/1/2 segment of a JPEG."""
    pos = 2
    while pos + 4 <= len(buf):
        if buf[pos] != 0xFF:
            raise PNGError(f"{path}: corrupt JPEG marker at byte {pos}")
        marker = buf[pos + 1]
        if marker == 0xFF:                       # fill byte
            pos += 1
            continue
        if marker == 0x01 or 0xD0 <= marker <= 0xD8:   # no length field
            pos += 2
            continue
        if marker in (0xD9, 0xDA):               # end of image, scan data
            break
        (length,) = struct.unpack(">H", buf[pos + 2:pos + 4])
        if marker in _JPEG_SOF:
            h, w = struct.unpack(">HH", buf[pos + 5:pos + 9])
            return w, h
        pos += 2 + length
    raise PNGError(f"{path}: no SOF0/1/2 segment before the scan data")


def image_size(path: str) -> tuple[int, int]:
    """(width, height) of a PNG (its IHDR chunk) or a JPEG (its first
    SOF0/1/2 segment) from the file's header, without decoding it; other
    formats raise naming the file."""
    with open(path, "rb") as f:
        head = f.read(3)
        if head.startswith(b"\xff\xd8\xff"):
            return _jpeg_size(path, head + f.read())
    return png_size(path)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(rows: np.ndarray, h: int, w: int, ch: int,
              path: str) -> np.ndarray:
    ftype = rows[:, 0]
    data = rows[:, 1:].reshape(h, w, ch)
    if (ftype > 4).any():
        raise PNGError(f"{path}: unknown row filter {int(ftype.max())}")
    if not ftype.any():
        return data.copy()
    if ftype.max() <= 2:
        # none, sub and up only: a row needs its left neighbours (a running
        # sum, modulo 256 in uint8) or the row above, row by row
        out = np.empty_like(data)
        prev = np.zeros_like(data[0])
        for r in range(h):
            if ftype[r] == 1:
                out[r] = np.cumsum(data[r], axis=0, dtype=np.uint8)
            else:
                np.add(data[r], prev if ftype[r] == 2 else 0, out=out[r])
            prev = out[r]
        return out
    # Skewed layout: s[r + x + 2, r + 1] holds pixel (r, x), so that the
    # anti-diagonal d = r + x is the contiguous row d + 2 of `s`, and a
    # pixel's left, upper and upper-left neighbours lie in rows d + 1,
    # d + 1 and d. Column 0 and the cells left of each image row stay
    # zero: the zero neighbours of the border.
    rr, xx = np.mgrid[0:h, 0:w]
    s = np.zeros((h + w + 1, h + 1, ch), np.int16)
    filt = np.zeros_like(s)
    filt[rr + xx + 2, rr + 1] = data
    t = ftype.reshape(h, 1)
    is_sub, is_up, is_avg, is_paeth = (t == 1, t == 2, t == 3, t == 4)
    paeth_rows = np.flatnonzero(ftype == 4)
    for d in range(h + w - 1):
        r0, r1 = max(0, d - w + 1), min(h, d + 1)
        a = s[d + 1, r0 + 1:r1 + 1]
        b = s[d + 1, r0:r1]
        pred = np.where(is_sub[r0:r1], a, 0)
        pred = np.where(is_up[r0:r1], b, pred)
        pred = np.where(is_avg[r0:r1], (a + b) >> 1, pred)
        if paeth_rows.size and paeth_rows[0] < r1 and paeth_rows[-1] >= r0:
            pred = np.where(is_paeth[r0:r1], _paeth(a, b, s[d, r0:r1]),
                            pred)
        s[d + 2, r0 + 1:r1 + 1] = (filt[d + 2, r0 + 1:r1 + 1] + pred) & 255
    return s[rr + xx + 2, rr + 1].astype(np.uint8)


def decode_png(buf: bytes, path: str = "<bytes>") -> np.ndarray:
    """Decode PNG bytes: uint8 [H, W] (gray) or [H, W, C] (RGB, RGBA)."""
    if not buf.startswith(SIGNATURE):
        raise _unsupported(path, buf[:8])
    header, idat = None, []
    for ctype, data in _chunks(buf, path):
        if ctype == b"IHDR":
            header = _header(data, path)
        elif ctype == b"IDAT":
            idat.append(data)
    if header is None or not idat:
        raise PNGError(f"{path}: no IHDR or no IDAT chunk")
    w, h, ch = header
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as exc:
        raise PNGError(f"{path}: corrupt image data ({exc})") from exc
    if len(raw) != h * (1 + w * ch):
        raise PNGError(f"{path}: {len(raw)} bytes of image data for a "
                       f"{w}x{h}x{ch} image")
    rows = np.frombuffer(raw, np.uint8).reshape(h, 1 + w * ch)
    img = _unfilter(rows, h, w, ch, path)
    return img[..., 0] if ch == 1 else img


def read_png(path: str) -> np.ndarray:
    """Decode the PNG file `path` (see `decode_png`)."""
    with open(path, "rb") as f:
        return decode_png(f.read(), path)


def _filter(img: np.ndarray, filter_type: int) -> np.ndarray:
    """Rows of `img` [H, W, C] filtered with one filter type (uint8)."""
    if filter_type == 0:
        return img
    x = img.astype(np.int16)
    a = np.zeros_like(x)
    a[:, 1:] = x[:, :-1]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    if filter_type == 1:
        pred = a
    elif filter_type == 2:
        pred = b
    elif filter_type == 3:
        pred = (a + b) >> 1
    else:
        c = np.zeros_like(x)
        c[1:, 1:] = x[:-1, :-1]
        pred = _paeth(a, b, c)
    return ((x - pred) & 255).astype(np.uint8)


def encode_png(img: np.ndarray, filter_type: int = 0) -> bytes:
    """Encode uint8 [H, W] (gray), [H, W, 3] (RGB) or [H, W, 4] (RGBA) as
    PNG bytes, every row with filter `filter_type` (0 none, 1 sub, 2 up,
    3 average, 4 Paeth), zlib level 6."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"encode_png takes uint8 images, not {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    h, w, ch = img.shape
    if ch not in _COLOR_TYPE:
        raise ValueError(f"encode_png takes 1, 3 or 4 channels, not {ch}")
    if filter_type not in range(5):
        raise ValueError(f"unknown PNG filter type {filter_type}")
    rows = np.empty((h, 1 + w * ch), np.uint8)
    rows[:, 0] = filter_type
    rows[:, 1:] = _filter(img, filter_type).reshape(h, w * ch)

    def chunk(ctype: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + ctype + data
                + struct.pack(">I", zlib.crc32(ctype + data)))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[ch], 0, 0, 0)
    return (SIGNATURE + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray, filter_type: int = 0) -> None:
    """Write `img` (see `encode_png`) to `path`."""
    with open(path, "wb") as f:
        f.write(encode_png(img, filter_type))
