"""A minimal tensorboard event writer: scalars, images and histograms.

The port's counterpart of the tensorboardX `SummaryWriter` that the JAX
package's `train.py` creates (reference train.py:81-87). The GPU host has
neither tensorboardX nor, as far as is known, tensorboard, so the port
writes the event file itself:

  * the file is `events.out.tfevents.<time>.<host>` in the log directory,
    a sequence of TFRecords (length, masked CRC32C of the length, data,
    masked CRC32C of the data), the first holding the `brain.Event:2`
    version event;
  * each record is an `Event` protobuf (wall_time, step, summary) encoded
    here by hand;
  * `add_scalar` writes a `simple_value`; `add_images` a batch of one RGB
    image as a PNG (`utils/png.py`), quantised as tensorboardX does (x *
    255, clipped, truncated); `add_histogram` a `HistogramProto` over
    tensorboardX's default buckets (+-1e-12 * 1.1^k up to 1e20, and 0).

Tags are cleaned as tensorboardX cleans them (every character other than
letters, digits, `_`, `-`, `/` and `.` becomes `_`), so both packages'
runs show the same tags. Nothing here imports tensorboard or protobuf.
"""

from __future__ import annotations

import os
import re
import socket
import struct
import time

import numpy as np

from gaussianavatars_torch.utils.png import encode_png

FILE_VERSION = "brain.Event:2"
_INVALID_TAG = re.compile(r"[^-/\w\.]")


def _crc32c_table() -> list[int]:
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli) of `data`, table-driven."""
    crc = 0xFFFFFFFF
    table = _CRC_TABLE
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    """The TFRecord checksum: the CRC rotated right by 15, plus a
    constant, modulo 2^32."""
    crc = crc32c(data)
    return ((((crc >> 15) | (crc << 17)) & 0xFFFFFFFF) + 0xA282EAD8) \
        & 0xFFFFFFFF


def tfrecord(data: bytes) -> bytes:
    header = struct.pack("<Q", len(data))
    return (header + struct.pack("<I", masked_crc32c(header)) + data
            + struct.pack("<I", masked_crc32c(data)))


def read_tfrecords(path: str) -> list[bytes]:
    """The records of a TFRecord file; raises ValueError on a bad CRC or a
    truncated record."""
    with open(path, "rb") as f:
        buf = f.read()
    records, pos = [], 0
    while pos < len(buf):
        if pos + 12 > len(buf):
            raise ValueError(f"{path}: truncated record header at {pos}")
        header = buf[pos:pos + 8]
        (length,) = struct.unpack("<Q", header)
        (crc,) = struct.unpack("<I", buf[pos + 8:pos + 12])
        if crc != masked_crc32c(header):
            raise ValueError(f"{path}: bad length CRC at byte {pos}")
        data = buf[pos + 12:pos + 12 + length]
        tail = buf[pos + 12 + length:pos + 16 + length]
        if len(data) != length or len(tail) != 4:
            raise ValueError(f"{path}: truncated record at byte {pos}")
        if struct.unpack("<I", tail)[0] != masked_crc32c(data):
            raise ValueError(f"{path}: bad data CRC at byte {pos}")
        records.append(data)
        pos += 16 + length
    return records


# ---- protobuf wire format ---------------------------------------------------

def _varint(n: int) -> bytes:
    n &= (1 << 64) - 1                  # int64 as two's complement
    out = bytearray()
    while n > 0x7F:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    out.append(n)
    return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _len_field(field: int, data: bytes) -> bytes:
    return _key(field, 2) + _varint(len(data)) + data


def _double(field: int, x: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", float(x))


def _float(field: int, x: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", float(x))


def _int(field: int, n: int) -> bytes:
    return _key(field, 0) + _varint(int(n))


def _packed_doubles(field: int, xs) -> bytes:
    return _len_field(field, np.asarray(xs, "<f8").tobytes())


def _event(wall_time: float, step: int | None = None,
           summary_value: bytes | None = None,
           file_version: str | None = None) -> bytes:
    out = _double(1, wall_time)
    if step:
        out += _int(2, step)
    if file_version is not None:
        out += _len_field(3, file_version.encode())
    if summary_value is not None:
        out += _len_field(5, _len_field(1, summary_value))   # Summary.value
    return out


def clean_tag(tag: str) -> str:
    return _INVALID_TAG.sub("_", tag).lstrip("/")


def default_bins() -> list[float]:
    """tensorboardX's default histogram bucket edges."""
    v, pos, neg = 1e-12, [], []
    while v < 1e20:
        pos.append(v)
        neg.append(-v)
        v *= 1.1
    return neg[::-1] + [0] + pos


def histogram_proto(values) -> bytes:
    """A HistogramProto of `values` over the default buckets, keeping the
    buckets from the one before the first non-empty bucket to the last
    non-empty one, as tensorboardX's `make_histogram` does."""
    values = np.asarray(values, np.float64).reshape(-1)
    if values.size == 0:
        raise ValueError("a histogram needs at least one value")
    counts, limits = np.histogram(values, bins=default_bins())
    cum = np.cumsum(counts > 0)
    start, end = np.searchsorted(cum, [0, cum[-1] - 1], side="right")
    start, end = int(start), int(end) + 1
    counts = (counts[start - 1:end] if start > 0
              else np.concatenate([[0], counts[:end]]))
    limits = limits[start:end + 1]
    return (_double(1, values.min()) + _double(2, values.max())
            + _double(3, values.size) + _double(4, values.sum())
            + _double(5, values.dot(values))
            + _packed_doubles(6, limits) + _packed_doubles(7, counts))


def image_proto(chw) -> bytes:
    """An Image summary of a [3, H, W] image in [0, 1]: (x * 255) clipped
    to 0..255 and truncated, PNG-encoded."""
    pixels = (np.asarray(chw, np.float32) * 255.0).clip(0, 255).astype(
        np.uint8).transpose(1, 2, 0)
    h, w, c = pixels.shape
    return (_int(1, h) + _int(2, w) + _int(3, c)
            + _len_field(4, encode_png(np.ascontiguousarray(pixels))))


class SummaryWriter:
    """Writes the events of one run to `<logdir>/events.out.tfevents.
    <time>.<host>` (the directory is made). Each add_* call writes its
    record at once; `close` ends the file."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        self.path = os.path.join(
            logdir, f"events.out.tfevents.{str(time.time())[:10]}."
                    f"{socket.gethostname()}")
        self._file = open(self.path, "ab")
        self._write(_event(time.time(), file_version=FILE_VERSION))

    def _write(self, event: bytes):
        self._file.write(tfrecord(event))

    def _value(self, tag: str, body: bytes, step) -> None:
        self._write(_event(time.time(), step,
                           _len_field(1, clean_tag(tag).encode()) + body))

    def add_scalar(self, tag: str, value, global_step: int | None = None):
        self._value(tag, _float(2, float(value)), global_step)

    def add_images(self, tag: str, images, global_step: int | None = None):
        """A batch of one [3, H, W] image in [0, 1] (tensorboardX writes a
        batch of one as that image alone)."""
        images = np.asarray(images, np.float32)
        if images.ndim != 4 or images.shape[:2] != (1, 3):
            raise ValueError(f"add_images takes one RGB image as [1, 3, H, "
                             f"W], not {images.shape}")
        self._value(tag, _len_field(4, image_proto(images[0])), global_step)

    def add_histogram(self, tag: str, values, global_step: int | None = None):
        self._value(tag, _len_field(5, histogram_proto(values)), global_step)

    def close(self):
        if not self._file.closed:
            self._file.close()
