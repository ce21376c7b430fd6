"""Baseline JPEG decoder on numpy alone: the plain decoder of the port.

The port's counterpart of the libjpeg decode of the JAX loader
(`gaussianavatars_tpu/data/loader.py:47-64` through
`gaussianavatars_tpu/native` or PIL), for the CPU. On the card the loader
decodes JPEGs with nvJPEG (`utils/nvjpeg.py`); this module is what the
CPU runs and what the card's pixels are held against.

Supported: baseline and extended Huffman frames (SOF0 and SOF1) of 8-bit
samples, 1 component (gray) or 3 (YCbCr), any sampling factors,
interleaved or one-component scans, restart intervals. Everything else
raises `JPEGError` naming the file: progressive (SOF2), lossless,
hierarchical and arithmetic-coded frames, 12-bit samples, 2 or 4
components (CMYK), an Adobe APP14 segment (its colour transform) and RGB
component ids. So does a truncated file: its entropy-coded data ends
before the last block, or the EOI marker is missing. (PIL with
`LOAD_TRUNCATED_IMAGES`, which the JAX loader sets, decodes such a file
partially instead; a view that was cut off is not a ground truth.)

It computes what libjpeg(-turbo) computes with its defaults, which is what
PIL and the JAX package's `native/imgio` run:
  * the "islow" IDCT (jidctint.c): 13-bit fixed-point constants, two
    passes with PASS1_BITS = 2, the output range-limited through the
    masked post-IDCT table;
  * "fancy" chroma upsampling (jdsample.c): the triangle filter 3/4, 1/4
    for 2x1 and 1x2 factors (rounding biases 1 and 2) and for 2x2 (biases
    8 and 7 of 16), edge rows and columns replicated; other factors, and
    2x1 and 2x2 planes 2 samples wide or less, are replicated (box);
  * YCbCr -> RGB with jdcolor.c's 16-bit fixed-point tables.
Its pixels equal PIL's on the files the tests write (4:4:4, 4:2:2, 4:2:0,
gray, restart markers, sizes that are not multiples of 16).

The Huffman decode walks the symbols in Python (a 16-bit lookup table over
the unstuffed bit stream); the IDCT, upsampling and colour conversion are
vectorised over all blocks.
"""

from __future__ import annotations

import struct

import numpy as np


class JPEGError(ValueError):
    """The file is not a JPEG this module decodes."""


# zigzag index k -> natural (row-major) index
_NATURAL = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
_NATURAL_LIST = _NATURAL.tolist()

_UNSUPPORTED_SOF = {
    0xC2: "progressive", 0xC3: "lossless", 0xC5: "hierarchical",
    0xC6: "hierarchical progressive", 0xC7: "hierarchical lossless",
    0xC9: "arithmetic-coded", 0xCA: "arithmetic-coded progressive",
    0xCB: "arithmetic-coded lossless", 0xCD: "arithmetic-coded hierarchical",
    0xCE: "arithmetic-coded hierarchical progressive",
    0xCF: "arithmetic-coded hierarchical lossless"}


def is_jpeg(head: bytes) -> bool:
    return head[:3] == b"\xff\xd8\xff"


# ---- Huffman decoding -------------------------------------------------------

def _lookup(bits: list[int], values: bytes, path: str):
    """Canonical Huffman codes (JPEG Annex C) as two 65536-entry lists over
    the next 16 bits of the stream: symbol and code length (0: no code)."""
    sym = np.zeros(1 << 16, np.int64)
    length = np.zeros(1 << 16, np.int64)
    code, k = 0, 0
    for n in range(1, 17):
        for _ in range(bits[n - 1]):
            if k >= len(values):
                raise JPEGError(f"{path}: Huffman table has more codes than "
                                "values")
            if code >= 1 << n:
                raise JPEGError(f"{path}: bad Huffman table")
            lo, hi = code << (16 - n), (code + 1) << (16 - n)
            sym[lo:hi] = values[k]
            length[lo:hi] = n
            code += 1
            k += 1
        code <<= 1
    return sym.tolist(), length.tolist()


def _peek16(data: bytes) -> list[int]:
    """The 16 bits starting at every bit position of `data` (1 bits past
    its end, as the JPEG padding), one int per position."""
    bits = np.unpackbits(np.frombuffer(data, np.uint8))
    bits = np.concatenate([bits, np.ones(32, np.uint8)]).astype(np.int64)
    n = len(bits) - 16
    acc = np.zeros(n, np.int64)
    for i in range(16):
        acc = (acc << 1) | bits[i:i + n]
    return acc.tolist()


def _unstuff(seg: bytes) -> bytes:
    return seg.replace(b"\xff\x00", b"\xff")


def _bad_code(path: str, pos: int, nbits: int) -> JPEGError:
    if pos >= nbits:
        return JPEGError(f"{path}: truncated JPEG (the entropy-coded data "
                         "ends inside a block)")
    return JPEGError(f"{path}: bad Huffman code at bit {pos}")


def _extend(v: int, s: int) -> int:
    return v - (1 << s) + 1 if v < 1 << (s - 1) else v


class _Frame:
    def __init__(self, height, width, comps):
        self.height = height
        self.width = width
        self.comps = comps        # list of dicts: id, h, v, tq
        self.hmax = max(c["h"] for c in comps)
        self.vmax = max(c["v"] for c in comps)
        self.mcux = -(-width // (8 * self.hmax))
        self.mcuy = -(-height // (8 * self.vmax))
        for c in comps:
            c["bw"] = self.mcux * c["h"]          # blocks, padded to MCUs
            c["bh"] = self.mcuy * c["v"]
            # the component's own size (libjpeg's downsampled_width/height)
            c["dw"] = -(-width * c["h"] // self.hmax)
            c["dh"] = -(-height * c["v"] // self.vmax)
            c["coef"] = np.zeros((c["bh"] * c["bw"], 64), np.int64)
            c["seen"] = False


def _decode_scan(frame: _Frame, scan_comps, data: bytes, restart: int,
                 dc_tables, ac_tables, path: str) -> None:
    """Decode one scan's entropy-coded data (RST markers included) into
    the components' coefficient arrays."""
    # split at the restart markers: each interval starts byte-aligned with
    # zero DC predictions
    segments, pos, start = [], 0, 0
    while True:
        i = data.find(b"\xff", pos)
        if i < 0 or i + 1 >= len(data):
            break
        nxt = data[i + 1]
        if 0xD0 <= nxt <= 0xD7:
            segments.append(data[start:i])
            start = pos = i + 2
        else:
            pos = i + 1 if nxt != 0 else i + 2
    segments.append(data[start:])

    single = len(scan_comps) == 1
    if single:
        c = scan_comps[0]
        nx, ny = -(-c["dw"] // 8), -(-c["dh"] // 8)
        units = [[(c, by * c["bw"] + bx)] for by in range(ny)
                 for bx in range(nx)]
    else:
        units = []
        for my in range(frame.mcuy):
            for mx in range(frame.mcux):
                unit = []
                for c in scan_comps:
                    for v in range(c["v"]):
                        for h in range(c["h"]):
                            unit.append((c, (my * c["v"] + v) * c["bw"]
                                         + mx * c["h"] + h))
                units.append(unit)
    per_seg = restart if restart else len(units)
    need = -(-len(units) // per_seg)
    if len(segments) < need:
        raise JPEGError(f"{path}: truncated JPEG ({len(segments)} of {need} "
                        "restart intervals)")
    flat = {id(c): c["coef"].reshape(-1).tolist() for c in scan_comps}
    natural = _NATURAL_LIST
    for s_idx in range(need):
        seg = _unstuff(segments[s_idx])
        peek = _peek16(seg)
        nbits = 8 * len(seg)
        pred = {id(c): 0 for c in scan_comps}
        pos = 0
        for unit in units[s_idx * per_seg:(s_idx + 1) * per_seg]:
            for c, blk in unit:
                dsym, dlen = dc_tables[c["td"]]
                asym, alen = ac_tables[c["ta"]]
                out = flat[id(c)]
                base = blk * 64
                code = peek[pos]
                n = dlen[code]
                if n == 0:
                    raise _bad_code(path, pos, nbits)
                s = dsym[code]
                pos += n
                diff = 0
                if s:
                    diff = _extend(peek[pos] >> (16 - s), s)
                    pos += s
                pred[id(c)] += diff
                out[base] = pred[id(c)]
                k = 1
                while k < 64:
                    code = peek[pos]
                    n = alen[code]
                    if n == 0:
                        raise _bad_code(path, pos, nbits)
                    rs = asym[code]
                    pos += n
                    r, s = rs >> 4, rs & 15
                    if s:
                        k += r
                        if k > 63:
                            raise JPEGError(f"{path}: coefficient index "
                                            "past 63")
                        out[base + natural[k]] = _extend(
                            peek[pos] >> (16 - s), s)
                        pos += s
                        k += 1
                    elif r == 15:
                        k += 16
                    else:
                        break
            if pos > nbits:
                raise JPEGError(f"{path}: truncated JPEG (the entropy-coded "
                                "data ends inside a block)")
    for c in scan_comps:
        c["coef"] = np.asarray(flat[id(c)], np.int64).reshape(-1, 64)
        c["seen"] = True


# ---- IDCT (jidctint.c, jpeg_idct_islow) -------------------------------------

_CONST_BITS, _PASS1_BITS = 13, 2
_F0298, _F0390, _F0541, _F0765 = 2446, 3196, 4433, 6270
_F0899, _F1175, _F1501, _F1847 = 7373, 9633, 12299, 15137
_F1961, _F2053, _F2562, _F3072 = 16069, 16819, 20995, 25172


def _descale(x, n):
    return (x + (1 << (n - 1))) >> n


def _idct_1d(d0, d1, d2, d3, d4, d5, d6, d7, shift):
    """One islow pass over the last axis layout given as eight inputs."""
    z1 = (d2 + d6) * _F0541
    tmp2 = z1 - d6 * _F1847
    tmp3 = z1 + d2 * _F0765
    tmp0 = (d0 + d4) << _CONST_BITS
    tmp1 = (d0 - d4) << _CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = d7, d5, d3, d1
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * _F1175
    t0, t1, t2, t3 = t0 * _F0298, t1 * _F2053, t2 * _F3072, t3 * _F1501
    z1, z2 = z1 * -_F0899, z2 * -_F2562
    z3, z4 = z3 * -_F1961 + z5, z4 * -_F0390 + z5
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4
    return [_descale(v, shift) for v in (
        tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
        tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)]


def _range_limit_table() -> np.ndarray:
    """libjpeg's post-IDCT table, indexed by (x & 1023): x + 128 clamped
    to 0..255 for |x| < 512, wrapping beyond."""
    i = np.arange(1024)
    x = np.where(i < 512, i, i - 1024)
    return np.clip(x + 128, 0, 255).astype(np.uint8)


_RANGE_LIMIT = _range_limit_table()


def idct_islow(coef: np.ndarray, qt: np.ndarray) -> np.ndarray:
    """Dequantize and inverse-transform blocks: coef [N, 64] (natural
    order) and qt [64] -> uint8 samples [N, 8, 8]."""
    x = (coef * qt).reshape(-1, 8, 8)          # [N, row (v), col (u)]
    # pass 1: the columns (over the rows' index), into the work space
    cols = _idct_1d(*[x[:, k, :] for k in range(8)],
                    _CONST_BITS - _PASS1_BITS)
    ws = np.stack(cols, axis=1)                # [N, y, u]
    rows = _idct_1d(*[ws[:, :, k] for k in range(8)],
                    _CONST_BITS + _PASS1_BITS + 3)
    out = np.stack(rows, axis=2)               # [N, y, x]
    return _RANGE_LIMIT[out & 1023]


# ---- upsampling (jdsample.c) and colour (jdcolor.c) ---------------------------

def _upsample(plane: np.ndarray, hf: int, vf: int) -> np.ndarray:
    """A component plane [dh, dw] (uint8) expanded hf x vf times as
    libjpeg's fancy upsampler does; int64 result."""
    p = plane.astype(np.int64)
    dh, dw = p.shape
    if (hf, vf) == (1, 1):
        return p
    fancy = dw > 2
    if fancy and (hf, vf) == (2, 1):
        left = np.concatenate([p[:, :1], p[:, :-1]], axis=1)
        right = np.concatenate([p[:, 1:], p[:, -1:]], axis=1)
        out = np.empty((dh, 2 * dw), np.int64)
        out[:, 0::2] = (3 * p + left + 1) >> 2
        out[:, 1::2] = (3 * p + right + 2) >> 2
        return out
    if (hf, vf) == (1, 2):
        up = np.concatenate([p[:1], p[:-1]], axis=0)
        down = np.concatenate([p[1:], p[-1:]], axis=0)
        out = np.empty((2 * dh, dw), np.int64)
        out[0::2] = (3 * p + up + 1) >> 2
        out[1::2] = (3 * p + down + 2) >> 2
        return out
    if fancy and (hf, vf) == (2, 2):
        up = np.concatenate([p[:1], p[:-1]], axis=0)
        down = np.concatenate([p[1:], p[-1:]], axis=0)
        out = np.empty((2 * dh, 2 * dw), np.int64)
        for r, other in ((0, up), (1, down)):
            cs = 3 * p + other                         # column sums
            left = np.concatenate([cs[:, :1], cs[:, :-1]], axis=1)
            right = np.concatenate([cs[:, 1:], cs[:, -1:]], axis=1)
            out[r::2, 0::2] = (3 * cs + left + 8) >> 4
            out[r::2, 1::2] = (3 * cs + right + 7) >> 4
        return out
    return np.repeat(np.repeat(p, vf, axis=0), hf, axis=1)


_SCALE, _HALF = 16, 1 << 15


def _fix(x: float) -> int:
    return int(x * (1 << _SCALE) + 0.5)


_CX = np.arange(256) - 128
_CR_R = (_fix(1.40200) * _CX + _HALF) >> _SCALE
_CB_B = (_fix(1.77200) * _CX + _HALF) >> _SCALE
_CR_G = -_fix(0.71414) * _CX
_CB_G = -_fix(0.34414) * _CX + _HALF


def ycc_to_rgb(y, cb, cr) -> np.ndarray:
    """jdcolor.c's ycc_rgb_convert on int planes -> uint8 [H, W, 3]."""
    r = y + _CR_R[cr]
    g = y + ((_CB_G[cb] + _CR_G[cr]) >> _SCALE)
    b = y + _CB_B[cb]
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


# ---- the file ------------------------------------------------------------------

def decode_jpeg(buf: bytes, path: str = "<bytes>") -> np.ndarray:
    """Decode JPEG bytes: uint8 [H, W] (gray) or [H, W, 3] (RGB)."""
    if not is_jpeg(buf):
        raise JPEGError(f"{path}: not a JPEG file")
    qts: dict[int, np.ndarray] = {}
    dc_tables: dict[int, tuple] = {}
    ac_tables: dict[int, tuple] = {}
    frame = None
    restart = 0
    pos = 2
    ended = False
    while pos < len(buf):
        if buf[pos] != 0xFF:
            raise JPEGError(f"{path}: corrupt JPEG marker at byte {pos}")
        marker = buf[pos + 1] if pos + 1 < len(buf) else None
        if marker is None:
            break
        if marker == 0xFF:
            pos += 1
            continue
        if marker == 0xD9:
            ended = True
            break
        if marker == 0x01 or 0xD0 <= marker <= 0xD8:
            pos += 2
            continue
        if pos + 4 > len(buf):
            break
        (length,) = struct.unpack(">H", buf[pos + 2:pos + 4])
        seg = buf[pos + 4:pos + 2 + length]
        if len(seg) != length - 2:
            raise JPEGError(f"{path}: truncated JPEG (a segment ends past "
                            "the file)")
        pos += 2 + length
        if marker in _UNSUPPORTED_SOF:
            raise JPEGError(f"{path}: {_UNSUPPORTED_SOF[marker]} JPEGs are "
                            "not supported by the plain decoder (baseline "
                            "and extended Huffman only)")
        if marker == 0xEE and seg[:5] == b"Adobe":
            raise JPEGError(f"{path}: JPEGs with an Adobe colour transform "
                            "segment are not supported")
        if marker == 0xDB:                          # DQT
            i = 0
            while i < len(seg):
                pq, tq = seg[i] >> 4, seg[i] & 15
                if pq:
                    raise JPEGError(f"{path}: 16-bit quantization tables "
                                    "(12-bit JPEGs) are not supported")
                qts[tq] = np.zeros(64, np.int64)
                qts[tq][_NATURAL] = np.frombuffer(seg[i + 1:i + 65], np.uint8)
                i += 65
        elif marker == 0xC4:                        # DHT
            i = 0
            while i < len(seg):
                tc, th = seg[i] >> 4, seg[i] & 15
                bits = list(seg[i + 1:i + 17])
                n = sum(bits)
                table = _lookup(bits, seg[i + 17:i + 17 + n], path)
                (ac_tables if tc else dc_tables)[th] = table
                i += 17 + n
        elif marker == 0xDD:                        # DRI
            (restart,) = struct.unpack(">H", seg[:2])
        elif marker in (0xC0, 0xC1):                # SOF0, SOF1
            precision, h, w, nc = struct.unpack(">BHHB", seg[:6])
            if precision != 8:
                raise JPEGError(f"{path}: {precision}-bit JPEGs are not "
                                "supported (8-bit only)")
            if nc not in (1, 3):
                raise JPEGError(f"{path}: JPEGs of {nc} components are not "
                                "supported (gray or YCbCr only)")
            if h == 0 or w == 0:
                raise JPEGError(f"{path}: JPEG of size {w}x{h}")
            comps = []
            for k in range(nc):
                cid, hv, tq = seg[6 + 3 * k:9 + 3 * k]
                comps.append(dict(id=cid, h=hv >> 4, v=hv & 15, tq=tq))
            hmax = max(c["h"] for c in comps)
            vmax = max(c["v"] for c in comps)
            if any(c["h"] < 1 or c["v"] < 1 or hmax % c["h"]
                   or vmax % c["v"] for c in comps):
                raise JPEGError(f"{path}: fractional sampling factors are "
                                "not supported")
            if nc == 3 and [c["id"] for c in comps] == [82, 71, 66]:
                raise JPEGError(f"{path}: RGB JPEGs (component ids R, G, B) "
                                "are not supported")
            frame = _Frame(h, w, comps)
        elif marker == 0xDA:                        # SOS
            if frame is None:
                raise JPEGError(f"{path}: scan before the frame header")
            ns = seg[0]
            scan_comps = []
            for k in range(ns):
                cid, t = seg[1 + 2 * k:3 + 2 * k]
                comp = next((c for c in frame.comps if c["id"] == cid), None)
                if comp is None:
                    raise JPEGError(f"{path}: scan of unknown component "
                                    f"{cid}")
                comp["td"], comp["ta"] = t >> 4, t & 15
                if comp["td"] not in dc_tables or \
                        comp["ta"] not in ac_tables:
                    raise JPEGError(f"{path}: scan uses a missing Huffman "
                                    "table")
                scan_comps.append(comp)
            # the entropy-coded data runs to the next marker that is not a
            # stuffed byte or a restart marker
            end = pos
            while True:
                end = buf.find(b"\xff", end)
                if end < 0 or end + 1 >= len(buf):
                    end = len(buf)
                    break
                nxt = buf[end + 1]
                if nxt == 0 or 0xD0 <= nxt <= 0xD7 or nxt == 0xFF:
                    end += 1 if nxt == 0xFF else 2
                    continue
                break
            _decode_scan(frame, scan_comps, buf[pos:end], restart,
                         dc_tables, ac_tables, path)
            pos = end
    if frame is None:
        raise JPEGError(f"{path}: no SOF0/SOF1 frame header")
    if not ended or not all(c["seen"] for c in frame.comps):
        raise JPEGError(f"{path}: truncated JPEG (no end-of-image marker "
                        "after the last scan)")
    planes = []
    for c in frame.comps:
        if c["tq"] not in qts:
            raise JPEGError(f"{path}: missing quantization table {c['tq']}")
        blocks = idct_islow(c["coef"], qts[c["tq"]])
        plane = blocks.reshape(c["bh"], c["bw"], 8, 8).transpose(
            0, 2, 1, 3).reshape(c["bh"] * 8, c["bw"] * 8)
        plane = plane[:c["dh"], :c["dw"]]
        up = _upsample(plane, frame.hmax // c["h"], frame.vmax // c["v"])
        planes.append(up[:frame.height, :frame.width])
    if len(planes) == 1:
        return planes[0].astype(np.uint8)
    return ycc_to_rgb(*planes)


def read_jpeg(path: str) -> np.ndarray:
    """Decode the JPEG file `path` (see `decode_jpeg`)."""
    with open(path, "rb") as f:
        return decode_jpeg(f.read(), path)
