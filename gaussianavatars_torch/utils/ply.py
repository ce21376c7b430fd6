"""Minimal PLY codec (port of `gaussianavatars_tpu/utils/ply.py`; binary
little-endian + ascii read, binary write).

Self-contained replacement for the `plyfile` dependency the reference uses
(scene/gaussian_model.py:253-332, scene/dataset_readers.py:117-140). The
on-disk layout is bit-compatible with the reference artifacts:

  splat PLY:  x y z nx ny nz f_dc_{0..2} f_rest_{0..3(K-1)-1} opacity
              scale_{0..2} rot_{0..3} [binding_0]     (all float32)
  point PLY:  x y z nx ny nz red green blue           (f4 + u1 colors)
"""

from __future__ import annotations

import os

import numpy as np

_DTYPES = {
    "float": "<f4", "float32": "<f4", "double": "<f8", "float64": "<f8",
    "int": "<i4", "int32": "<i4", "uint": "<u4", "uint32": "<u4",
    "short": "<i2", "int16": "<i2", "ushort": "<u2", "uint16": "<u2",
    "char": "<i1", "int8": "<i1", "uchar": "<u1", "uint8": "<u1",
}
_INV_DTYPES = {
    np.dtype(np.float32): "float", np.dtype(np.float64): "double",
    np.dtype(np.int32): "int", np.dtype(np.uint32): "uint",
    np.dtype(np.uint8): "uchar", np.dtype(np.int8): "char",
    np.dtype(np.int16): "short", np.dtype(np.uint16): "ushort",
}


def read_ply(path: str) -> dict[str, np.ndarray]:
    """Read the `vertex` element into {property_name: 1-D array}."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"not a PLY file: {path}")
        fmt = None
        count = 0
        props: list[tuple[str, str]] = []
        in_vertex = False
        while True:
            line = f.readline()
            if not line:
                raise ValueError("unexpected EOF in PLY header")
            tok = line.strip().split()
            if not tok:
                continue
            if tok[0] == b"format":
                fmt = tok[1].decode()
            elif tok[0] == b"element":
                in_vertex = tok[1] == b"vertex"
                if in_vertex:
                    count = int(tok[2])
            elif tok[0] == b"property" and in_vertex:
                if tok[1] == b"list":
                    raise ValueError("list properties unsupported on vertex")
                props.append((tok[-1].decode(), _DTYPES[tok[1].decode()]))
            elif tok[0] == b"end_header":
                break

        dtype = np.dtype([(n, t) for n, t in props])
        if fmt == "binary_little_endian":
            data = np.frombuffer(f.read(dtype.itemsize * count), dtype=dtype,
                                 count=count)
        elif fmt == "ascii":
            rows = []
            for _ in range(count):
                rows.append(tuple(f.readline().split()))
            data = np.array(rows, dtype=dtype)
        else:
            raise ValueError(f"unsupported PLY format {fmt}")
    return {name: np.ascontiguousarray(data[name]) for name, _ in props}


def write_ply(path: str, columns: list[tuple[str, np.ndarray]]) -> None:
    """Write a binary_little_endian `vertex` element from (name, 1-D array)."""
    n = len(columns[0][1])
    dtype = np.dtype([(name, arr.dtype.str) for name, arr in columns])
    rec = np.empty(n, dtype=dtype)
    for name, arr in columns:
        assert arr.ndim == 1 and len(arr) == n, name
        rec[name] = arr

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        f.write(f"element vertex {n}\n".encode())
        for name, arr in columns:
            f.write(f"property {_INV_DTYPES[arr.dtype]} {name}\n".encode())
        f.write(b"end_header\n")
        f.write(rec.tobytes())


def fetch_point_cloud(path: str):
    """points/colors/normals from a COLMAP-style PLY
    (reference scene/dataset_readers.py:117-123)."""
    d = read_ply(path)
    points = np.stack([d["x"], d["y"], d["z"]], axis=1).astype(np.float32)
    colors = np.stack([d["red"], d["green"], d["blue"]], axis=1) / 255.0
    if "nx" in d:
        normals = np.stack([d["nx"], d["ny"], d["nz"]], axis=1).astype(np.float32)
    else:
        normals = np.zeros_like(points)
    return points, colors.astype(np.float32), normals


def store_point_cloud(path: str, xyz: np.ndarray, rgb: np.ndarray) -> None:
    """COLMAP-style point PLY (reference scene/dataset_readers.py:125-140)."""
    normals = np.zeros_like(xyz, dtype=np.float32)
    cols = [
        ("x", xyz[:, 0].astype(np.float32)),
        ("y", xyz[:, 1].astype(np.float32)),
        ("z", xyz[:, 2].astype(np.float32)),
        ("nx", normals[:, 0]), ("ny", normals[:, 1]), ("nz", normals[:, 2]),
        ("red", rgb[:, 0].astype(np.uint8)),
        ("green", rgb[:, 1].astype(np.uint8)),
        ("blue", rgb[:, 2].astype(np.uint8)),
    ]
    write_ply(path, cols)
