"""Wavefront OBJ loader (vertices, UVs, face indices).

Lightweight replacement for the reference's vendored pytorch3d loader
(utils/pytorch3d_load_obj.py:148, used by flame_model/flame.py:154 to read
the FLAME template mesh). Supports v / vt / f records with v, v/vt, v/vt/vn
and v//vn index styles; triangulates polygon faces with a fan.
"""

from __future__ import annotations

import numpy as np


def load_obj(path: str):
    """Returns (verts [V,3] f32, verts_uvs [T,2] f32 | None,
    faces_verts [F,3] i32, faces_uvs [F,3] i32 | None)."""
    verts: list[list[float]] = []
    uvs: list[list[float]] = []
    f_v: list[list[int]] = []
    f_vt: list[list[int]] = []

    with open(path, "r") as fh:
        for line in fh:
            if line.startswith("v "):
                parts = line.split()
                verts.append([float(x) for x in parts[1:4]])
            elif line.startswith("vt "):
                parts = line.split()
                uvs.append([float(x) for x in parts[1:3]])
            elif line.startswith("f "):
                corners = line.split()[1:]
                vi, ti = [], []
                for c in corners:
                    fields = c.split("/")
                    vi.append(int(fields[0]) - 1)
                    if len(fields) > 1 and fields[1]:
                        ti.append(int(fields[1]) - 1)
                # fan triangulation
                for k in range(1, len(vi) - 1):
                    f_v.append([vi[0], vi[k], vi[k + 1]])
                    if ti:
                        f_vt.append([ti[0], ti[k], ti[k + 1]])

    verts_np = np.asarray(verts, np.float32)
    uvs_np = np.asarray(uvs, np.float32) if uvs else None
    faces_np = np.asarray(f_v, np.int32)
    faces_uv_np = np.asarray(f_vt, np.int32) if f_vt else None
    return verts_np, uvs_np, faces_np, faces_uv_np
