"""FLAME 2023 with the procedural teeth, linear blend skinning and the
per-face frames of GaussianAvatars (Qian et al., CVPR 2024,
flame_model/flame.py, flame_model/lbs.py, scene/flame_gaussian_model.py),
in plain PyTorch.

`FlameHead` takes the raw FLAME arrays (the pickle's keys) and
builds the head the way the published code does: 300 shape and 100
expression directions, the teeth rows extruded from the outer lip rings
(5023 + 120 vertices, 9976 + 168 faces).
"""

from __future__ import annotations

import numpy as np
import torch

# the ordered outer lip rings of the FLAME 2023 topology, 15 vertices each
# (reference flame_model/flame.py): the anchors of the teeth rows
LIP_OUTSIDE_RING_UPPER = np.array(
    [1713, 1715, 1716, 1735, 1696, 1694, 1657, 3543, 2774, 2811, 2813, 2850,
     2833, 2832, 2830], np.int64)
LIP_OUTSIDE_RING_LOWER = np.array(
    [1576, 1577, 1773, 1774, 1795, 1802, 1865, 3503, 2948, 2905, 2898, 2881,
     2880, 2713, 2712], np.int64)

FINETUNE_KEYS = ("rotation", "neck_pose", "jaw_pose", "eyes_pose",
                 "translation", "expr")


def _teeth_strip_faces():
    """The six mirror-symmetric strips joining the 120 teeth vertices
    (local numbering: upper root 0-14, lower root 15-29, upper edge 30-44,
    lower edge 45-59, then the four back rows 60-119)."""
    up_front, up_back, up_rim = [], [], []
    low_front, low_back, low_rim = [], [], []
    for i in range(7):
        up_front += [[i, 31 + i, 30 + i], [i, i + 1, 31 + i]]
        up_back += [[60 + i, 75 + i, 76 + i], [60 + i, 76 + i, 61 + i]]
        up_rim += [[75 + i, 30 + i, 76 + i], [76 + i, 30 + i, 31 + i]]
        low_front += [[45 + i, 46 + i, 15 + i], [46 + i, 16 + i, 15 + i]]
        low_back += [[90 + i, 106 + i, 105 + i], [90 + i, 91 + i, 106 + i]]
        low_rim += [[105 + i, 106 + i, 45 + i], [106 + i, 46 + i, 45 + i]]
    for i in range(7, 14):
        up_front += [[i, i + 1, 30 + i], [i + 1, 31 + i, 30 + i]]
        up_back += [[60 + i, 75 + i, 61 + i], [61 + i, 75 + i, 76 + i]]
        up_rim += [[75 + i, 30 + i, 31 + i], [75 + i, 31 + i, 76 + i]]
        low_front += [[45 + i, 16 + i, 15 + i], [45 + i, 46 + i, 16 + i]]
        low_back += [[90 + i, 91 + i, 105 + i], [91 + i, 106 + i, 105 + i]]
        low_rim += [[105 + i, 46 + i, 45 + i], [105 + i, 106 + i, 46 + i]]
    return (np.asarray(up_front + up_back + up_rim, np.int64),
            np.asarray(low_front + low_back + low_rim, np.int64))


def add_teeth(v_template, shapedirs, posedirs, j_regressor, weights, faces,
              n_shape, n_joints):
    """The teeth augmentation: 120 vertices in eight rows behind the lips,
    shape directions from the mean of the lip rings (shape only), zero
    pose correctives and joint regressor rows, the upper rows skinned to
    the neck joint and the lower to the jaw, and 168 strip faces."""
    v_up = v_template[LIP_OUTSIDE_RING_UPPER]
    v_low = v_template[LIP_OUTSIDE_RING_LOWER]
    mean_dist = np.linalg.norm(v_up - v_low, axis=-1, keepdims=True).mean()
    v_mid = (v_up + v_low) / 2.0
    v_mid[:, 1] = v_mid[:, 1].mean()
    v_mid[:, 2] -= mean_dist * 1.5
    dy = np.array([[0.0, mean_dist, 0.0]], np.float32)
    dz = np.array([[0.0, 0.0, mean_dist]], np.float32)
    up_edge = v_mid + dy * 0.1
    up_root = up_edge + dy * 2.0
    low_edge = v_mid - dy * 0.1 - dz * 0.4
    low_root = low_edge - dy * 2.0
    back = [a.copy() for a in (up_root, up_edge, low_root, low_edge)]
    for a in back:
        a[:, 2] -= mean_dist
    n0 = v_template.shape[0]
    teeth = np.concatenate([up_root, low_root, up_edge, low_edge, *back],
                           axis=0).astype(np.float32)
    nt = teeth.shape[0]
    v_template = np.concatenate([v_template, teeth], axis=0)
    upper = np.concatenate([np.arange(0, 15), np.arange(30, 45),
                            np.arange(60, 90)]) + n0
    lower = np.concatenate([np.arange(15, 30), np.arange(45, 60),
                            np.arange(90, 120)]) + n0

    shapedirs = np.concatenate([shapedirs, np.zeros_like(shapedirs[:nt])])
    # each of the eight rows follows the mean of the two lip rings
    shapedirs[n0:, :, :n_shape] = np.tile(
        (shapedirs[LIP_OUTSIDE_RING_UPPER, :, :n_shape]
         + shapedirs[LIP_OUTSIDE_RING_LOWER, :, :n_shape]) / 2.0, (8, 1, 1))
    pd = posedirs.reshape(n_joints - 1, 9, n0, 3)
    pd = np.concatenate([pd, np.zeros_like(pd[:, :, :nt])], axis=2)
    posedirs = pd.reshape((n_joints - 1) * 9, (n0 + nt) * 3)
    j_regressor = np.concatenate(
        [j_regressor, np.zeros_like(j_regressor[:, :nt])], axis=1)
    weights = np.concatenate([weights, np.zeros_like(weights[:nt])])
    weights[upper, 1] += 1.0
    weights[lower, 2] += 1.0
    f_upper, f_lower = _teeth_strip_faces()
    faces = np.concatenate([faces, f_upper + n0, f_lower + n0])
    return v_template, shapedirs, posedirs, j_regressor, weights, faces


def batch_rodrigues(rot_vecs):
    """Axis-angle [N, 3] -> rotation matrices [N, 3, 3] (1e-8 added to the
    components before the norm, as the published code does)."""
    angle = torch.linalg.norm(rot_vecs + 1e-8, dim=1, keepdim=True)
    rdir = rot_vecs / angle
    cos, sin = torch.cos(angle)[:, None], torch.sin(angle)[:, None]
    rx, ry, rz = rdir.unbind(1)
    zeros = torch.zeros_like(rx)
    k = torch.stack([zeros, -rz, ry, rz, zeros, -rx, -ry, rx, zeros],
                    dim=1).reshape(-1, 3, 3)
    ident = torch.eye(3, dtype=rot_vecs.dtype, device=rot_vecs.device)
    return ident + sin * k + (1.0 - cos) * torch.matmul(k, k)


class FlameHead:
    """The FLAME head's bases on one device, teeth included."""

    def __init__(self, arrays: dict, device, n_shape=300, n_expr=100):
        v_template = np.asarray(arrays["v_template"], np.float32)
        sd = np.asarray(arrays["shapedirs"], np.float32)
        shapedirs = np.concatenate(
            [sd[:, :, :n_shape], sd[:, :, 300:300 + n_expr]], axis=2)
        n_pose = arrays["posedirs"].shape[-1]
        posedirs = np.asarray(arrays["posedirs"], np.float32).reshape(
            -1, n_pose).T
        j_reg = np.asarray(arrays["J_regressor"], np.float32)
        parents = np.asarray(arrays["kintree_table"][0]).astype(np.int64)
        parents[0] = -1
        self.parents = [int(p) for p in parents]
        weights = np.asarray(arrays["weights"], np.float32)
        faces = np.asarray(arrays["f"], np.int64)
        v_template, shapedirs, posedirs, j_reg, weights, faces = add_teeth(
            v_template, shapedirs, posedirs, j_reg, weights, faces, n_shape,
            len(self.parents))

        def t(a, dtype=torch.float32):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                   device=device)

        self.v_template, self.shapedirs = t(v_template), t(shapedirs)
        self.posedirs, self.j_regressor = t(posedirs), t(j_reg)
        self.weights, self.faces = t(weights), t(faces, torch.int64)

    @property
    def num_faces(self) -> int:
        return self.faces.shape[0]

    def verts(self, p: dict, t: int):
        """Posed vertices [V, 3] of the FLAME parameters `p` at timestep
        `t` (shape, static offset and the timestep's dynamic offset
        included; the published skinning of lbs.py)."""
        betas = torch.cat([p["shape"], p["expr"][t]])[None]
        pose = torch.cat([p["rotation"][t], p["neck_pose"][t],
                          p["jaw_pose"][t], p["eyes_pose"][t]])
        v = self.v_template.shape[0]
        v_shaped = self.v_template + torch.matmul(
            betas, self.shapedirs.reshape(v * 3, -1).T).reshape(v, 3)
        v_shaped = v_shaped + p["static_offset"] + p["dynamic_offset"][t]

        joints = torch.matmul(self.j_regressor, v_shaped)          # [J, 3]
        rot = batch_rodrigues(pose.reshape(-1, 3))                 # [J,3,3]
        ident = torch.eye(3, dtype=v_shaped.dtype, device=v_shaped.device)
        feat = (rot[1:] - ident).reshape(1, -1)
        v_posed = v_shaped + torch.matmul(feat, self.posedirs).reshape(v, 3)

        nj = len(self.parents)
        rel = [joints[0]] + [joints[i] - joints[self.parents[i]]
                             for i in range(1, nj)]
        bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], device=joints.device)
        local = [torch.cat([torch.cat([rot[i], rel[i][:, None]], 1),
                            bottom[None]], 0) for i in range(nj)]
        chain = [local[0]]
        for i in range(1, nj):
            chain.append(torch.matmul(chain[self.parents[i]], local[i]))
        tf = torch.stack(chain)                                    # [J,4,4]
        shifted = torch.einsum("jmn,jn->jm", tf[:, :3, :3], joints)
        rel_tf = torch.cat([tf[:, :, :3], torch.cat(
            [tf[:, :3, 3:] - shifted[:, :, None], tf[:, 3:, 3:]], 1)], 2)
        skin = torch.matmul(self.weights, rel_tf.reshape(nj, 16)).reshape(
            v, 4, 4)
        verts = torch.einsum("vmn,vn->vm", skin[:, :3, :3], v_posed) \
            + skin[:, :3, 3]
        return verts + p["translation"][t]


def _normalize(x, eps=1e-20):
    return x / torch.sqrt(torch.clamp((x * x).sum(-1, keepdim=True), min=eps))


def rotmat_to_quat(m):
    """Rotation matrices [F, 3, 3] -> unit quaternions wxyz, w >= 0
    (Shepperd's method, the largest diagonal candidate)."""
    m00, m01, m02 = m[:, 0, 0], m[:, 0, 1], m[:, 0, 2]
    m10, m11, m12 = m[:, 1, 0], m[:, 1, 1], m[:, 1, 2]
    m20, m21, m22 = m[:, 2, 0], m[:, 2, 1], m[:, 2, 2]
    rows = [[1 + m00 + m11 + m22, m21 - m12, m02 - m20, m10 - m01],
            [m21 - m12, 1 + m00 - m11 - m22, m01 + m10, m02 + m20],
            [m02 - m20, m01 + m10, 1 - m00 + m11 - m22, m12 + m21],
            [m10 - m01, m02 + m20, m12 + m21, 1 - m00 - m11 + m22]]
    cands = torch.stack([torch.stack(r, -1) for r in rows], 1)     # [F,4,4]
    best = torch.argmax(torch.diagonal(cands, dim1=1, dim2=2), dim=1)
    q = cands[torch.arange(m.shape[0], device=m.device), best]
    q = q / torch.sqrt(torch.clamp((q * q).sum(-1, keepdim=True), min=1e-24))
    return torch.where(q[:, :1] < 0.0, -q, q)


def face_frames(verts, faces):
    """Per-face frames of the posed mesh (scene/flame_gaussian_model.py,
    utils/graphics_utils.py): orientation with columns (a0, a1, a2)
    [F, 3, 3], scale [F, 1], centre [F, 3] and orientation quaternion."""
    v0, v1, v2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    e01, e02 = v1 - v0, v2 - v0
    a0 = _normalize(e01)
    a1 = _normalize(torch.cross(a0, e02, dim=-1))
    a2 = -_normalize(torch.cross(a1, a0, dim=-1))
    s0 = torch.sqrt(torch.clamp((e01 * e01).sum(-1, keepdim=True),
                                min=1e-20))
    s1 = torch.abs((a2 * e02).sum(-1, keepdim=True))
    orient = torch.stack([a0, a1, a2], dim=-1)
    return dict(orient=orient, scale=(s0 + s1) / 2.0,
                center=(v0 + v1 + v2) / 3.0, quat=rotmat_to_quat(orient))
