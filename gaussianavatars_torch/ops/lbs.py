"""Linear blend skinning for FLAME (port of `gaussianavatars_tpu/ops/lbs.py`;
reference flame_model/lbs.py:25-304).

The 5-joint kinematic chain is unrolled in Python. Matmuls run in full
float32: the vertices feed the frames that place every Gaussian, and the
port keeps TF32 off (see `device.resolve_device`).
"""

from __future__ import annotations

import torch


def batch_rodrigues(rot_vecs: torch.Tensor) -> torch.Tensor:
    """Axis-angle [N, 3] -> rotation matrices [N, 3, 3].

    Keeps the reference's epsilon convention (1e-8 added to the components
    before the norm, flame_model/lbs.py:40).
    """
    angle = torch.linalg.norm(rot_vecs + 1e-8, dim=1, keepdim=True)  # [N,1]
    rot_dir = rot_vecs / angle
    cos = torch.cos(angle)[:, None]
    sin = torch.sin(angle)[:, None]

    rx, ry, rz = rot_dir[:, 0], rot_dir[:, 1], rot_dir[:, 2]
    zeros = torch.zeros_like(rx)
    K = torch.stack(
        [zeros, -rz, ry, rz, zeros, -rx, -ry, rx, zeros], dim=1
    ).reshape(-1, 3, 3)
    ident = torch.eye(3, dtype=rot_vecs.dtype, device=rot_vecs.device)[None]
    return ident + sin * K + (1.0 - cos) * torch.matmul(K, K)


def blend_shapes(betas: torch.Tensor, shape_disps: torch.Tensor) -> torch.Tensor:
    """[B, L] x [V, 3, L] -> per-vertex displacement [B, V, 3], as one flat
    (B, L) @ (L, V*3) matmul."""
    v = shape_disps.shape[0]
    mat = shape_disps.reshape(v * 3, -1)
    return torch.matmul(betas, mat.T).reshape(betas.shape[0], v, 3)


def vertices2joints(j_regressor: torch.Tensor,
                    vertices: torch.Tensor) -> torch.Tensor:
    """[J, V] x [B, V, 3] -> joints [B, J, 3]."""
    return torch.einsum("bik,ji->bjk", vertices, j_regressor)


def batch_rigid_transform(rot_mats, joints, parents):
    """Compose the kinematic chain (lbs.py:254-304), unrolled.

    Args:
      rot_mats: [B, J, 3, 3]; joints: [B, J, 3]; parents: sequence of ints.
    Returns:
      (posed_joints [B, J, 3], rel_transforms [B, J, 4, 4]).
    """
    parents = [int(p) for p in parents]
    b, j = joints.shape[:2]
    rel_joints = [joints[:, 0]]
    for i in range(1, j):
        rel_joints.append(joints[:, i] - joints[:, parents[i]])

    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=joints.dtype,
                          device=joints.device).expand(b, 1, 4)

    def make_tf(R, t):
        return torch.cat([torch.cat([R, t[..., None]], dim=-1), bottom],
                         dim=-2)                                  # [B,4,4]

    local = [make_tf(rot_mats[:, i], rel_joints[i]) for i in range(j)]
    chain = [local[0]]
    for i in range(1, j):
        chain.append(torch.matmul(chain[parents[i]], local[i]))
    transforms = torch.stack(chain, dim=1)                        # [B,J,4,4]
    posed_joints = transforms[:, :, :3, 3]

    # subtract the rest-pose joint contribution to get relative transforms
    joints_h = torch.cat([joints, joints.new_zeros(b, j, 1)], dim=-1)
    shifted = torch.einsum("bjmn,bjn->bjm", transforms, joints_h)  # [B,J,4]
    correction = torch.zeros_like(transforms)
    correction[:, :, :, 3] = shifted
    return posed_joints, transforms - correction


def lbs(pose, v_shaped, posedirs, j_regressor, parents, lbs_weights):
    """Skinning (reference flame_model/lbs.py:101-195).

    Args:
      pose: [B, J*3] axis-angle per joint (global first).
      v_shaped: [B, V, 3] shaped template (incl. blendshapes + offsets).
      posedirs: [(J-1)*9, V*3]; j_regressor: [J, V]; parents: [J];
      lbs_weights: [V, J].
    Returns:
      (verts [B, V, 3], posed_joints [B, J, 3], root-relative A[:, 1]).
    """
    b = pose.shape[0]
    joints = vertices2joints(j_regressor, v_shaped)
    rot_mats = batch_rodrigues(pose.reshape(-1, 3)).reshape(b, -1, 3, 3)

    ident = torch.eye(3, dtype=v_shaped.dtype, device=v_shaped.device)
    pose_feature = (rot_mats[:, 1:] - ident).reshape(b, -1)       # [B,(J-1)*9]
    v_posed = v_shaped + torch.matmul(pose_feature, posedirs).reshape(b, -1, 3)

    posed_joints, rel_tf = batch_rigid_transform(rot_mats, joints, parents)

    # weighted skinning transforms: [V, J] x [B, J, 16] -> [B, V, 4, 4]
    T = torch.einsum("vj,bjmn->bvmn", lbs_weights, rel_tf)
    v_h = torch.cat([v_posed, v_posed.new_ones(b, v_posed.shape[1], 1)],
                    dim=-1)
    verts = torch.einsum("bvmn,bvn->bvm", T, v_h)[..., :3]
    return verts, posed_joints, rel_tf[:, 1]


def vertices2landmarks(vertices, faces, lmk_faces_idx, lmk_bary_coords):
    """Barycentric landmarks (reference flame_model/lbs.py:60-98).

    vertices [B, V, 3]; faces [F, 3]; lmk_faces_idx [L]; bary [L, 3].
    Returns [B, L, 3].
    """
    lmk_faces = faces[lmk_faces_idx]              # [L, 3]
    lmk_verts = vertices[:, lmk_faces]            # [B, L, 3, 3]
    return torch.einsum("blfi,lf->bli", lmk_verts, lmk_bary_coords)
