"""FLAME 2023 parametric head model (port of
`gaussianavatars_tpu/models/flame.py`; reference flame_model/flame.py:77-558).

Asset preprocessing (pickle loading, basis slicing, the procedural teeth)
runs once in numpy at init; `forward` is torch on the module's device.
The head is built as the JAX package builds it with `include_mask=False`:
region masks, the mesh laplacian and landmarks are not part of the serving
path and are not ported yet.

The teeth augmentation reproduces the reference's construction (vertex
groups, shapedirs and LBS-weight assignment, the six mirror-symmetric
triangle strips) so vertex/face counts and face order match: 5023+120
verts, 9976+168 faces.
"""

from __future__ import annotations

import os
import pickle
from typing import Optional

import numpy as np
import torch
from torch import nn

from gaussianavatars_torch.models import flame_constants as C
from gaussianavatars_torch.ops.lbs import blend_shapes, lbs
from gaussianavatars_torch.utils.obj import load_obj


def _default_path(name: str) -> str:
    asset_dir = os.environ.get("FLAME_ASSET_DIR", "flame_model/assets/flame")
    return os.path.join(asset_dir, name)


# ----------------------------------------------------------------------------
# chumpy-free pickle loading
# ----------------------------------------------------------------------------

class _ChumpyStandin:
    """Unpickles chumpy arrays as their underlying numpy data."""

    def __setstate__(self, state):
        self.__dict__.update(state)

    def __array__(self, dtype=None, copy=None):
        # chumpy Ch objects carry their value in 'x'
        arr = np.asarray(self.__dict__.get("x"))
        return arr.astype(dtype) if dtype is not None else arr


class _SafeUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.startswith("chumpy"):
            return _ChumpyStandin
        return super().find_class(module, name)


def load_flame_pickle(path: str) -> dict:
    """Load a FLAME/SMPL-family pickle into plain numpy arrays."""
    with open(path, "rb") as f:
        data = _SafeUnpickler(f, encoding="latin1").load()

    out = {}
    for k, v in data.items():
        if hasattr(v, "todense"):          # scipy sparse
            out[k] = np.asarray(v.todense(), np.float64)
        elif isinstance(v, _ChumpyStandin):
            out[k] = np.asarray(v)
        else:
            try:
                out[k] = np.asarray(v)
            except (TypeError, ValueError):
                out[k] = v
    return out


# ----------------------------------------------------------------------------
# Procedural teeth (reference flame_model/flame.py:186-483)
# ----------------------------------------------------------------------------

def _teeth_strip_faces() -> tuple[np.ndarray, np.ndarray]:
    """Six mirror-symmetric triangle strips connecting the teeth vertex rows.

    Local vertex numbering (within the 120 added vertices):
      0-14 upper_root      15-29 lower_root    30-44 upper_edge
      45-59 lower_edge     60-74 upper_root_back  75-89 upper_edge_back
      90-104 lower_root_back  105-119 lower_edge_back

    Each strip flips its diagonal at the center tooth (i == 7) so the
    triangulation is left/right symmetric.
    """
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
    f_upper = np.asarray(up_front + up_back + up_rim, np.int64)
    f_lower = np.asarray(low_front + low_back + low_rim, np.int64)
    return f_upper, f_lower


# ----------------------------------------------------------------------------
# FlameHead
# ----------------------------------------------------------------------------

class FlameHead(nn.Module):
    """FLAME head with the procedural teeth (reference
    flame_model/flame.py:77-558) on `device`.

    Bases live in buffers: shapedirs [V, 3, S+E], posedirs [(J-1)*9, V*3],
    v_template [V, 3], j_regressor [J, V], lbs_weights [V, J], faces [F, 3].
    """

    def __init__(
        self,
        shape_params: int = 300,
        expr_params: int = 100,
        flame_model_path: Optional[str] = None,
        flame_template_mesh_path: Optional[str] = None,
        device: str | torch.device = "cuda",
    ):
        super().__init__()
        self.n_shape_params = shape_params
        self.n_expr_params = expr_params

        model = load_flame_pickle(
            flame_model_path or _default_path("flame2023.pkl"))
        v_template = np.asarray(model["v_template"], np.float32)
        shapedirs = np.asarray(model["shapedirs"], np.float32)
        # FLAME packs 300 shape + 100 expression dirs along the last axis
        shapedirs = np.concatenate(
            [shapedirs[:, :, :shape_params],
             shapedirs[:, :, 300:300 + expr_params]], axis=2)
        num_pose_basis = model["posedirs"].shape[-1]
        posedirs = np.asarray(model["posedirs"], np.float32).reshape(
            -1, num_pose_basis).T                             # [(J-1)*9, V*3]
        j_regressor = np.asarray(model["J_regressor"], np.float32)
        parents = np.asarray(model["kintree_table"][0]).astype(np.int64)
        parents[0] = -1
        self.parents = [int(p) for p in parents]
        lbs_weights = np.asarray(model["weights"], np.float32)

        _, _, faces, _ = load_obj(
            flame_template_mesh_path or _default_path("head_template_mesh.obj"))
        faces = faces.astype(np.int64)
        if not np.array_equal(faces, np.asarray(model["f"], np.int64)):
            raise ValueError(
                "template OBJ topology must match the FLAME model faces")

        v_template, shapedirs, posedirs, j_regressor, lbs_weights, faces = (
            _add_teeth(v_template, shapedirs, posedirs, j_regressor,
                       lbs_weights, faces, shape_params, len(parents)))

        def buf(name, a, dtype=torch.float32):
            self.register_buffer(
                name, torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                      device=device), persistent=False)

        buf("v_template", v_template)
        buf("shapedirs", shapedirs)
        buf("posedirs", posedirs)
        buf("j_regressor", j_regressor)
        buf("lbs_weights", lbs_weights)
        buf("faces", faces, torch.int64)

    @property
    def num_verts(self) -> int:
        return self.v_template.shape[0]

    @property
    def num_faces(self) -> int:
        return self.faces.shape[0]

    def forward(
        self,
        shape,
        expr,
        rotation,
        neck,
        jaw,
        eyes,
        translation,
        static_offset=None,
        dynamic_offset=None,
    ):
        """FLAME forward (reference flame_model/flame.py:485-558).

        Tensor args carry a leading batch dim B. Returns verts [B, V, 3].
        """
        betas = torch.cat([shape, expr], dim=1)
        full_pose = torch.cat([rotation, neck, jaw, eyes], dim=1)
        v_shaped = self.v_template[None] + blend_shapes(betas, self.shapedirs)
        if static_offset is not None:
            v_shaped = v_shaped + static_offset
        if dynamic_offset is not None:
            # the reference accepts dynamic_offset but never applies it
            # (flame_model/flame.py:498); the JAX package applies it, as
            # the evidently intended semantics, and so does the port
            v_shaped = v_shaped + dynamic_offset

        vertices, _, _ = lbs(full_pose, v_shaped, self.posedirs,
                             self.j_regressor, self.parents, self.lbs_weights)
        return vertices + translation[:, None, :]


def _add_teeth(v_template, shapedirs, posedirs, j_regressor, lbs_weights,
               faces, n_shape, n_joints):
    """Procedural teeth rows bound to neck (upper) / jaw (lower).

    Reproduces reference flame_model/flame.py:186-483: vertex groups,
    shapedirs copied from the lip rings, zero posedirs / joint regressor,
    manual LBS weights, strip faces. Returns the augmented arrays.
    """
    vid_up = C.LIP_OUTSIDE_RING_UPPER
    vid_low = C.LIP_OUTSIDE_RING_LOWER
    v_up = v_template[vid_up]
    v_low = v_template[vid_low]

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

    thickness = mean_dist * 1.0
    up_root_back = up_root.copy()
    up_edge_back = up_edge.copy()
    low_root_back = low_root.copy()
    low_edge_back = low_edge.copy()
    for arr in (up_root_back, up_edge_back, low_root_back, low_edge_back):
        arr[:, 2] -= thickness

    n0 = v_template.shape[0]
    v_teeth = np.concatenate(
        [up_root, low_root, up_edge, low_edge,
         up_root_back, up_edge_back, low_root_back, low_edge_back], axis=0
    ).astype(np.float32)
    nt = v_teeth.shape[0]
    v_template = np.concatenate([v_template, v_teeth], axis=0)

    def grp(a, b):
        return np.arange(a, b) + n0

    vid_u_root, vid_l_root = grp(0, 15), grp(15, 30)
    vid_u_edge, vid_l_edge = grp(30, 45), grp(45, 60)
    vid_u_root_b, vid_u_edge_b = grp(60, 75), grp(75, 90)
    vid_l_root_b, vid_l_edge_b = grp(90, 105), grp(105, 120)
    vid_teeth_upper = np.concatenate(
        [vid_u_root, vid_u_edge, vid_u_root_b, vid_u_edge_b])
    vid_teeth_lower = np.concatenate(
        [vid_l_root, vid_l_edge, vid_l_root_b, vid_l_edge_b])

    # shape basis: teeth follow the mean of the lip rings (shape dims
    # only; expression leaves teeth rigid)
    shapedirs = np.concatenate(
        [shapedirs, np.zeros_like(shapedirs[:nt])], axis=0)
    sd_mean = (shapedirs[vid_up, :, :n_shape]
               + shapedirs[vid_low, :, :n_shape]) / 2.0
    for vids in (vid_u_root, vid_l_root, vid_u_edge, vid_l_edge,
                 vid_u_root_b, vid_u_edge_b, vid_l_root_b, vid_l_edge_b):
        shapedirs[vids, :, :n_shape] = sd_mean

    # pose correctives / joint regressor: zero for teeth
    pd = posedirs.reshape(n_joints - 1, 9, n0, 3)
    pd = np.concatenate([pd, np.zeros_like(pd[:, :, :nt])], axis=2)
    posedirs = pd.reshape((n_joints - 1) * 9, (n0 + nt) * 3)
    j_regressor = np.concatenate(
        [j_regressor, np.zeros_like(j_regressor[:, :nt])], axis=1)

    # skinning: upper teeth ride the neck joint, lower ride the jaw
    w = np.concatenate([lbs_weights, np.zeros_like(lbs_weights[:nt])], axis=0)
    w[vid_teeth_upper, 1] += 1.0
    w[vid_teeth_lower, 2] += 1.0

    f_upper, f_lower = _teeth_strip_faces()
    faces = np.concatenate([faces, f_upper + n0, f_lower + n0], axis=0)
    return v_template, shapedirs, posedirs, j_regressor, w, faces
