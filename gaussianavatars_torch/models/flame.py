"""FLAME 2023 parametric head model (port of
`gaussianavatars_tpu/models/flame.py`; reference flame_model/flame.py:77-924).

Asset preprocessing (pickle loading, basis slicing, the procedural teeth,
the region masks and the mesh laplacian's edge list) runs once in numpy at
init; `forward` and `laplacian_smooth` are torch on the module's device.
`FlameMask` (the region tables) stays in numpy, as in the JAX package.

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
from gaussianavatars_torch.models import flame_mask_tables as T
from gaussianavatars_torch.ops.lbs import (
    blend_shapes,
    lbs,
    vertices2landmarks,
)
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
# FlameMask
# ----------------------------------------------------------------------------

class FlameMask:
    """Region vertex/face masks (reference flame_model/flame.py:580-924).

    Regions come from three sources: the FLAME_masks.pkl download (broad
    regions), the hand-curated tables (`flame_mask_tables`: ordered rings,
    anchor points, halves), and derived unions built at init. Face and UV
    masks are recomputed from the vertex masks whenever the topology
    changes (the teeth augmentation).
    """

    def __init__(self, faces, faces_t=None, num_verts=C.NUM_FLAME_VERTS,
                 flame_parts_path: Optional[str] = None,
                 face_clusters=()):
        self.num_verts = num_verts
        self.face_clusters = tuple(face_clusters)
        self.v: dict[str, np.ndarray] = {}

        if flame_parts_path and os.path.exists(flame_parts_path):
            parts = load_flame_pickle(flame_parts_path)
            for k, mask in parts.items():
                self.v[k] = np.asarray(mask, np.int64)

        # the hand-curated tables (reference flame.py:643-814); the teeth
        # halves are appended by the teeth augmentation
        for name, vals in T.ALL_TABLES.items():
            if name in ("left_half_teeth", "right_half_teeth"):
                continue
            self.v[name] = vals.copy()
        self.v["lip_inside_ring"] = np.concatenate(
            [C.LIP_INSIDE_RING_UPPER, C.LIP_INSIDE_RING_LOWER,
             C.LIP_INSIDE_RING_EXTRA])

        # derived unions and set-algebra regions (reference flame.py:784-814)
        def have(*names):
            return all(nm in self.v for nm in names)

        for name, srcs in [
            ("ears", ["right_ear", "left_ear"]),
            ("eyeballs", ["right_eyeball", "left_eyeball"]),
            ("irises", ["right_iris", "left_iris"]),
            ("left_eye", ["left_eye_region", "left_eyeball"]),
            ("right_eye", ["right_eye_region", "right_eyeball"]),
            ("eyelids", ["left_eyelid", "right_eyelid"]),
        ]:
            if have(*srcs):
                self.v[name] = np.concatenate([self.v[s] for s in srcs])
        if have("scalp", "face", "neck"):
            # hair = scalp minus (face | neck)
            self.v["hair"] = np.setdiff1d(
                self.v["scalp"], np.union1d(self.v["face"], self.v["neck"]))
        if have("eyeballs", "irises"):
            self.v["sclerae"] = np.setdiff1d(self.v["eyeballs"],
                                             self.v["irises"])
        skin_except = [r for r in ("eyeballs", "hair", "lips_tight",
                                   "boundary") if r in self.v]
        if skin_except:
            self.v["skin"] = np.setdiff1d(
                np.arange(self.num_verts),
                np.unique(np.concatenate([self.v[r] for r in skin_except])))

        self.update(faces, faces_t)

    def update(self, faces, faces_t=None):
        """Recompute the face masks `f`, the UV masks `vt` and `fid2cid`
        from the vertex masks for this topology."""
        self.faces = np.asarray(faces)
        self.faces_t = None if faces_t is None else np.asarray(faces_t)
        self.num_faces = len(self.faces)

        self.f: dict[str, np.ndarray] = {}
        self.vt: dict[str, np.ndarray] = {}
        for name, vids in self.v.items():
            hits = np.isin(self.faces, np.unique(vids)).any(axis=1)
            self.f[name] = np.nonzero(hits)[0].astype(np.int64)
            if self.faces_t is not None:
                self.vt[name] = np.unique(self.faces_t[hits])

        # face id -> cluster id (reference flame.py:840-856): 0 background,
        # 1 unclustered foreground, 2+ face_clusters[i]
        fid2cid = np.ones(self.num_faces + 1, np.int64)
        for cid, cluster in enumerate(self.face_clusters):
            if cluster in self.f:
                fid2cid[self.f[cluster]] = cid + 2
        self.fid2cid = fid2cid

    # -- queries (reference flame.py:870-924) ------------------------------

    def register(self, name: str, vids: np.ndarray):
        self.v[name] = np.asarray(vids, np.int64)

    def get_vid_by_region(self, regions, keep_order=False):
        if len(regions) == 0:
            return np.array([], np.int64)
        vid = np.concatenate([self.v[k] for k in regions])
        return vid if keep_order else np.unique(vid)

    def get_vid_except_region(self, regions):
        exclude = self.get_vid_by_region(regions)
        return np.setdiff1d(np.arange(self.num_verts), exclude)

    def get_fid_by_region(self, regions):
        if len(regions) == 0:
            return np.array([], np.int64)
        return np.unique(np.concatenate([self.f[k] for k in regions]))

    def get_fid_except_region(self, regions):
        exclude = self.get_fid_by_region(regions)
        return np.setdiff1d(np.arange(self.num_faces), exclude)


# ----------------------------------------------------------------------------
# FlameHead
# ----------------------------------------------------------------------------

class FlameHead(nn.Module):
    """FLAME head with the procedural teeth (reference
    flame_model/flame.py:77-558) on `device`.

    Bases live in buffers: shapedirs [V, 3, S+E], posedirs [(J-1)*9, V*3],
    v_template [V, 3], j_regressor [J, V], lbs_weights [V, J], faces [F, 3],
    the laplacian's undirected edges [E, 2] and vertex degrees [V], and,
    when the landmark embedding exists, its faces [L] and barycentric
    coordinates [L, 3]. `mask` is the `FlameMask` of the final topology
    (None without `include_mask`).
    """

    def __init__(
        self,
        shape_params: int = 300,
        expr_params: int = 100,
        flame_model_path: Optional[str] = None,
        flame_template_mesh_path: Optional[str] = None,
        device: str | torch.device = "cuda",
        flame_lmk_embedding_path: Optional[str] = None,
        flame_parts_path: Optional[str] = None,
        include_mask: bool = True,
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

        lmk_path = (flame_lmk_embedding_path
                    or _default_path("landmark_embedding_with_eyes.npy"))
        lmk_faces = lmk_bary = None
        if os.path.exists(lmk_path):
            lmk = np.load(lmk_path, allow_pickle=True, encoding="latin1")[()]
            lmk_faces = np.asarray(lmk["full_lmk_faces_idx"],
                                   np.int64).reshape(-1)
            lmk_bary = np.asarray(lmk["full_lmk_bary_coords"],
                                  np.float32).reshape(-1, 3)

        _, verts_uvs, faces, faces_uvs = load_obj(
            flame_template_mesh_path or _default_path("head_template_mesh.obj"))
        faces = faces.astype(np.int64)
        if not np.array_equal(faces, np.asarray(model["f"], np.int64)):
            raise ValueError(
                "template OBJ topology must match the FLAME model faces")
        n0, f0 = v_template.shape[0], faces.shape[0]
        self.mask = None
        if include_mask:
            self.mask = FlameMask(
                faces, faces_uvs, num_verts=n0,
                flame_parts_path=flame_parts_path
                or _default_path("FLAME_masks.pkl"))

        (v_template, shapedirs, posedirs, j_regressor, lbs_weights, faces,
         (vid_teeth_upper, vid_teeth_lower)) = _add_teeth(
            v_template, shapedirs, posedirs, j_regressor, lbs_weights, faces,
            shape_params, len(parents))

        if self.mask is not None:
            textures_idx = None
            if faces_uvs is not None:
                # the teeth's UV faces index a grid appended to the atlas
                textures_idx = np.concatenate(
                    [faces_uvs, faces[f0:] - n0 + verts_uvs.shape[0]])
            self.mask.num_verts = v_template.shape[0]
            self.mask.register("teeth_upper", vid_teeth_upper)
            self.mask.register("teeth_lower", vid_teeth_lower)
            self.mask.register("teeth", np.concatenate(
                [vid_teeth_upper, vid_teeth_lower]))
            # the teeth vertices extend the half-face splits (reference
            # flame.py:255-269)
            for half, ext in (("left_half", T.LEFT_HALF_TEETH),
                              ("right_half", T.RIGHT_HALF_TEETH)):
                if half in self.mask.v:
                    self.mask.v[half] = np.concatenate(
                        [self.mask.v[half], ext])
            self.mask.update(faces, textures_idx)

        # uniform graph laplacian of the final mesh (the dynamic-offset
        # regularizer, reference flame_gaussian_model.py:161-172)
        edges = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]],
                                faces[:, [2, 0]]])
        edges = np.unique(np.sort(edges, axis=1), axis=0)
        degree = np.zeros(v_template.shape[0], np.float32)
        np.add.at(degree, edges[:, 0], 1.0)
        np.add.at(degree, edges[:, 1], 1.0)

        def buf(name, a, dtype=torch.float32):
            self.register_buffer(
                name, None if a is None else torch.as_tensor(
                    np.ascontiguousarray(a), dtype=dtype, device=device),
                persistent=False)

        buf("v_template", v_template)
        buf("shapedirs", shapedirs)
        buf("posedirs", posedirs)
        buf("j_regressor", j_regressor)
        buf("lbs_weights", lbs_weights)
        buf("faces", faces, torch.int64)
        buf("laplacian_edges", edges, torch.int64)
        buf("laplacian_degree", degree)
        buf("full_lmk_faces_idx", lmk_faces, torch.int64)
        buf("full_lmk_bary_coords", lmk_bary)

    @property
    def num_verts(self) -> int:
        return self.v_template.shape[0]

    @property
    def num_faces(self) -> int:
        return self.faces.shape[0]

    def laplacian_smooth(self, verts: torch.Tensor) -> torch.Tensor:
        """L @ verts with the uniform L = D - A; verts [B, V, 3]."""
        e = self.laplacian_edges
        neigh = torch.zeros_like(verts)
        neigh = neigh.index_add(1, e[:, 0], verts[:, e[:, 1]])
        neigh = neigh.index_add(1, e[:, 1], verts[:, e[:, 0]])
        return self.laplacian_degree[None, :, None] * verts - neigh

    def forward(
        self,
        shape,
        expr,
        rotation,
        neck,
        jaw,
        eyes,
        translation,
        zero_centered_at_root_node: bool = False,
        return_landmarks: bool = True,
        return_verts_cano: bool = False,
        static_offset=None,
        dynamic_offset=None,
    ):
        """FLAME forward (reference flame_model/flame.py:485-558).

        Tensor args carry a leading batch dim B. Returns verts [B, V, 3],
        followed, in this order and only when asked for, by the canonical
        verts (the shaped template with the offsets, before skinning) and
        the landmarks [B, L, 3] (when the head has an embedding); a single
        tensor when nothing follows it.
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

        vertices, joints, _ = lbs(full_pose, v_shaped, self.posedirs,
                                  self.j_regressor, self.parents,
                                  self.lbs_weights)
        if zero_centered_at_root_node:
            vertices = vertices - joints[:, [0]]
        vertices = vertices + translation[:, None, :]

        ret = [vertices]
        if return_verts_cano:
            ret.append(v_shaped)
        if return_landmarks and self.full_lmk_faces_idx is not None:
            ret.append(vertices2landmarks(vertices, self.faces,
                                          self.full_lmk_faces_idx,
                                          self.full_lmk_bary_coords))
        return ret if len(ret) > 1 else ret[0]


def _add_teeth(v_template, shapedirs, posedirs, j_regressor, lbs_weights,
               faces, n_shape, n_joints):
    """Procedural teeth rows bound to neck (upper) / jaw (lower).

    Reproduces reference flame_model/flame.py:186-483: vertex groups,
    shapedirs copied from the lip rings, zero posedirs / joint regressor,
    manual LBS weights, strip faces. Returns the augmented arrays and the
    (upper, lower) teeth vertex ids.
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
    return (v_template, shapedirs, posedirs, j_regressor, w, faces,
            (vid_teeth_upper, vid_teeth_lower))
