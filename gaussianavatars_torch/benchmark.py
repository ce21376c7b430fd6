"""Benchmark protocol and scene builders (port of
`gaussianavatars_tpu/benchmark.py`).

The protocol mirrors the reference FPS benchmark (fps_benchmark_demo.py,
doc/offline_render.md): renders at 802x550, SH degree 3, white background.
The reference's demo avatar is a download, so the workloads are synthetic
and deterministic from a seed:

  * `make_bench_scene`       unbound avatar-like cloud of 100k Gaussians
  * `make_bound_bench_model` FLAME-bound avatar (10 Gaussians per face,
                             101,440 in all) on the synthetic FLAME head
                             with the real topology: every render drives
                             FLAME -> face frames -> binding chain
  * `write_avatar_dataset`   a DynamicNerf dataset on disk (cameras around
                             the head, FLAME parameters per timestep,
                             PNG images) for the training loop

Both use the same numpy random streams as the JAX package's builders, so
the two packages build the same avatar from the same seed. The FLAME
assets are generated with numpy (`make_flame_assets`), and the look-at
camera (`make_camera`) is the JAX test suite's; both are copies, so this
package needs nothing outside itself.
"""

from __future__ import annotations

import json
import math
import os
import pickle
import tempfile
from typing import Callable, Optional

import numpy as np
import torch

from gaussianavatars_torch.data.readers import read_cameras_from_transforms
from gaussianavatars_torch.device import resolve_device
from gaussianavatars_torch.models.flame import FlameHead
from gaussianavatars_torch.models.flame_gaussians import FlameGaussianModel
from gaussianavatars_torch.models.gaussians import (
    GaussianModel,
    GaussianParams,
    inverse_sigmoid,
    world_space_gaussians,
)
from gaussianavatars_torch.ops.binning_dense import bin_gaussians_dense
from gaussianavatars_torch.ops.instance_pack import (
    gather_instances,
    pack_projected,
)
from gaussianavatars_torch.ops.projection import (
    CameraParams,
    project_gaussians,
)
from gaussianavatars_torch.ops.transforms import (
    camera_center_from_world_view,
    full_projection,
    perspective_projection,
    world_to_view,
)
from gaussianavatars_torch.utils.png import write_png

WIDTH, HEIGHT = 802, 550
N_GAUSSIANS = 100_000
N_ITERS = 500
N_ROUNDS = 3
SH_DEGREE = 3

# synthetic FLAME dimensions (the real topology, random geometry/bases)
FLAME_V = 5023
FLAME_F = 9976
FLAME_J = 5
FLAME_SHAPE_DIMS = 400  # 300 shape + 100 expr


def make_flame_assets(dirpath, seed=0, v=FLAME_V, f=FLAME_F):
    """Write a FLAME-like pickle, template OBJ and landmark embedding to
    `dirpath` (the JAX package's tests/flame_fixtures.py generator, array
    for array).

    A head-like surface with LOCAL triangles: vertices along a spiral on a
    ~0.1-radius sphere, faces connecting spiral neighbours across turns, so
    triangles have the few-mm size of a real FLAME mesh.
    """
    rng = np.random.default_rng(seed)
    os.makedirs(dirpath, exist_ok=True)

    w = 62                      # spiral windings; ~81 points per turn
    t = (np.arange(v) + 0.5) / v
    z = 1.0 - 2.0 * t
    r_xy = np.sqrt(np.maximum(1.0 - z * z, 1e-6))
    phi = 2.0 * np.pi * w * t
    sphere = np.stack([r_xy * np.cos(phi), r_xy * np.sin(phi), z], axis=1)
    v_template = (0.1 * sphere + rng.normal(0, 0.002, (v, 3))
                  ).astype(np.float64)
    k = v // w                  # index stride of one spiral turn
    i = np.arange(v - k - 1)
    grid = np.concatenate([
        np.stack([i, i + 1, i + k], axis=1),
        np.stack([i + 1, i + k + 1, i + k], axis=1),
    ])
    extra = f - len(grid)
    assert extra >= 0
    j = np.arange(extra)
    faces = np.concatenate(
        [grid, np.stack([j, j + 2, j + k + 1], axis=1)])[:f]

    # FLAME chain: root(global) -> neck -> jaw, eyes under neck
    kintree = np.zeros((2, FLAME_J), np.int64)
    kintree[0] = [-1, 0, 1, 1, 1]
    kintree[1] = np.arange(FLAME_J)

    weights = rng.random((v, FLAME_J))
    weights /= weights.sum(1, keepdims=True)

    model = dict(
        v_template=v_template,
        # blendshape magnitudes scaled to the local triangle size (~6e-3)
        shapedirs=rng.normal(0, 5e-4, (v, 3, FLAME_SHAPE_DIMS)),
        posedirs=rng.normal(0, 5e-5, (v, 3, (FLAME_J - 1) * 9)),
        J_regressor=np.abs(rng.normal(0, 1, (FLAME_J, v))) / v,
        kintree_table=kintree,
        weights=weights,
        f=faces,
    )
    pkl_path = os.path.join(dirpath, "flame2023.pkl")
    with open(pkl_path, "wb") as fh:
        pickle.dump(model, fh)

    # template OBJ with matching topology + a trivial UV per vertex
    obj_path = os.path.join(dirpath, "head_template_mesh.obj")
    with open(obj_path, "w") as fh:
        for p in v_template:
            fh.write(f"v {p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")
        for i in range(v):
            fh.write(f"vt {((i % 97) / 97):.6f} {((i % 89) / 89):.6f}\n")
        for tri in faces:
            fh.write(
                f"f {tri[0]+1}/{tri[0]+1} {tri[1]+1}/{tri[1]+1} "
                f"{tri[2]+1}/{tri[2]+1}\n")

    # landmark embedding: drawn last, so every array above is what the
    # generator gave before it had landmarks
    lmk = dict(
        full_lmk_faces_idx=rng.integers(0, f, (1, 70)),
        full_lmk_bary_coords=rng.dirichlet(np.ones(3), (1, 70)),
    )
    lmk_path = os.path.join(dirpath, "landmark_embedding_with_eyes.npy")
    np.save(lmk_path, np.array(lmk, dtype=object), allow_pickle=True)
    return dict(model=pkl_path, obj=obj_path, lmk=lmk_path)


def make_camera(width=48, height=40, fovx=0.8, dist=4.0,
                device="cuda") -> CameraParams:
    """Camera at distance `dist` on the -z axis, looking at the origin
    (near 0.01, far 100)."""
    dev = resolve_device(device)
    fovy = 2 * math.atan(math.tan(fovx / 2) * height / width)
    pos = np.array([0.0, 0.0, -dist])
    fwd = -pos / np.linalg.norm(pos)
    up = np.array([0.0, -1.0, 0.0])
    right = np.cross(up, fwd)
    right /= np.linalg.norm(right)
    up2 = np.cross(fwd, right)
    R = np.stack([right, up2, fwd], axis=1)  # cam-to-world
    T = -R.T @ pos                            # world-to-cam translation

    wv = world_to_view(R, T)
    proj = perspective_projection(0.01, 100.0, fovx, fovy)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    return CameraParams(
        viewmatrix=t(wv), projmatrix=t(full_projection(wv, proj)),
        campos=t(camera_center_from_world_view(wv)),
        tan_fovx=math.tan(fovx / 2), tan_fovy=math.tan(fovy / 2),
        width=width, height=height)


def bench_camera(width=WIDTH, height=HEIGHT, device="cuda") -> CameraParams:
    return make_camera(width=width, height=height, fovx=0.5, dist=1.0,
                       device=device)


def make_bench_scene(n=N_GAUSSIANS, seed=0, device="cuda") -> dict:
    """Avatar-like cloud: dense head-sized cluster filling ~half the frame.
    `shs` is [N, K, 3] coefficient-major."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    k = (SH_DEGREE + 1) ** 2
    pts = rng.normal(0.0, 0.13, (n, 3)).astype(np.float32)
    scales = np.exp(rng.normal(-5.2, 0.4, (n, 3))).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    sh = np.zeros((n, k, 3), np.float32)
    sh[:, 0] = rng.normal(0.3, 0.5, (n, 3))
    sh[:, 1:] = rng.normal(0, 0.05, (n, k - 1, 3))
    opac = rng.uniform(0.2, 0.98, n).astype(np.float32)
    arrays = dict(means3d=pts, scales=scales, quats=quats, opacities=opac,
                  shs=sh)
    return {key: torch.as_tensor(a, device=dev) for key, a in arrays.items()}


def scene_to_model(scene: dict, sh_degree: int = SH_DEGREE) -> GaussianModel:
    """Wrap a raw scene dict (shs [N, K, 3]) into an unbound GaussianModel."""
    shs = scene["shs"]
    opac = scene["opacities"]
    model = GaussianModel(sh_degree, GaussianParams(
        xyz=scene["means3d"],
        features_dc=shs[:, 0].contiguous(),
        features_rest=shs[:, 1:].transpose(1, 2).reshape(shs.shape[0], -1),
        scaling=torch.log(scene["scales"]),
        rotation=scene["quats"],
        opacity=torch.log(opac / (1 - opac))[:, None],
    ))
    model.spatial_lr_scale = 1.0
    model.reset_stats()
    return model


def bench_meshes(rng: np.random.Generator, num_timesteps: int) -> dict:
    """The bound bench avatar's per-timestep FLAME parameters, drawn from
    `rng`: shared shape, random expressions and jaw poses."""
    return {
        i: dict(
            shape=rng.normal(0, 0.05, 300).astype(np.float32),
            expr=rng.normal(0, 0.1, 100).astype(np.float32),
            rotation=np.zeros(3, np.float32),
            neck_pose=np.zeros(3, np.float32),
            jaw_pose=np.abs(rng.normal(0, 0.05, 3)).astype(np.float32),
            eyes_pose=np.zeros(6, np.float32),
            translation=np.zeros(3, np.float32),
            static_offset=np.zeros((FLAME_V, 3), np.float32),
        )
        for i in range(num_timesteps)
    }


def make_bound_bench_model(sh_degree=SH_DEGREE, n_per_face=10, seed=0,
                           num_timesteps=4,
                           device="cuda") -> FlameGaussianModel:
    """FLAME-bound synthetic avatar at the canonical scale: the synthetic
    FLAME head (5023+120 verts, 9976+168 faces after the teeth, 300 shape
    and 100 expression dims) with `n_per_face` Gaussians bound to every
    face (101,440 at 10) and `num_timesteps` random expressions/jaw poses.
    World-space scale, opacity and SH statistics match `make_bench_scene`.
    """
    dev = resolve_device(device)
    with tempfile.TemporaryDirectory(prefix="bench_bound_") as tmpdir:
        paths = make_flame_assets(tmpdir, seed=seed)
        head = FlameHead(300, 100, flame_model_path=paths["model"],
                         flame_template_mesh_path=paths["obj"], device=dev,
                         flame_lmk_embedding_path=paths["lmk"],
                         # no region pickle: the head is the same wherever
                         # $FLAME_ASSET_DIR points
                         flame_parts_path=os.path.join(tmpdir, "none.pkl"))
    model = FlameGaussianModel(sh_degree, head)

    rng = np.random.default_rng(seed)
    model.load_meshes(bench_meshes(rng, num_timesteps), {})

    # n_per_face Gaussians per face, binding sorted by face
    f = head.num_faces
    n = f * n_per_face
    binding = np.repeat(np.arange(f, dtype=np.int64), n_per_face)
    with torch.no_grad():
        frames = model.face_frames_at(model.flame_param, 0)
    face_scaling = frames.scaling.cpu().numpy()[binding]          # [n, 1]

    k = (sh_degree + 1) ** 2
    local_xyz = rng.normal(0, 0.5, (n, 3)).astype(np.float32)
    # 0.814: the JAX package's calibration, matching the projected instance
    # demand of the unbound scene at the bench camera
    world_scales = (0.814 * np.exp(
        rng.normal(-5.2, 0.4, (n, 3)))).astype(np.float32)
    local_scaling = np.log(np.maximum(
        world_scales / np.maximum(face_scaling, 1e-12), 1e-12)
    ).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    sh = np.zeros((n, k, 3), np.float32)
    sh[:, 0] = rng.normal(0.3, 0.5, (n, 3))
    sh[:, 1:] = rng.normal(0, 0.05, (n, k - 1, 3))
    opac = rng.uniform(0.2, 0.98, n).astype(np.float32)

    arrays = dict(
        xyz=local_xyz,
        features_dc=sh[:, 0],
        features_rest=sh[:, 1:].transpose(0, 2, 1).reshape(n, -1),
        scaling=local_scaling,
        rotation=quats,
        opacity=inverse_sigmoid(opac)[:, None].astype(np.float32),
    )
    model.params = GaussianParams(**{
        key: torch.as_tensor(np.ascontiguousarray(a), device=dev)
        for key, a in arrays.items()})
    model.binding = torch.as_tensor(binding, device=dev)
    model.binding_counter = torch.bincount(model.binding, minlength=f)
    model.spatial_lr_scale = 1.0
    model.reset_stats()
    return model


def blend_inputs(scene: dict, camera: CameraParams, tile_size: int,
                 sh_degree: int = SH_DEGREE, tile_row_start: int = 0,
                 tile_rows=None):
    """The tile blend's inputs for a scene dict (`means3d`, `scales`,
    `quats`, `opacities`, `shs`): the (K, 9) stream, the (T, 2) ranges and
    the blend's remaining arguments (py_offset, width, height, tile_size),
    as `ops/rasterize_tiles.py::rasterize` hands them to `blend_image`."""
    proj = project_gaussians(scene["means3d"], scene["scales"],
                             scene["quats"], scene["opacities"], scene["shs"],
                             sh_degree, camera)
    b = bin_gaussians_dense(
        proj.means2d, proj.depths, proj.radii, proj.valid, proj.conics,
        proj.tau, proj.ext_x, proj.ext_y, camera.width, camera.height,
        tile_size, tile_row_start, tile_rows)
    inst = gather_instances(pack_projected(
        proj.means2d, proj.conics, proj.colors, proj.opacities),
        b.gaussian_ids)
    ranges = torch.stack([b.tile_starts, b.tile_ends], -1)
    height = camera.height if tile_rows is None else tile_rows * tile_size
    return inst, ranges, (tile_row_start * tile_size, camera.width, height,
                          tile_size)


def bound_bench_scene(model: FlameGaussianModel, timestep: int = 0) -> dict:
    """The bound avatar's world-space Gaussians at a timestep, as a scene
    dict for `blend_inputs` (no gradients)."""
    with torch.no_grad():
        frames = model.face_frames_at(model.flame_param, timestep)
        m3, sc, q, op, shs = world_space_gaussians(model.params,
                                                   model.binding, frames)
    return dict(means3d=m3, scales=sc, quats=q, opacities=op, shs=shs)


def _look_at_c2w(angle: float, elev: float, dist: float) -> np.ndarray:
    """Camera-to-world (COLMAP axes: y down, z forward) of a camera at
    yaw `angle` and pitch `elev` on a sphere of radius `dist` around the
    origin, looking at it (the bench camera at angle 0, elev 0)."""
    pos = dist * np.array([math.cos(elev) * math.sin(angle), math.sin(elev),
                           -math.cos(elev) * math.cos(angle)])
    fwd = -pos / np.linalg.norm(pos)
    right = np.cross(np.array([0.0, -1.0, 0.0]), fwd)
    right /= np.linalg.norm(right)
    c2w = np.eye(4)
    c2w[:3, :3] = np.stack([right, np.cross(fwd, right), fwd], axis=1)
    c2w[:3, 3] = pos
    return c2w


def write_avatar_dataset(
    root: str, meshes: dict, width: int, height: int,
    n_train_cams: int = 8, dist: float = 1.0,
    image_fn: Optional[Callable] = None,
) -> str:
    """Write a DynamicNerf dataset to `root` and return `root`.

    `meshes` {timestep: FLAME parameters} (as `bench_meshes` makes them)
    go to `flame_param/<t>.npz`, the shape to `canonical_flame_param.npz`.
    Every timestep is seen by `n_train_cams` training cameras spread over
    +-60 degrees of yaw and two pitches, plus one validation and one test
    camera between them, all at distance `dist` with the bench camera's
    horizontal field of view (0.5 rad), at width x height. Their
    `transforms_{train,val,test}.json` are the reference's (OpenGL camera
    axes). The images are `image_fn(camera)` for each `data.cameras.Camera`
    as the readers load it (uint8 [H, W, 3] or [H, W, 4]), by default
    uniform noise from `numpy.random.default_rng(0)`, written as PNGs by
    `utils/png.py`.
    """
    fovx = 0.5
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    os.makedirs(os.path.join(root, "flame_param"), exist_ok=True)
    for t, mesh in meshes.items():
        np.savez(os.path.join(root, "flame_param", f"{t:05d}.npz"), **mesh)
    np.savez(os.path.join(root, "canonical_flame_param.npz"),
             shape=meshes[min(meshes)]["shape"])

    n_cams = n_train_cams + 2
    splits = {"train": [], "val": [], "test": []}
    for t in sorted(meshes):
        for c in range(n_cams):
            split = ("train" if c < n_train_cams
                     else "val" if c == n_train_cams else "test")
            # evaluation cameras sit between the training ones
            offset = 0.5 if split != "train" else 0.0
            angle = math.radians(-60.0 + 120.0 * ((c % n_train_cams) + offset)
                                 / max(n_train_cams - 1, 1))
            elev = 0.15 if c % 2 else -0.15
            c2w = _look_at_c2w(angle, elev, dist)
            c2w[:3, 1:3] *= -1            # COLMAP -> OpenGL axes
            splits[split].append({
                "file_path": f"images/{t:05d}_{c:02d}.png",
                "transform_matrix": c2w.tolist(),
                "camera_angle_x": fovx, "w": width, "h": height,
                "timestep_index": t, "camera_index": c,
                "flame_param_path": f"flame_param/{t:05d}.npz",
            })
    rng = np.random.default_rng(0)
    for split, frames in splits.items():
        name = f"transforms_{split}.json"
        with open(os.path.join(root, name), "w") as f:
            json.dump({"camera_angle_x": fovx, "frames": frames}, f)
        for cam in read_cameras_from_transforms(root, name, False):
            img = (image_fn(cam) if image_fn is not None else
                   rng.integers(0, 256, (height, width, 3), dtype=np.uint8))
            write_png(cam.image_path, img)
    return root
