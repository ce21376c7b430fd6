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

Both use the same numpy random streams as the JAX package's builders, so
the two packages build the same avatar from the same seed. The FLAME
assets are generated with numpy (`make_flame_assets`), and the look-at
camera (`make_camera`) is the JAX test suite's; both are copies, so this
package needs nothing outside itself.
"""

from __future__ import annotations

import math
import os
import pickle
import tempfile

import numpy as np
import torch

from gaussianavatars_torch.device import resolve_device
from gaussianavatars_torch.models.flame import FlameHead
from gaussianavatars_torch.models.flame_gaussians import FlameGaussianModel
from gaussianavatars_torch.models.gaussians import GaussianModel, GaussianParams
from gaussianavatars_torch.ops.projection import CameraParams
from gaussianavatars_torch.ops.transforms import (
    camera_center_from_world_view,
    full_projection,
    perspective_projection,
    world_to_view,
)

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
    """Write a FLAME-like pickle and template OBJ to `dirpath` (the JAX
    package's tests/flame_fixtures.py generator, whose landmark file the
    port does not read).

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
    return dict(model=pkl_path, obj=obj_path)


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
    return GaussianModel(sh_degree, GaussianParams(
        xyz=scene["means3d"],
        features_dc=shs[:, 0].contiguous(),
        features_rest=shs[:, 1:].transpose(1, 2).reshape(shs.shape[0], -1),
        scaling=torch.log(scene["scales"]),
        rotation=scene["quats"],
        opacity=torch.log(opac / (1 - opac))[:, None],
    ))


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
                         flame_template_mesh_path=paths["obj"], device=dev)
    model = FlameGaussianModel(sh_degree, head)

    rng = np.random.default_rng(seed)
    meshes = {
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
    model.load_meshes(meshes, {})

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
        opacity=np.log(opac / (1 - opac))[:, None].astype(np.float32),
    )
    model.params = GaussianParams(**{
        key: torch.as_tensor(np.ascontiguousarray(a), device=dev)
        for key, a in arrays.items()})
    model.binding = torch.as_tensor(binding, device=dev)
    return model
