"""Port parity: LBS, the FLAME head with procedural teeth, face frames and
the binding chain of `gaussianavatars_torch` against the JAX package, on
the synthetic FLAME assets of tests/flame_fixtures.py. Tolerance atol 1e-5
(float32 blendshape/LBS sums in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianavatars_tpu.models import flame_gaussians as jfg
from gaussianavatars_tpu.models import gaussians as jg
from gaussianavatars_tpu.models.flame import FlameHead as JFlameHead
from gaussianavatars_tpu.ops import lbs as jlbs
from gaussianavatars_torch.models import flame_gaussians as tfg
from gaussianavatars_torch.models import gaussians as tg
from gaussianavatars_torch.models.flame import FlameHead as TFlameHead
from gaussianavatars_torch.ops import lbs as tlbs

from .flame_fixtures import make_flame_assets
from .test_torch_blend import one_torch_thread  # noqa: F401

ATOL = 1e-5


def close(port, ref, atol=ATOL, msg=""):
    np.testing.assert_allclose(port.detach().cpu().numpy(), np.asarray(ref),
                               atol=atol, rtol=1e-5, err_msg=msg)


@pytest.fixture(scope="module")
def heads(tmp_path_factory):
    paths = make_flame_assets(str(tmp_path_factory.mktemp("flame")), seed=0)
    jhead = JFlameHead(300, 100, flame_model_path=paths["model"],
                       flame_lmk_embedding_path=paths["lmk"],
                       flame_template_mesh_path=paths["obj"],
                       flame_parts_path="/nonexistent", include_mask=False,
                       add_teeth=True)
    thead = TFlameHead(300, 100, flame_model_path=paths["model"],
                       flame_template_mesh_path=paths["obj"], device="cpu")
    return jhead, thead


def _flame_inputs(seed, v):
    rng = np.random.default_rng(seed)

    def r(*shape, s=1.0):
        return (rng.normal(size=shape) * s).astype(np.float32)

    return dict(shape=r(1, 300, s=0.5), expr=r(1, 100, s=0.5),
                rotation=r(1, 3, s=0.2), neck=r(1, 3, s=0.2),
                jaw=np.abs(r(1, 3, s=0.1)), eyes=r(1, 6, s=0.1),
                translation=r(1, 3, s=0.05),
                static_offset=r(1, v, 3, s=1e-3),
                dynamic_offset=r(1, v, 3, s=1e-3))


@pytest.mark.parametrize("seed", [0, 1])
def test_lbs(seed):
    rng = np.random.default_rng(seed)
    v, j, b = 60, 5, 2
    parents = [-1, 0, 1, 1, 1]
    pose = (rng.normal(size=(b, j * 3)) * 0.3).astype(np.float32)
    v_shaped = rng.normal(size=(b, v, 3)).astype(np.float32)
    posedirs = (rng.normal(size=((j - 1) * 9, v * 3)) * 0.01).astype(
        np.float32)
    j_reg = np.abs(rng.normal(size=(j, v))).astype(np.float32) / v
    w = rng.random((v, j)).astype(np.float32)
    w /= w.sum(1, keepdims=True)
    ref = jlbs.lbs(*map(jnp.asarray, (pose, v_shaped, posedirs, j_reg)),
                   parents, jnp.asarray(w))
    out = tlbs.lbs(*map(torch.from_numpy, (pose, v_shaped, posedirs, j_reg)),
                   parents, torch.from_numpy(w))
    for a, b_, name in zip(out, ref, ("verts", "joints", "A1")):
        close(a, b_, msg=name)
    rot = (rng.normal(size=(8, 3)) * 0.7).astype(np.float32)
    close(tlbs.batch_rodrigues(torch.from_numpy(rot)),
          jlbs.batch_rodrigues(jnp.asarray(rot)))


def test_flame_topology_and_bases(heads):
    jhead, thead = heads
    assert thead.num_verts == 5143 and thead.num_faces == 10144
    np.testing.assert_array_equal(thead.faces.numpy(), jhead.faces)
    for name in ("v_template", "shapedirs", "posedirs", "j_regressor",
                 "lbs_weights"):
        np.testing.assert_array_equal(getattr(thead, name).numpy(),
                                      getattr(jhead, name), err_msg=name)
    assert thead.parents == [int(p) for p in jhead.parents]


@pytest.mark.parametrize("seed", [0, 1])
def test_flame_forward(heads, seed):
    jhead, thead = heads
    x = _flame_inputs(seed, thead.num_verts)
    keys = ("shape", "expr", "rotation", "neck", "jaw", "eyes",
            "translation")
    ref = jhead.forward(
        *[jnp.asarray(x[k]) for k in keys], return_landmarks=False,
        static_offset=jnp.asarray(x["static_offset"]),
        dynamic_offset=jnp.asarray(x["dynamic_offset"]))
    out = thead(
        *[torch.from_numpy(x[k]) for k in keys],
        static_offset=torch.from_numpy(x["static_offset"]),
        dynamic_offset=torch.from_numpy(x["dynamic_offset"]))
    close(out, ref, msg="verts")


def test_face_frames_and_binding_chain(heads):
    jhead, thead = heads
    x = _flame_inputs(2, thead.num_verts)
    keys = ("shape", "expr", "rotation", "neck", "jaw", "eyes",
            "translation")
    verts = np.array(jhead.forward(*[jnp.asarray(x[k]) for k in keys],
                                   return_landmarks=False))[0]
    jf = jfg.face_frames_from_verts(jnp.asarray(verts), jhead.j_faces)
    tf = tfg.face_frames_from_verts(torch.from_numpy(verts), thead.faces)
    for name in tg.FaceFrames._fields:
        close(getattr(tf, name), getattr(jf, name), msg=name)

    rng = np.random.default_rng(7)
    n, k = 500, 16
    arrays = dict(
        xyz=rng.normal(0, 0.5, (n, 3)), features_dc=rng.normal(size=(n, 3)),
        features_rest=rng.normal(size=(n, 3 * (k - 1))),
        scaling=rng.normal(-1, 0.3, (n, 3)), rotation=rng.normal(size=(n, 4)),
        opacity=rng.normal(size=(n, 1)))
    arrays = {key: a.astype(np.float32) for key, a in arrays.items()}
    binding = rng.integers(0, thead.num_faces, n)
    jp = jg.GaussianParams(**{key: jnp.asarray(a) for key, a in arrays.items()})
    tp = tg.GaussianParams(**{key: torch.from_numpy(a)
                              for key, a in arrays.items()})
    names = ("means3d", "scales", "quats", "opacities", "shs")
    ref = jg.world_space_gaussians(jp, jnp.asarray(binding, jnp.int32), jf)
    out = tg.world_space_gaussians(tp, torch.from_numpy(binding), tf)
    for a, b, name in zip(out, ref, names):
        close(a, b, msg=f"bound {name}")
    ref = jg.world_space_gaussians(jp, None, None)
    out = tg.world_space_gaussians(tp, None, None)
    for a, b, name in zip(out, ref, names):
        close(a, b, msg=f"unbound {name}")


@pytest.mark.parametrize("with_targets", [False, True])
def test_load_meshes(heads, with_targets):
    jhead, thead = heads
    rng = np.random.default_rng(11)

    def mesh():
        return dict(
            shape=rng.normal(size=300), expr=rng.normal(size=100),
            rotation=rng.normal(size=3), neck_pose=rng.normal(size=3),
            jaw_pose=rng.normal(size=3), eyes_pose=rng.normal(size=6),
            translation=rng.normal(size=3),
            static_offset=rng.normal(size=(5023, 3)) * 1e-3)

    train, test = {0: mesh(), 2: mesh()}, {1: mesh()}
    tgt = ({0: mesh(), 3: mesh()}, {}) if with_targets else (None, None)
    jm = jfg.FlameGaussianModel(0, flame_head=jhead)
    jm.load_meshes(train, test, *tgt)
    tm = tfg.FlameGaussianModel(0, thead)
    tm.load_meshes(train, test, *tgt)
    assert tm.num_timesteps == jm.num_timesteps == (4 if with_targets else 3)
    assert set(tm.flame_param) == set(jm.flame_param)
    for k, v in tm.flame_param.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jm.flame_param[k]),
                                      err_msg=k)
