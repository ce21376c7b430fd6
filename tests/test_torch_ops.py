"""Port parity: quaternion, covariance, SH, transforms and projection ops of
`gaussianavatars_torch` against the JAX package on the same numpy inputs
(float32, CPU). Tolerance atol 1e-6 / rtol 1e-5 (float32 op-order drift);
integer radii and visibility must be equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianavatars_tpu.ops import covariance as jcov
from gaussianavatars_tpu.ops import projection as jproj
from gaussianavatars_tpu.ops import quaternion as jq
from gaussianavatars_tpu.ops import sh as jsh
from gaussianavatars_tpu.ops import transforms as jtf
from gaussianavatars_torch.ops import covariance as tcov
from gaussianavatars_torch.ops import projection as tproj
from gaussianavatars_torch.ops import quaternion as tq
from gaussianavatars_torch.ops import sh as tsh
from gaussianavatars_torch.ops import transforms as ttf

from .utils import make_camera, make_scene

ATOL, RTOL = 1e-6, 1e-5


def close(port, ref, atol=ATOL, rtol=RTOL, msg=""):
    np.testing.assert_allclose(
        port.detach().cpu().numpy() if torch.is_tensor(port) else port,
        np.asarray(ref), atol=atol, rtol=rtol, err_msg=msg)


def _quats(n, seed):
    return np.random.default_rng(seed).normal(size=(n, 4)).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_quaternion_ops(seed):
    a, b = _quats(64, seed), _quats(64, seed + 10)
    close(tq.quat_normalize(torch.from_numpy(a)), jq.quat_normalize(a))
    close(tq.quat_multiply(torch.from_numpy(a), torch.from_numpy(b)),
          jq.quat_multiply(a, b))
    close(tq.quat_to_rotmat(torch.from_numpy(a)), jq.quat_to_rotmat(a))
    m = np.array(jq.quat_to_rotmat(a))
    comps = [m[:, i, j] for i in range(3) for j in range(3)]
    close(tq.rotmat_to_quat_components(*map(torch.from_numpy, comps)),
          jq.rotmat_to_quat_components(*comps))


def test_covariance():
    rng = np.random.default_rng(3)
    scales = np.exp(rng.normal(-2, 0.5, (50, 3))).astype(np.float32)
    q = _quats(50, 3)
    cov_t = tcov.build_covariance_3d(torch.from_numpy(scales),
                                     torch.from_numpy(q))
    cov_j = jcov.build_covariance_3d(scales, q)
    close(cov_t, cov_j)
    close(tcov.strip_symmetric(cov_t), jcov.strip_symmetric(cov_j))
    close(tcov.unstrip_symmetric(tcov.strip_symmetric(cov_t)), cov_j)


@pytest.mark.parametrize("degree", [0, 1, 2, 3, 4])
def test_sh_forward(degree):
    rng = np.random.default_rng(degree)
    k = 25
    dirs = rng.normal(size=(40, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    sh2c = rng.normal(size=(40, 3 * k)).astype(np.float32)
    close(tsh.eval_sh_flat_cmajor(degree, torch.from_numpy(sh2c),
                                  torch.from_numpy(dirs)),
          jsh.eval_sh_flat_cmajor(degree, jnp.asarray(sh2c),
                                  jnp.asarray(dirs)))
    sh3 = rng.normal(size=(40, k, 3)).astype(np.float32)
    close(tsh.flat_cmajor_from_kc(torch.from_numpy(sh3)),
          jsh.flat_cmajor_from_kc(sh3))
    rgb = rng.random((10, 3)).astype(np.float32)
    close(tsh.rgb2sh(torch.from_numpy(rgb)), jsh.rgb2sh(rgb))
    close(tsh.sh2rgb(torch.from_numpy(rgb)), jsh.sh2rgb(rgb))


def test_transforms():
    rng = np.random.default_rng(5)
    q = _quats(1, 5)
    R = np.asarray(jq.quat_to_rotmat(q))[0].astype(np.float64)
    t = rng.normal(size=3)
    np.testing.assert_array_equal(ttf.world_to_view(R, t),
                                  jtf.world_to_view(R, t))
    np.testing.assert_array_equal(
        ttf.world_to_view(R, t, translate=np.ones(3), scale=2.0),
        jtf.world_to_view(R, t, translate=np.ones(3), scale=2.0))
    P_t = ttf.perspective_projection(0.01, 100.0, 0.7, 0.5)
    np.testing.assert_array_equal(
        P_t, jtf.perspective_projection(0.01, 100.0, 0.7, 0.5))
    wv = jtf.world_to_view(R, t)
    np.testing.assert_array_equal(ttf.full_projection(wv, P_t),
                                  jtf.full_projection(wv, P_t))
    np.testing.assert_array_equal(ttf.camera_center_from_world_view(wv),
                                  jtf.camera_center_from_world_view(wv))
    x = rng.normal(size=(30, 3)).astype(np.float32)
    x[0] = 0.0
    close(ttf._safe_normalize(torch.from_numpy(x)), jtf._safe_normalize(x))


def _torch_camera(cam):
    return tproj.CameraParams(
        viewmatrix=torch.from_numpy(np.array(cam.viewmatrix)),
        projmatrix=torch.from_numpy(np.array(cam.projmatrix)),
        campos=torch.from_numpy(np.array(cam.campos)),
        tan_fovx=cam.tan_fovx, tan_fovy=cam.tan_fovy,
        width=cam.width, height=cam.height)


@pytest.mark.parametrize("seed,sh_degree,flat", [(0, 2, False), (1, 3, True),
                                                 (2, 1, True)])
def test_project_gaussians(seed, sh_degree, flat):
    cam = make_camera(width=64, height=48, fovx=0.9, dist=3.0)
    scene = make_scene(n=200, seed=seed, sh_degree=sh_degree)
    shs = np.array(scene["shs"])
    if flat:
        shs = np.array(jsh.flat_cmajor_from_kc(shs))
    args = [np.array(scene[k]) for k in
            ("means3d", "scales", "quats", "opacities")] + [shs]
    ref = jproj.project_gaussians(*[jnp.asarray(a) for a in args],
                                  sh_degree, cam)
    out = tproj.project_gaussians(*[torch.from_numpy(a) for a in args],
                                  sh_degree, _torch_camera(cam))
    assert set(out._fields) == set(ref._fields)
    for name in out._fields:
        a, b = getattr(out, name), getattr(ref, name)
        if name in ("radii", "valid"):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=name)
        else:
            close(a, b, msg=name)
    assert out.valid.any() and not out.valid.all()
