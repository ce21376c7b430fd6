"""The projection's autograd function `ProjectGaussians`
(`gaussianavatars_torch/ops/projection.py`): its closed-form backward
`project_bwd_plain` against autograd through the plain forward
`project_gaussians_plain` (float64 at rtol 1e-10; float32 at max|d| /
max|ref| <= 1e-5 per gradient), over SH degrees 0-4, with and without
`means2d_offset`, `scaling_modifier` 1 and 2, and at the near plane, both
frustum clamps, det <= 0 and a colour clamped to 0; and its routing (CPU
tensors to the plain versions, precomputed covariances to autograd,
precomputed colours beside the fused geometry, the outputs that carry no
gradient).

On the card (`card` marker): kernels `project_fwd` and `project_bwd`
(`csrc/project.cu`) against the plain versions. This file imports no JAX,
so its card test runs on the GPU host: python -m pytest --noconftest -m
card tests/test_torch_projection_bwd.py
"""

import types

import pytest
import torch

from gaussianavatars_torch import benchmark as tbench
from gaussianavatars_torch.device import route
from gaussianavatars_torch.ops import projection as tproj
from gaussianavatars_torch.utils import trace

W, H = 64, 48
TOL64 = 1e-10
TOL32 = 1e-5


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _camera(dtype, device="cpu"):
    cam = tbench.make_camera(W, H, fovx=0.9, dist=3.0, device=device)
    return cam._replace(**{k: getattr(cam, k).to(dtype) for k in
                           ("viewmatrix", "projmatrix", "campos")})


def _from_view(cam, p_view):
    """World positions [N, 3] whose view-space positions are `p_view`."""
    vm = cam.viewmatrix.to(torch.float64)
    hom = torch.cat([p_view.to(torch.float64),
                     torch.ones(p_view.shape[0], 1, dtype=torch.float64)], 1)
    return (hom @ torch.linalg.inv(vm))[:, :3].to(cam.viewmatrix.dtype)


def _scene(n, degree, dtype, seed, extra_k=2):
    g = torch.Generator().manual_seed(seed)
    k = (degree + 1) ** 2 + extra_k
    return dict(
        means3d=torch.randn(n, 3, generator=g, dtype=torch.float64),
        scales=torch.exp(torch.randn(n, 3, generator=g,
                                     dtype=torch.float64) * 0.5 - 2.5),
        quats=torch.randn(n, 4, generator=g, dtype=torch.float64),
        opacities=torch.rand(n, generator=g, dtype=torch.float64),
        shs=torch.randn(n, 3 * k, generator=g, dtype=torch.float64) * 0.5,
        seed=seed, dtype=dtype)


def _probes(kind, dtype):
    """A scene of `kind` probes and its camera
    (`test_probes_reach_every_mask` shows each takes its branch)."""
    cam = _camera(dtype)
    s = _scene(64, 3, dtype, seed=7)
    n = s["means3d"].shape[0]
    g = torch.Generator().manual_seed(11)
    xy = (torch.rand(n, 2, generator=g, dtype=torch.float64) - 0.5) * 0.2
    if kind == "near":          # behind, at and around z = 0.2
        z = torch.tensor([-1.0, 0.0, 0.1, 0.199, 0.2, 0.201, 0.3, 1.0],
                         dtype=torch.float64).repeat(n // 8)
        view = torch.cat([xy * z[:, None], z[:, None]], 1)
        s["means3d"] = _from_view(cam, view)
    elif kind == "frustum":     # past 1.3 tan on either side of x and y
        tx, ty = cam.tan_fovx, cam.tan_fovy
        u = torch.tensor([[-2 * tx, 0.1], [2 * tx, -0.1], [0.1, -2 * ty],
                          [-0.1, 2 * ty], [-2 * tx, 2 * ty], [1.0 * tx, 0.2],
                          [1.5 * tx, -1.5 * ty], [0.0, 0.0]],
                         dtype=torch.float64).repeat(n // 8, 1)
        z = 2.0 + torch.rand(n, 1, generator=g, dtype=torch.float64)
        s["means3d"] = _from_view(cam, torch.cat([u * z, z], 1))
    elif kind == "det":         # needles whose det rounds to <= 0
        big = 1e4 if dtype == torch.float32 else 1e8
        s["scales"] = torch.zeros(n, 3, dtype=torch.float64)
        s["scales"][:, 0] = big
        s["means3d"] = s["means3d"] * 0.1
    elif kind == "colour":      # a channel's DC far below -0.5 / C0
        k = s["shs"].shape[1] // 3
        s["shs"][: n // 2, 0] = -5.0
        s["shs"][n // 4: 3 * n // 4, 2 * k] = -5.0
    if kind == "det":           # keep the needles whose det is <= 0
        keep = ~_det_positive(_args(s), cam)
        assert int(keep.sum()) >= 4
        s = {k: (v[keep] if torch.is_tensor(v) else v) for k, v in s.items()}
    return s, cam


def _det_positive(args, cam):
    comps = tproj._cov3d_components(args[1], args[2])
    fx, fy = tproj._focals(cam)
    a, b, c = tproj.compute_cov2d_components(args[0], comps, cam.viewmatrix,
                                             fx, fy, cam.tan_fovx,
                                             cam.tan_fovy)
    return a * c - b ** 2 > 0.0


def _args(s):
    return [s[k].to(s["dtype"]) for k in
            ("means3d", "scales", "quats", "opacities", "shs")]


def _cotangents(n, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(n, c, generator=g, dtype=torch.float64).to(dtype)
            * scale for c, scale in ((2, 1.0), (3, 1e-2), (3, 1.0))]


def _worst(s, cam, degree, offset, smod):
    """max over the gradients of max|d| / max|ref| between
    `project_bwd_plain` and autograd through `project_gaussians_plain`."""
    m, sc, q, op, sh = _args(s)
    n = m.shape[0]
    off = torch.zeros(n, 2, dtype=m.dtype) if offset else None
    leaves = [m, sc, q, sh] + ([off] if offset else [])
    for t in leaves:
        t.requires_grad_(True)
    ref = tproj.project_gaussians_plain(m, sc, q, op, sh, degree, cam, smod,
                                        off)
    g2, gc, gk = _cotangents(n, m.dtype, s["seed"] + 1)
    loss = ((ref.means2d * g2).sum() + (ref.conics * gc).sum()
            + (ref.colors * gk).sum())
    want = torch.autograd.grad(loss, leaves)
    with torch.no_grad():
        got = tproj.project_bwd_plain(m, sc, q, sh, degree, cam, smod, g2,
                                      gc, gk)
    got = list(got[:4]) + ([got[4]] if offset else [])
    return max(float((a - b).abs().max() / b.abs().max().clamp(min=1e-300))
               for a, b in zip(got, want))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("smod", [1.0, 2.0])
@pytest.mark.parametrize("offset", [False, True])
@pytest.mark.parametrize("degree", [0, 1, 2, 3, 4])
def test_bwd_plain_matches_autograd(degree, offset, smod, dtype):
    s = _scene(300, degree, dtype, seed=degree)
    worst = _worst(s, _camera(dtype), degree, offset, smod)
    assert worst <= (TOL64 if dtype == torch.float64 else TOL32), worst


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("kind", ["near", "frustum", "det", "colour"])
def test_bwd_plain_matches_autograd_at_probes(kind, dtype):
    s, cam = _probes(kind, dtype)
    worst = _worst(s, cam, 3, kind == "near", 1.0)
    assert worst <= (TOL64 if dtype == torch.float64 else TOL32), worst


def test_probes_reach_every_mask():
    """Each probe scene takes the branch it is named for."""
    s, cam = _probes("near", torch.float64)
    with torch.no_grad():
        out = tproj.project_gaussians_plain(*_args(s), 3, cam)
    assert bool((out.depths < 0.2).any() and (out.depths > 0.2).any())
    s, cam = _probes("frustum", torch.float64)
    e = tproj._ewa(s["means3d"], tproj._cov3d_components(
        s["scales"], s["quats"]), cam.viewmatrix, *tproj._focals(cam),
        cam.tan_fovx, cam.tan_fovy)
    limx, limy = 1.3 * cam.tan_fovx, 1.3 * cam.tan_fovy
    for u, lim in zip(e.u, (limx, limy)):
        assert bool((u < -lim).any() and (u > lim).any()
                    and (u.abs() < lim).any())
    for dtype in (torch.float64, torch.float32):
        s, cam = _probes("det", dtype)
        assert not bool(_det_positive(_args(s), cam).any())
    s, cam = _probes("colour", torch.float64)
    with torch.no_grad():
        out = tproj.project_gaussians_plain(*_args(s), 3, cam)
    assert bool((out.colors == 0.0).any() and (out.colors > 0.0).any())


def _leaves(s):
    args = _args(s)
    for t in args[:3] + args[4:]:
        t.requires_grad_(True)
    return args


def test_cpu_routes_to_the_plain_versions():
    s = _scene(200, 3, torch.float32, seed=3)
    cam = _camera(torch.float32)
    m, sc, q, op, sh = _leaves(s)
    off = torch.zeros(200, 2, requires_grad=True)
    trace.start()
    with trace.span("root"):
        out = tproj.project_gaussians(m, sc, q, op, sh, 3, cam, 1.0, off)
    (root,) = trace.drain()
    assert root.counters == {trace.PROJECTIONS_FUSED: 1}
    ref = tproj.project_gaussians_plain(m, sc, q, op, sh, 3, cam, 1.0, off)
    for name in out._fields:
        assert torch.equal(getattr(out, name), getattr(ref, name)), name
    assert out.means2d.grad_fn.name() == "ProjectGaussiansBackward"
    assert out.opacities is op
    g2, gc, gk = _cotangents(200, torch.float32, 5)
    leaves = [m, sc, q, sh, off]
    got = torch.autograd.grad((out.means2d * g2).sum() + (out.conics * gc)
                              .sum() + (out.colors * gk).sum(), leaves)
    want = torch.autograd.grad((ref.means2d * g2).sum() + (ref.conics * gc)
                               .sum() + (ref.colors * gk).sum(), leaves)
    for a, b in zip(got, want):
        assert float((a - b).abs().max() / b.abs().max()) <= TOL32


def test_only_means2d_conics_and_colors_carry_gradients():
    s = _scene(50, 2, torch.float32, seed=4)
    out = tproj.project_gaussians(*_leaves(s), 2, _camera(torch.float32))
    for name in ("means2d", "conics", "colors"):
        assert getattr(out, name).requires_grad, name
    for name in ("depths", "radii", "valid", "r2_max", "tau", "ext_x",
                 "ext_y"):
        assert not getattr(out, name).requires_grad, name
    # what the binning reads of them does not reach the inputs
    out.means2d.sum().backward()


def test_precomputed_covariances_take_autograd():
    s = _scene(80, 1, torch.float32, seed=5)
    m, sc, q, op, sh = _leaves(s)
    cov = (sc[:, :, None] * sc[:, None, :]).detach().requires_grad_(True)
    cam = _camera(torch.float32)
    trace.start()
    with trace.span("root"):
        out = tproj.project_gaussians(m, sc, q, op, sh, 1, cam,
                                      cov3d_precomp=cov)
    (root,) = trace.drain()
    assert root.counters == {}
    assert out.means2d.grad_fn.name() != "ProjectGaussiansBackward"
    assert out.depths.requires_grad        # autograd's path, as it was
    ref = tproj.project_gaussians_plain(m, sc, q, op, sh, 1, cam,
                                        cov3d_precomp=cov)
    for name in out._fields:
        assert torch.equal(getattr(out, name), getattr(ref, name)), name


def test_precomputed_colours_keep_the_fused_geometry():
    s = _scene(80, 3, torch.float32, seed=6)
    m, sc, q, op, sh = _leaves(s)
    colors = torch.rand(80, 3, requires_grad=True)
    cam = _camera(torch.float32)
    out = tproj.project_gaussians(m, sc, q, op, None, 3, cam,
                                  colors_precomp=colors)
    default = tproj.project_gaussians(m, sc, q, op, sh, 3, cam)
    assert out.colors is colors
    assert out.means2d.grad_fn.name() == "ProjectGaussiansBackward"
    for name in ("means2d", "conics", "radii", "valid", "ext_x", "ext_y"):
        assert torch.equal(getattr(out, name), getattr(default, name)), name
    g = torch.autograd.grad((out.colors * 2.0).sum() + out.means2d.sum(),
                            [colors, m])
    assert torch.equal(g[0], torch.full_like(colors, 2.0))
    want = torch.autograd.grad(default.means2d.sum(), m)[0]
    assert torch.equal(g[1], want)


def test_coefficient_major_shs_match_the_flat_layout():
    s = _scene(60, 2, torch.float32, seed=8)
    m, sc, q, op, sh = _args(s)
    k = sh.shape[1] // 3
    kc = sh.reshape(60, 3, k).transpose(1, 2).contiguous()
    cam = _camera(torch.float32)
    a = tproj.project_gaussians(m, sc, q, op, kc, 2, cam)
    b = tproj.project_gaussians(m, sc, q, op, sh, 2, cam)
    assert torch.equal(a.colors, b.colors)


def test_route_by_device():
    cuda, plain = object(), object()
    on = types.SimpleNamespace
    assert route(on(device=torch.device("cuda")), cuda, plain) is cuda
    assert route(on(device=torch.device("cpu")), cuda, plain) is plain
    with pytest.raises(ValueError):
        route(on(device=torch.device("meta")), cuda, plain)


def test_kernel_inputs_refuse_what_the_kernels_do_not_take():
    s = _scene(10, 3, torch.float32, seed=9)
    m, sc, q, _, sh = _args(s)
    with pytest.raises(ValueError):            # K below (3 + 1)^2
        tproj._kernel_inputs(m, sc, q, sh[:, :30], 3)
    with pytest.raises(ValueError):
        tproj._kernel_inputs(m.double(), sc, q, sh, 3)
    with pytest.raises(ValueError):
        tproj._kernel_inputs(m, sc, q, sh, 5)
    # a quaternion view off the 16-byte grid is copied onto it
    wide = torch.zeros(10, 5)
    wide[:, 1:] = q
    m2, sc2, q2, k = tproj._kernel_inputs(m, sc, wide[:, 1:], sh, 3)
    assert k == sh.shape[1] // 3 and q2.data_ptr() % 16 == 0
    assert torch.equal(q2, q)


@pytest.mark.card
@pytest.mark.parametrize("degree", [0, 3, 4])
def test_kernels_match_the_plain_versions_on_the_card(degree):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the projection kernels are CUDA")
    dev = torch.device("cuda")
    s = _scene(5000, degree, torch.float32, seed=10 + degree)
    args = [t.to(dev) for t in _args(s)]
    cam = _camera(torch.float32, device=dev)
    off = torch.zeros(5000, 2, device=dev)
    fwd = tproj.project_fwd_cuda(*args, degree, cam, 1.0, off)
    plain = tproj.project_fwd_plain(*args, degree, cam, 1.0, off)
    torch.cuda.synchronize()
    for name, a, b in zip(tproj.ProjectedGaussians._fields[:4]
                          + tproj.ProjectedGaussians._fields[5:],
                          fwd, plain):
        if a.dtype in (torch.int32, torch.bool):
            assert float((a != b).float().mean()) <= 1e-3, name
        else:
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-4,
                                       msg=name)
    g = [t.to(dev) for t in _cotangents(5000, torch.float32, 3)]
    # the pack's gradient hands the cotangents over as stride-9 slices
    pack = torch.cat(g + [torch.zeros(5000, 1, device=dev)], 1)
    views = (pack[:, 0:2], pack[:, 2:5], pack[:, 5:8])
    got = tproj.project_bwd_cuda(*args[:3], args[4], degree, cam, 1.0,
                                 *views)
    want = tproj.project_bwd_plain(*args[:3], args[4], degree, cam, 1.0, *g)
    for a, b in zip(got, want):
        assert float((a - b).abs().max() / b.abs().max()) <= TOL32
