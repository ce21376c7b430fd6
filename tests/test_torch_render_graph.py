"""The render's captured prefix (`train/render_graph.py` of the port).

On the CPU: the graph's key holds across in-place parameter updates and
cameras of one size and changes with anything a capture bakes in; the
capture policy (eager, then capture and replay, a new key dropping the
graph) with the capture stood in for by a plain call of the prefix, whose
output is then the eager render's bit for bit at a device-index timestep;
the CPU and differentiable renders stay on the eager path, bit for bit the
render as it was before the graph; FLAME's skinning opens no sync span.
On the card (`card` marker): the graphed render equals the eager one bit
for bit over a few frames and captures again after a parameter swap.
This file imports no JAX, so its card test runs on the GPU host.
"""

import types

import pytest
import torch

from gaussianavatars_torch import benchmark as tbench
from gaussianavatars_torch.config import PipelineConfig
from gaussianavatars_torch.models.gaussians import (
    GaussianParams,
    world_space_gaussians,
)
from gaussianavatars_torch.ops import lbs
from gaussianavatars_torch.ops.rasterize_tiles import rasterize
from gaussianavatars_torch.train import loop, render_graph
from gaussianavatars_torch.train.loop import (
    _camera,
    camera_arrays,
    make_render_fn,
)
from gaussianavatars_torch.utils import trace

W, H, TILE = 64, 48, 16
RENDER_MARKS = ["flame_frames", "binding", "projection", "binning",
                "pack_gather", "blend", "composite"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread a test module: with several test workers, torch's
    intra-op threads only contend on the plain CPU loops."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def no_tracer():
    trace.stop()
    yield
    trace.stop()


@pytest.fixture(scope="module")
def model():
    """The 1-per-face bound bench avatar (SH 1, 4 timesteps) on the CPU."""
    return tbench.make_bound_bench_model(sh_degree=1, n_per_face=1,
                                         device="cpu")


def _cam(dist=1.0, width=W, height=H, fovx=0.08, device="cpu"):
    """A camera of the narrow bench view (few Gaussians on screen, so the
    plain CPU blend stays quick)."""
    return camera_arrays(tbench.make_camera(width, height, fovx=fovx,
                                            dist=dist, device=device))


def _own_params(model):
    """A copy of the model's parameters the test may update in place."""
    return GaussianParams(*[p.clone() for p in model.params])


def _eager(model, params, flame, cam, timestep, bg, width=W, height=H):
    """The render as `make_render_fn` computed it before the graph."""
    camera = _camera(cam, width, height)
    with torch.no_grad():
        frames = model.face_frames_at(flame, timestep)
        g = world_space_gaussians(params, model.binding, frames)
        return rasterize(*g, model.active_sh_degree, camera, bg,
                         tile_size=TILE)


def _same(a, b):
    for k in ("image", "transmittance", "radii", "visibility"):
        assert torch.equal(getattr(a, k), getattr(b, k)), k
    assert a.instance_total == b.instance_total


def _graph(model, sh_degree=1, options=(False, False)):
    return render_graph.PrefixGraph(model, None, sh_degree, options)


def _key(graph, params, flame, binding, cam=None, width=W, height=H,
         scaling_modifier=1.0):
    return graph.key(params, flame, binding,
                     _camera(cam or _cam(), width, height), scaling_modifier)


def test_key_holds_across_updates_and_cameras(model):
    params = _own_params(model)
    flame = {k: v.clone() for k, v in model.flame_param.items()}
    g = _graph(model)
    before = _key(g, params, flame, model.binding, _cam(1.0))
    for p in params:                       # Adam's in-place steps
        p.add_(0.01)
    flame["expr"].mul_(0.5)
    assert _key(g, params, flame, model.binding, _cam(1.7)) == before


CHANGES = {
    "params_replaced": lambda m, p, f: dict(
        params=GaussianParams(*[t.clone() for t in p])),
    "pruned": lambda m, p, f: dict(
        params=GaussianParams(*[t[:-1] for t in p]),
        binding=m.binding[:-1]),
    "binding_replaced": lambda m, p, f: dict(binding=m.binding.clone()),
    "flame_replaced": lambda m, p, f: dict(
        flame={k: v.clone() for k, v in f.items()}),
    "width": lambda m, p, f: dict(width=W + 16),
    "height": lambda m, p, f: dict(height=H + 16),
    "tan_fov": lambda m, p, f: dict(cam=_cam(fovx=0.1)),
    "scaling_modifier": lambda m, p, f: dict(scaling_modifier=2.0),
    "sh_degree": lambda m, p, f: dict(graph=_graph(m, sh_degree=0)),
    "pipeline_options": lambda m, p, f: dict(
        graph=_graph(m, options=(True, False))),
}


@pytest.mark.parametrize("change", sorted(CHANGES))
def test_key_changes_with_what_a_capture_bakes_in(model, change):
    params = _own_params(model)
    flame = dict(model.flame_param)
    args = dict(graph=_graph(model), params=params, flame=flame,
                binding=model.binding)
    before = _key(**args)
    args.update(CHANGES[change](model, params, flame))
    assert _key(**args) != before


class _PlainCapture:
    """Stands in for `render_graph._Captured` on the CPU: each replay runs
    the captured prefix with the timestep as a [1] int64 index tensor, as
    the graph reads it."""

    made = []

    def __init__(self, key, project, params, flame_param, binding, camera,
                 timestep, scaling_modifier):
        self.key = key
        self.args = (project, params, flame_param, binding, scaling_modifier)
        self.resets = 0
        self.graph = types.SimpleNamespace(reset=self._reset)
        self.out = None
        self.fused = 0          # each replay projects and counts itself
        _PlainCapture.made.append(self)

    def _reset(self):
        self.resets += 1

    def replay(self, camera, timestep):
        project, params, flame, binding, scaling_modifier = self.args
        self.out = project(params, flame, binding, camera,
                           torch.tensor([timestep]), scaling_modifier)
        return self.out


def _counted(records, name):
    return sum(r.counters.get(name, 0) for r in records)


def test_capture_policy_and_the_graphed_render(model, monkeypatch):
    monkeypatch.setattr(render_graph, "_on_current_card", lambda t: True)
    monkeypatch.setattr(render_graph, "_Captured", _PlainCapture)
    _PlainCapture.made = []
    params = _own_params(model)
    flame = model.flame_param
    render = make_render_fn(model, PipelineConfig(tile_size=TILE), W, H,
                            model.active_sh_degree)
    bg = torch.ones(3)
    trace.start()
    frames = [(1.0, 0), (1.3, 2), (1.6, 3), (1.1, -1)]
    for i, (dist, t) in enumerate(frames):
        marks = []
        out = render(params, flame, model.binding, _cam(dist), bg, t,
                     marks.append)
        records = trace.drain()
        _same(out, _eager(model, params, flame, _cam(dist), t, bg))
        assert marks == RENDER_MARKS
        graphed = [r for r in records if r.name == "graph_replay"]
        assert len(graphed) == (0 if i == 0 else 1)
        assert _counted(records, trace.GRAPH_CAPTURES) == (i == 1)
        assert _counted(records, trace.GRAPH_REPLAYS) == (i > 0)
        if graphed:
            root = graphed[0].parent
            assert root.name == "render" and root.parent is None
            assert [r.name for r in records if r.parent is root] == [
                "graph_replay", "flame_frames", "binding", "rasterize"]
            # the static outputs are not handed out
            cap = _PlainCapture.made[-1]
            assert out.radii.data_ptr() != cap.out.radii.data_ptr()
            assert out.visibility.data_ptr() != cap.out.valid.data_ptr()
    assert len(_PlainCapture.made) == 1
    with torch.no_grad():                  # an in-place update: replayed
        params.xyz.add_(1e-3)
    out = render(params, flame, model.binding, _cam(1.2), bg, 1)
    _same(out, _eager(model, params, flame, _cam(1.2), 1, bg))
    assert len(_PlainCapture.made) == 1
    with pytest.raises(IndexError):
        render(params, flame, model.binding, _cam(), bg, 4)
    trace.drain()

    # a densification's new tensors: dropped, eager, then captured again
    params = _own_params(model)
    for i in range(3):
        out = render(params, flame, model.binding, _cam(1.0), bg, i)
        _same(out, _eager(model, params, flame, _cam(1.0), i, bg))
    records = trace.drain()
    assert _PlainCapture.made[0].resets == 1
    assert len(_PlainCapture.made) == 2
    assert _counted(records, trace.GRAPH_CAPTURES) == 1
    assert _counted(records, trace.GRAPH_REPLAYS) == 2


@pytest.mark.parametrize("path", ["cpu", "differentiable"])
def test_cpu_and_differentiable_renders_are_eager(model, path, monkeypatch):
    if path == "differentiable":
        def no_graph(*args):
            raise AssertionError("a differentiable render made a graph")
        monkeypatch.setattr(loop, "PrefixGraph", no_graph)
    render = make_render_fn(model, PipelineConfig(tile_size=TILE), W, H,
                            model.active_sh_degree,
                            differentiable=path == "differentiable")
    bg = torch.ones(3)
    trace.start()
    for t in (0, 0, 0, 2):
        marks = []
        out = render(model.params, model.flame_param, model.binding,
                     _cam(1.2), bg, t, marks.append)
        assert marks == RENDER_MARKS
        _same(out._replace(image=out.image.detach()),
              _eager(model, model.params, model.flame_param, _cam(1.2), t,
                     bg))
    assert "graph_replay" not in {r.name for r in trace.drain()}


def _rigid_transform_with_host_row(rot_mats, joints, parents):
    """`batch_rigid_transform` as it was, with its row copied from the
    host on every call."""
    b, j = joints.shape[:2]
    rel_joints = [joints[:, 0]] + [joints[:, i] - joints[:, parents[i]]
                                   for i in range(1, j)]
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=joints.dtype,
                          device=joints.device).expand(b, 1, 4)
    local = [torch.cat([torch.cat([rot_mats[:, i], rel_joints[i][..., None]],
                                  dim=-1), bottom], dim=-2) for i in range(j)]
    chain = [local[0]]
    for i in range(1, j):
        chain.append(torch.matmul(chain[parents[i]], local[i]))
    transforms = torch.stack(chain, dim=1)
    joints_h = torch.cat([joints, joints.new_zeros(b, j, 1)], dim=-1)
    shifted = torch.einsum("bjmn,bjn->bjm", transforms, joints_h)
    correction = torch.zeros_like(transforms)
    correction[:, :, :, 3] = shifted
    return transforms[:, :, :3, 3], transforms - correction


def test_batch_rigid_transform_opens_no_sync_span():
    rng = torch.Generator().manual_seed(0)
    rot = torch.linalg.matrix_exp(
        torch.randn(2, 5, 3, 3, generator=rng) * 0.3)
    joints = torch.randn(2, 5, 3, generator=rng)
    parents = [-1, 0, 1, 1, 1]
    trace.start()
    posed, rel = lbs.batch_rigid_transform(rot, joints, parents)
    assert trace.drain() == []
    ref_posed, ref_rel = _rigid_transform_with_host_row(rot, joints, parents)
    assert torch.equal(posed, ref_posed) and torch.equal(rel, ref_rel)
    # one row a (device, dtype), built once
    assert lbs._bottom_row(torch.float32, joints.device) is \
        lbs._bottom_row(torch.float32, joints.device)


@pytest.mark.card
def test_graphed_equals_eager_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the prefix graph is a CUDA graph")
    dev = torch.device("cuda")
    m = tbench.make_bound_bench_model(sh_degree=3, device=dev)
    graphed = make_render_fn(m, PipelineConfig(), 160, 120, 3)
    eager = make_render_fn(m, PipelineConfig(), 160, 120, 3,
                           differentiable=True)
    bg = torch.ones(3, device=dev)

    def frames(params, n):
        for i in range(n):
            cam = camera_arrays(tbench.make_camera(
                160, 120, fovx=0.5, dist=1.0 + 0.05 * i, device=dev))
            out = graphed(params, m.flame_param, m.binding, cam, bg, i % 4)
            with torch.no_grad():
                ref = eager(params, m.flame_param, m.binding, cam, bg, i % 4)
            _same(out, ref)

    trace.start()
    frames(m.params, 6)
    records = trace.drain()
    assert _counted(records, trace.GRAPH_CAPTURES) == 1
    assert _counted(records, trace.GRAPH_REPLAYS) == 5
    frames(GaussianParams(*[p.clone() for p in m.params]), 4)
    records = trace.drain()
    assert _counted(records, trace.GRAPH_CAPTURES) == 1
    assert _counted(records, trace.GRAPH_REPLAYS) == 3
