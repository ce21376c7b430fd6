"""The render's sync-free prefix as one CUDA graph.

From FLAME at the timestep to the projected Gaussians (the face frames, the
binding chain, the pipeline options' precomputed colours and covariances,
the projection with SH) a render has fixed shapes and no host sync: a chain
of some 500 small kernels that the host would otherwise issue one by one.
`PrefixGraph` captures that chain once and replays it as one launch; the
binning, the gather, K1 and the composite stay eager.

A capture bakes in what makes its key (`PrefixGraph.key`): the device, the
image size, the camera's fields of view, `scaling_modifier`, the SH degree
and the pipeline options, and the address, shape, stride and dtype of every
tensor the graph reads in place (the Gaussian parameters, `binding`, the
FLAME parameters, the FLAME model's buffers). Adam's in-place updates keep
the key, so a viewer served during training sees the current values;
densification, pruning or another model change it. What varies from frame
to frame goes in through static buffers written on the device before each
replay: the timestep as an int64 index, the camera's three matrices. No
host memory is read per frame.

The policy follows the calls: a call whose key is the previous call's
captures the graph (once) and replays it; a call with a new key drops the
graph, and with it its memory pool, and renders eagerly, so a one-shot
render never pays a capture. A graph keeps its pool (the prefix's
intermediates and outputs) while its render function lives and its key
holds. The replay issues the eager path's kernels in the eager order, so
its outputs are the eager path's bits. They are overwritten at the next
replay: the render clones what it hands out.
"""

from __future__ import annotations

import operator
from typing import Callable, Optional

import torch

from gaussianavatars_torch.models.flame_gaussians import TIMESTEP_KEYS
from gaussianavatars_torch.ops import projection
from gaussianavatars_torch.ops.projection import (
    CameraParams,
    ProjectedGaussians,
)
from gaussianavatars_torch.utils import trace
from gaussianavatars_torch.utils.trace import span

_CAMERA_TENSORS = ("viewmatrix", "projmatrix", "campos")


def _layout(t: torch.Tensor) -> tuple:
    return t.data_ptr(), tuple(t.shape), t.stride(), t.dtype


def _on_current_card(t: torch.Tensor) -> bool:
    """Whether `t` lies on the current CUDA device (where a graph captured
    and replayed on the current stream runs)."""
    return t.is_cuda and t.get_device() == torch.cuda.current_device()


def _timestep_index(flame_param: dict, timestep) -> int:
    """`timestep` as the row the eager indexing would read; an index out
    of range raises here, as eager indexing does, and not on the device."""
    t = operator.index(timestep)
    n = min(flame_param[k].shape[0] for k in TIMESTEP_KEYS)
    if not -n <= t < n:
        raise IndexError(f"timestep {t} is out of range for {n} timesteps")
    return t % n


class _Captured:
    """One captured prefix: its key, its static inputs (the timestep index
    and the camera's matrices), the graph and its static outputs, and
    `fused`, the projection kernels' forward launches it holds."""

    def __init__(self, key, project: Callable, params, flame_param, binding,
                 camera: CameraParams, timestep: int, scaling_modifier):
        self.key = key
        dev = params.xyz.device
        self.timestep = (torch.zeros(1, dtype=torch.int64, device=dev)
                         if binding is not None else None)
        self.camera = camera._replace(**{
            k: torch.empty_like(getattr(camera, k)) for k in _CAMERA_TENSORS})
        self.write(camera, timestep)

        def run():
            return project(params, flame_param, binding, self.camera,
                           self.timestep, scaling_modifier)

        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            run()               # lazy set-up (library handles) off the graph
        self.graph = torch.cuda.CUDAGraph()
        launches = projection.project_fwd_cuda.launches
        # thread_local: the loader's and the viewer's threads may use the
        # card while this thread captures
        with torch.cuda.graph(self.graph, stream=stream,
                              capture_error_mode="thread_local"):
            self.out: ProjectedGaussians = run()
        self.fused = projection.project_fwd_cuda.launches - launches
        torch.cuda.current_stream(dev).wait_stream(stream)

    def write(self, camera: CameraParams, timestep: int):
        if self.timestep is not None:
            self.timestep.fill_(timestep)
        for k in _CAMERA_TENSORS:
            getattr(self.camera, k).copy_(getattr(camera, k))

    def replay(self, camera: CameraParams,
               timestep: int) -> ProjectedGaussians:
        self.write(camera, timestep)
        self.graph.replay()
        return self.out


class PrefixGraph:
    """The captured prefix of one render function.

    `project(params, flame_param, binding, camera, timestep,
    scaling_modifier)` is the prefix as the eager path computes it, with
    `timestep` an int or the graph's [1] int64 index, and `binding` None
    for an unbound model.
    """

    def __init__(self, model, project: Callable, sh_degree: int,
                 options: tuple):
        self.model, self.project = model, project
        self.sh_degree, self.options = sh_degree, options
        self.last_key = None
        self.captured: Optional[_Captured] = None

    def key(self, params, flame_param, binding, camera: CameraParams,
            scaling_modifier) -> tuple:
        """Everything a capture bakes in (the module's docstring)."""
        tensors = list(params)
        names = ()
        if binding is not None:
            names = tuple(sorted(flame_param))
            tensors += [binding, *(flame_param[k] for k in names),
                        *self.model.flame_model.buffers()]
        return (params.xyz.device, camera.width, camera.height,
                float(camera.tan_fovx), float(camera.tan_fovy),
                float(scaling_modifier), self.sh_degree, self.options, names,
                tuple(_layout(t) for t in tensors),
                tuple((tuple(getattr(camera, k).shape),
                       getattr(camera, k).dtype) for k in _CAMERA_TENSORS))

    def drop(self):
        """Drop the graph and its static tensors; their pool goes back to
        the allocator."""
        if self.captured is not None:
            self.captured.graph.reset()
            self.captured = None

    def __call__(self, params, flame_param, binding, camera: CameraParams,
                 timestep, scaling_modifier) -> Optional[ProjectedGaussians]:
        """The projected Gaussians from the graph, or None where this call
        renders eagerly: tensors off the card (or on a card other than the
        current one), a key unlike the previous call's."""
        if not _on_current_card(params.xyz):
            return None
        key = self.key(params, flame_param, binding, camera, scaling_modifier)
        if self.captured is None or self.captured.key != key:
            self.drop()
            if key != self.last_key:
                self.last_key = key
                return None
        t = (_timestep_index(flame_param, timestep) if binding is not None
             else 0)
        with span("graph_replay"):
            if self.captured is None:
                trace.count(trace.GRAPH_CAPTURES)
                self.captured = _Captured(key, self.project, params,
                                          flame_param, binding, camera, t,
                                          scaling_modifier)
            trace.count(trace.GRAPH_REPLAYS)
            # the projection's counter, as the eager path counts it
            if self.captured.fused:
                trace.count(trace.PROJECTIONS_FUSED, self.captured.fused)
            return self.captured.replay(camera, t)
