"""Loop kind "train_scene": the closed training loop of `loops/train.py`
(one view an iteration in seeded shuffled epochs, the state restored at
each epoch's start, the window's own steps read for the comparison) on an
unbound 3DGS scene made by `scene3dgs.scene_params` from the
configuration's `scene` group, in place of the head-sized cloud.
"""

from __future__ import annotations

import json
import tempfile
import time

import torch

from avatarbench import scene3dgs, traffic
from avatarbench.loops.train import TrainViews


class SceneInputs(traffic.Inputs):
    """The inputs of an unbound scene: its Gaussians and no binding."""

    def __init__(self, cfg: dict, tr: dict, seed: int, device, tmpdir: str):
        self.bound = False
        self.head = self.flame = self.motion = self.paths = None
        self.timesteps = 1
        self.params = scene3dgs.scene_params(seed, cfg["gaussians"],
                                             cfg["scene"], traffic.SH_COEFFS,
                                             device)
        self.binding = None


class SceneLoop(traffic.Loop):
    """`traffic.Loop`'s set-up with `SceneInputs`."""

    def __init__(self, cfg: dict, tr: dict, limits: dict, seed: int, device):
        self.cfg, self.tr, self.limits = cfg, tr, limits
        self.seed, self.device = seed, device
        self.width, self.height = tr["width"], tr["height"]
        self.tmp = tempfile.TemporaryDirectory(prefix="avatarbench_")
        self.inputs = SceneInputs(cfg, tr, seed, device, self.tmp.name)
        self.prog = self.inputs.program(cfg, device, self.tmp.name)
        self.bg = torch.tensor(tr["background"], dtype=torch.float32,
                               device=device)
        self.recording = False
        self.stream_log = []


class TrainScene(TrainViews, SceneLoop):

    def reference_readings(self, fault=None) -> dict:
        """`TrainViews.reference_readings`, its seconds printed as one JSON
        line (the reference's steps at the scene's size take long)."""
        t0 = time.perf_counter()
        out = super().reference_readings(fault)
        print(json.dumps(dict(what="reference", fault=fault,
                              seconds=time.perf_counter() - t0)), flush=True)
        return out


LOOP = TrainScene
