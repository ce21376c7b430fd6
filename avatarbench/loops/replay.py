"""Loop kind "replay": a closed loop of one viewer. Frame i drives FLAME
at timestep i mod `timesteps` of a smooth motion and the camera at frame i
of an orbit, renders on the background, converts to the wire's uint8 and
copies it to the host. The comparison reads a seeded sample of the frames
that the measured window delivered."""

from __future__ import annotations

import numpy as np
import torch

from avatarbench import check, scene, traffic
from avatarbench.reference import render as ref_render


class ReplayOrbit(traffic.Loop):

    def __init__(self, cfg, tr, limits, seed, device):
        super().__init__(cfg, tr, limits, seed, device)
        self.period = tr["period"]
        self.cams = [scene.camera(scene.orbit(i, self.period, tr["yaw_deg"],
                                              tr["dist"]),
                                  self.width, self.height, tr["fovx"],
                                  device) for i in range(self.period)]
        from avatarbench.program import camera_arrays, to_wire
        self.to_wire = to_wire
        self.cam_arrays = [camera_arrays(c) for c in self.cams]
        self.render = self.prog.render_fn(self.width, self.height)
        m = self.prog.model
        self.model_args = (m.params, getattr(m, "flame_param", None),
                           m.binding)
        rng = np.random.default_rng([int(seed) % (1 << 63), 9])
        self.sample = set(rng.choice(tr["check_from"], tr["check_frames"],
                                     replace=False).tolist())
        self.kept = {}
        self.frame_index = 0

    def _drop_program_state(self):
        self.render = self.model_args = self.cam_arrays = None

    def key(self, i: int):
        return i % self.inputs.timesteps, i % self.period

    def iteration(self, mark=None):
        i = self.frame_index
        t, c = self.key(i)
        params, flame, binding = self.model_args
        out = self.render(params, flame, binding, self.cam_arrays[c],
                          self.bg, t, mark=mark)
        frame = self.to_wire(out.image)
        if mark is not None:
            mark("delivered")
        if self.recording and i in self.sample and i not in self.kept:
            self.kept[i] = frame
        self.frame_index += 1
        return frame

    def ready(self) -> bool:
        return len(self.kept) == len(self.sample)

    def warm_up(self):
        """`warmup_frames` frames; the window starts again at frame 0."""
        for _ in range(self.tr["warmup_frames"]):
            self.iteration()
        traffic.sync(self.device)
        self.frame_index = 0

    def seek(self, k0: int):
        self.frame_index = k0

    def profile_start(self) -> int:
        return self.frame_index

    def work(self, k0: int, n: int) -> list:
        """The work of frames k0 .. k0 + n - 1, each (timestep, camera)
        counted once by the reference's binning."""
        inp = self.inputs
        out, memo = [], {}
        for i in range(k0, k0 + n):
            key = self.key(i)
            if key not in memo:
                t, c = key
                memo[key] = inp.work(inp.params, inp.flame, t, self.cams[c],
                                     self.bg, self.cfg["tile_size"])
            out.append(memo[key])
        return out

    # -- the comparison -----------------------------------------------------

    def program_readings(self) -> dict:
        return self.kept

    def prepare_control(self):
        self.kept = {i: None for i in self.sample}

    def reference_frame(self, i: int) -> np.ndarray:
        """The reference's uint8 frame i (truncated clip(x * 255))."""
        inp = self.inputs
        t, c = self.key(i)
        with torch.no_grad():
            res, _ = ref_render.render(
                inp.params, inp.binding, inp.frames(inp.flame, t),
                traffic.ref_camera(self.cams[c]), self.bg,
                tile=self.cfg["tile_size"])
            img = (res.image * 255.0).clamp(0.0, 255.0).to(torch.uint8)
            return img.permute(1, 2, 0).cpu().numpy()

    def reference_readings(self, fault=None) -> dict:
        return {i: self.reference_frame(i) for i in sorted(self.kept)}

    def compare(self, prog: dict, ref: dict) -> dict:
        return check.frame_numbers(prog, ref)


LOOP = ReplayOrbit
