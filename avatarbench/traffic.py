"""What every loop of the traffic generator shares. A traffic file
(`traffic/<mix>.json`) names a loop `kind` and sets its sizes; the loop's
code is the file `loops/<kind>.py`, found by that name
(`harness.make_loop`), whose `LOOP` is a subclass of `Loop`. A new kind of
loop is a new file there and a traffic file that names it.

Every loop makes its inputs from the seed, hands copies to the program
and the same inputs to the reference, runs its iterations through the
program's own entry, keeps what the comparison needs from the iterations
of the measured window, and frees the program before the reference runs.
"""

from __future__ import annotations

import gc
import os
import tempfile
import time

import torch

from avatarbench import scene
from avatarbench.reference import flame as ref_flame
from avatarbench.reference import render as ref_render
from avatarbench.reference.train import set_tf32

SH_COEFFS = 16


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def ref_camera(cam: dict) -> ref_render.Camera:
    return ref_render.Camera(
        viewmatrix=cam["viewmatrix"].clone(),
        projmatrix=cam["projmatrix"].clone(), campos=cam["campos"].clone(),
        tan_fovx=cam["tan_fovx"], tan_fovy=cam["tan_fovy"],
        width=cam["width"], height=cam["height"])


class Inputs:
    """A configuration's seeded inputs: the reference head and FLAME
    parameters (bound), the raw Gaussian parameters and the binding."""

    def __init__(self, cfg: dict, tr: dict, seed: int, device, tmpdir: str):
        self.bound = cfg["kind"] == "bound"
        self.head = self.flame = self.motion = self.paths = None
        self.timesteps = tr["timesteps"] if self.bound else 1
        if self.bound:
            arrays = scene.flame_arrays(seed)
            self.paths = scene.write_flame_files(arrays, tmpdir)
            self.motion = scene.flame_motion(seed, self.timesteps,
                                             tr["motion"])
            self.head = ref_flame.FlameHead(arrays, device)
            self.flame = scene.flame_tensors(
                self.motion, self.head.v_template.shape[0], device)
            with torch.no_grad():
                scale = ref_flame.face_frames(self.head.verts(self.flame, 0),
                                              self.head.faces)["scale"]
            self.params, self.binding = scene.avatar_params(
                seed, self.head.num_faces, scale, cfg["gaussians_per_face"],
                SH_COEFFS, device)
        else:
            self.params = scene.cloud_params(seed, cfg["gaussians"],
                                             SH_COEFFS, device)
            self.binding = None

    def program(self, cfg, device, tmpdir):
        from avatarbench.program import Program
        return Program(cfg, self.params, self.binding, device, self.paths,
                       self.motion, os.path.join(tmpdir, "none.pkl"))

    def frames(self, flame: dict, t: int):
        if not self.bound:
            return None
        return ref_flame.face_frames(self.head.verts(flame, t),
                                     self.head.faces)

    def flame_elems(self) -> int:
        if not self.bound:
            return 0
        return sum(self.flame[k].numel() for k in ref_flame.FINETUNE_KEYS)

    def shapes(self) -> dict:
        return dict(gaussians=self.params["xyz"].shape[0],
                    vertices=0 if not self.bound
                    else self.head.v_template.shape[0],
                    faces=0 if not self.bound else self.head.num_faces,
                    flame_elems=self.flame_elems(), bound=self.bound)

    def work(self, params: dict, flame, t: int, cam: dict, bg,
             tile: int) -> dict:
        """One view's work (`work/counts.py`) at the given parameters,
        from the reference's own binning and blend."""
        with torch.no_grad():
            res, _ = ref_render.render(params, self.binding,
                                       self.frames(flame, t),
                                       ref_camera(cam), bg, tile=tile,
                                       count=True)
        return dict(res.work, **self.shapes())


class Loop:
    """What every loop shares: the inputs, the program, the windows.

    A kind of loop defines `iteration(mark)`, `warm_up()`,
    `profile_start()`, `seek(k)`, `work(k0, n)`, `program_readings()`,
    `reference_readings(fault)`, `compare(prog, ref)` and
    `_drop_program_state()`; `FAULTS` names the faults its reference can
    plant for `readings.py`.
    """

    FAULTS: tuple = ()

    def __init__(self, cfg: dict, tr: dict, limits: dict, seed: int, device):
        self.cfg, self.tr, self.limits = cfg, tr, limits
        self.seed, self.device = seed, device
        self.width, self.height = tr["width"], tr["height"]
        self.tmp = tempfile.TemporaryDirectory(prefix="avatarbench_")
        self.inputs = Inputs(cfg, tr, seed, device, self.tmp.name)
        self.prog = self.inputs.program(cfg, device, self.tmp.name)
        self.bg = torch.tensor(tr["background"], dtype=torch.float32,
                               device=device)
        self.recording = False
        self.stream_log = []

    def ready(self) -> bool:
        """Whether the window holds what the comparison reads."""
        return True

    def window(self, seconds: float, mark=None) -> dict:
        """Iterate until `seconds` have passed on the host clock (and the
        comparison's readings are complete), then synchronise:
        (iterations, seconds, per-iteration latencies). What the
        comparison reads is kept from these iterations."""
        sync(self.device)
        n, lat = 0, []
        self.recording = True
        t0 = time.perf_counter()
        while True:
            a = time.perf_counter()
            if mark is not None:
                mark.begin()
            self.iteration(mark)
            b = time.perf_counter()
            lat.append(b - a)
            n += 1
            if b - t0 >= seconds and self.ready():
                break
        sync(self.device)
        elapsed = time.perf_counter() - t0
        self.recording = False
        return dict(n=n, seconds=elapsed, latencies=lat)

    def timed(self, k0: int, n: int) -> float:
        """Seconds of the `n` iterations from `k0`, without tracing."""
        self.seek(k0)
        sync(self.device)
        t0 = time.perf_counter()
        for _ in range(n):
            self.iteration()
        sync(self.device)
        return time.perf_counter() - t0

    def free_program(self):
        """Drop the program and everything it made."""
        self.prog = None
        self._drop_program_state()
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def prepare_control(self):
        """Set what the comparison reads as a window would have."""

    def control_pair(self, fault=None) -> tuple:
        """(program's place, reference) with the reference in the
        program's place: under TF32 (fault None) or with `fault`."""
        self.free_program()
        self.prepare_control()
        ref = self.reference_readings()
        if fault is None:
            set_tf32(True)
        try:
            prog = self.reference_readings(fault=fault)
        finally:
            set_tf32(False)
        return prog, ref

    def close(self):
        self.tmp.cleanup()
