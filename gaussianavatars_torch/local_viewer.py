"""Interactive local viewer of a trained avatar (the port's counterpart of
the root `local_viewer.py`; reference local_viewer.py):

    python -m gaussianavatars_torch.local_viewer --point_path <ply>
        [--motion_path <npz>] [-W 960] [-H 540] [--radius 1] [--fovy 20]
        [--device cuda]

`LocalViewerCore` loads a `point_cloud.ply` (with the `flame_param.npz`
beside it, FLAME-bound; its FLAME head from $FLAME_ASSET_DIR) on the
device and renders it through `train.loop.make_render_fn` from an orbit
camera (`viewer/orbit_camera.py`, OpenCV convention), with FLAME
expression and pose overrides, the mesh overlay, a scaling modifier,
keyframes interpolated into a trajectory (scipy), playback, recording and
screenshots (PNG through `utils/png.py`; an mp4 when `ffmpeg` is on the
PATH). It needs no display: scripts and tests drive it headless.

`main` is the dearpygui shell over it. `dearpygui` is imported only there,
and the command exits with a message when it is missing.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import time
from argparse import ArgumentParser
from pathlib import Path

import numpy as np
import torch

from gaussianavatars_torch.config import PipelineConfig
from gaussianavatars_torch.data.cameras import MiniCam
from gaussianavatars_torch.device import resolve_device
from gaussianavatars_torch.models.flame_gaussians import FlameGaussianModel
from gaussianavatars_torch.models.gaussians import GaussianModel
from gaussianavatars_torch.render.mesh_renderer import rasterize_mesh
from gaussianavatars_torch.train.loop import camera_arrays, make_render_fn
from gaussianavatars_torch.utils.png import write_png
from gaussianavatars_torch.viewer.orbit_camera import OrbitCamera


class LocalViewerCore:
    """The viewer without its UI: model, render, overrides, keyframes."""

    def __init__(self, point_path: str, sh_degree: int = 3,
                 motion_path=None, width: int = 960, height: int = 540,
                 radius: float = 1.0, fovy: float = 20.0,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.width, self.height = width, height
        self.cam = OrbitCamera(width, height, r=radius, fovy=fovy,
                               convention="opencv")
        if (Path(point_path).parent / "flame_param.npz").exists():
            self.model = FlameGaussianModel.from_assets(sh_degree,
                                                        device=self.device)
            self.model.load_ply(point_path, motion_path=motion_path)
        else:
            self.model = GaussianModel(sh_degree, device=self.device)
            self.model.load_ply(point_path)
        self.bound = self.model.binding is not None
        self.pipe = PipelineConfig()
        self._render_fns = {}
        self.timestep = 0
        self.param_overrides: dict = {}
        self.keyframes: list[dict] = []
        self.playing = False

    # ---- rendering --------------------------------------------------------

    def camera(self) -> MiniCam:
        return MiniCam(
            width=self.width, height=self.height,
            fovx=math.radians(self.cam.fovx),
            fovy=math.radians(self.cam.fovy),
            znear=self.cam.znear, zfar=self.cam.zfar,
            world_view_transform=self.cam.world_view_transform.T,
            full_proj_transform=self.cam.full_proj_transform.T,
            timestep=self.timestep)

    def flame_param(self) -> dict:
        """The model's FLAME parameters with the slider overrides."""
        if not self.bound:
            return {}
        param = dict(self.model.flame_param)
        for k, v in self.param_overrides.items():
            param[k] = torch.as_tensor(np.asarray(v, np.float32),
                                       device=self.device)
        return param

    @torch.no_grad()
    def render_tensor(self, show_mesh: bool = False,
                      mesh_opacity: float = 0.5,
                      scaling_modifier: float = 1.0) -> torch.Tensor:
        """The frame [3, H, W] in [0, 1], on the device."""
        params = self.camera().to_params(device=self.device)
        key = (self.width, self.height, self.model.active_sh_degree)
        if key not in self._render_fns:
            self._render_fns[key] = make_render_fn(
                self.model, self.pipe, self.width, self.height,
                self.model.active_sh_degree)
        flame_param = self.flame_param()
        gauss = self.model.params
        if scaling_modifier != 1.0:
            # scales are stored in log space: adding log(m) multiplies the
            # activated scales by m (the viewer's scaling-modifier slider)
            gauss = gauss._replace(scaling=gauss.scaling + math.log(
                max(scaling_modifier, 1e-6)))
        out = self._render_fns[key](
            gauss, flame_param, self.model.binding, camera_arrays(params),
            torch.ones(3, dtype=torch.float32, device=self.device),
            self.timestep).image.clamp(0.0, 1.0)
        if show_mesh and self.bound:
            verts = self.model.verts_at(flame_param, self.timestep)
            rgb, alpha, _, _ = rasterize_mesh(
                verts[0], self.model.flame_model.faces, params)
            rgb, alpha = rgb.permute(2, 0, 1), alpha[None]
            out = (rgb * alpha * mesh_opacity
                   + out * (alpha * (1 - mesh_opacity) + (1 - alpha)))
        return out

    def render(self, show_mesh: bool = False, mesh_opacity: float = 0.5,
               scaling_modifier: float = 1.0) -> np.ndarray:
        """The frame as a host array [3, H, W] float32 in [0, 1]."""
        return self.render_tensor(show_mesh, mesh_opacity,
                                  scaling_modifier).cpu().numpy()

    def set_expression(self, index: int, value: float):
        """Live FLAME slider (reference update_mesh_by_param_dict): the
        loaded expressions with column `index` set to `value` at every
        timestep, in place of any earlier expression override (as the JAX
        package's viewer does)."""
        expr = self.model.flame_param["expr"].cpu().numpy().copy()
        expr[:, index] = value
        self.param_overrides["expr"] = expr

    def set_pose(self, key: str, axis: int, value: float):
        pose = self.model.flame_param[key].cpu().numpy().copy()
        pose[:, axis] = value
        self.param_overrides[key] = pose

    # ---- keyframe timeline -------------------------------------------------

    def add_keyframe(self):
        # trajectory.json stores xyzw quaternions (scipy's order, the
        # reference viewer's export format); the camera holds wxyz
        self.keyframes.append({
            "rotation": np.roll(self.cam.orientation, -1).tolist(),
            "look_at": list(map(float, self.cam.look_at)),
            "radius": float(self.cam.radius),
            "fovy": float(self.cam.fovy),
            "timestep": int(self.timestep),
        })

    def interpolate_trajectory(self, n_frames: int) -> list[dict]:
        """`n_frames` frames through the keyframes: rotations by slerp, the
        rest by cubic splines (reference local_viewer.py keyframe
        playback)."""
        from scipy.interpolate import CubicSpline
        from scipy.spatial.transform import Rotation, Slerp

        if len(self.keyframes) < 2:
            return [self.keyframes[0]] * n_frames if self.keyframes else []
        ts = np.linspace(0, len(self.keyframes) - 1, n_frames)
        keys = np.arange(len(self.keyframes))
        slerp = Slerp(keys, Rotation.from_quat(
            np.array([k["rotation"] for k in self.keyframes])))

        def spline(name):
            return CubicSpline(keys, np.array([k[name]
                                               for k in self.keyframes]))

        look, radius, fovy, tstep = (spline(n) for n in (
            "look_at", "radius", "fovy", "timestep"))
        return [{"rotation": slerp(t).as_quat().tolist(),
                 "look_at": look(t).tolist(),
                 "radius": float(radius(t)),
                 "fovy": float(fovy(t)),
                 "timestep": int(round(float(tstep(t))))} for t in ts]

    def export_trajectory(self, path: str, n_frames: int = 125):
        with open(path, "w") as f:
            json.dump({"keyframes": self.keyframes,
                       "frames": self.interpolate_trajectory(n_frames)},
                      f, indent=2)

    def apply_frame(self, frame: dict):
        self.cam.orientation = np.roll(np.asarray(frame["rotation"]), 1)
        self.cam.look_at = np.asarray(frame["look_at"])
        self.cam.radius = frame["radius"]
        self.cam.fovy = frame["fovy"]
        self.timestep = min(frame["timestep"], self.model.num_timesteps - 1)

    def clear_keyframes(self):
        self.keyframes = []

    def reset_overrides(self):
        """Drop every FLAME slider override."""
        self.param_overrides = {}

    # ---- playback and recording (reference local_viewer.py:122-288,
    # 533-549) -------------------------------------------------------------

    def start_playback(self, n_frames: int = 125, loop: bool = True,
                       record_dir=None) -> bool:
        """Step through the interpolated trajectory, one frame per
        `tick_playback`. With `record_dir`, every played frame is written
        there as a PNG, and an mp4 assembled when playback ends."""
        self._frames = self.interpolate_trajectory(n_frames)
        self._play_idx = 0
        self._play_loop = loop and record_dir is None
        self._record_dir = record_dir
        self.playing = bool(self._frames)
        return self.playing

    def stop_playback(self):
        self.playing = False
        if getattr(self, "_record_dir", None):
            self._finish_recording()

    def tick_playback(self):
        """Apply the next frame (and record it); returns its index, or None
        when not playing."""
        if not self.playing:
            return None
        idx = self._play_idx
        self.apply_frame(self._frames[idx])
        if self._record_dir is not None:
            self.save_image(os.path.join(self._record_dir, f"{idx:05d}.png"))
        self._play_idx += 1
        if self._play_idx >= len(self._frames):
            if self._play_loop:
                self._play_idx = 0
            else:
                self.stop_playback()
        return idx

    def _finish_recording(self):
        out_dir, self._record_dir = self._record_dir, None
        _frames_to_video(out_dir, "playback.mp4")

    def save_image(self, path: str, **render_kwargs):
        img = self.render(**render_kwargs)
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        write_png(path, np.clip(img * 255 + 0.5, 0, 255).astype(
            np.uint8).transpose(1, 2, 0))

    def render_trajectory_video(self, out_dir: str, n_frames: int = 125):
        for i, frame in enumerate(self.interpolate_trajectory(n_frames)):
            self.apply_frame(frame)
            self.save_image(os.path.join(out_dir, f"{i:05d}.png"))
        _frames_to_video(out_dir, "trajectory.mp4")


def _frames_to_video(out_dir: str, name: str):
    """`<out_dir>/<name>` from its %05d.png frames at 25 fps, when ffmpeg is
    on the PATH; without it the PNG frames are the result."""
    if shutil.which("ffmpeg"):
        subprocess.run(["ffmpeg", "-y", "-framerate", "25", "-i",
                        f"{out_dir}/%05d.png", "-pix_fmt", "yuv420p",
                        f"{out_dir}/{name}"], check=False,
                       capture_output=True)


JOINTS = ("rotation", "neck_pose", "jaw_pose", "eyes_pose")
N_EXPR = 10


def main(argv=None):
    parser = ArgumentParser(description="Local viewer")
    parser.add_argument("--point_path", required=True)
    parser.add_argument("--motion_path", default=None)
    parser.add_argument("--sh_degree", type=int, default=3)
    parser.add_argument("-W", type=int, default=960)
    parser.add_argument("-H", type=int, default=540)
    parser.add_argument("--radius", type=float, default=1.0)
    parser.add_argument("--fovy", type=float, default=20.0)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    try:
        import dearpygui.dearpygui as dpg
    except ImportError:
        print("the local viewer's UI needs dearpygui; "
              "gaussianavatars_torch.local_viewer.LocalViewerCore renders "
              "headless without it")
        sys.exit(1)
    core = LocalViewerCore(args.point_path, args.sh_degree, args.motion_path,
                           args.W, args.H, args.radius, args.fovy,
                           device=args.device)

    buf = np.ones((args.H, args.W, 3), np.float32)
    dpg.create_context()
    with dpg.texture_registry(show=False):
        dpg.add_raw_texture(args.W, args.H, buf,
                            format=dpg.mvFormat_Float_rgb, tag="_texture")
    with dpg.window(tag="_primary"):
        dpg.add_image("_texture")
    dpg.set_primary_window("_primary", True)

    def n_axes(joint):
        return 6 if joint == "eyes_pose" else 3

    def reset_sliders():
        core.reset_overrides()
        for i in range(N_EXPR):
            dpg.set_value(f"_e{i}", 0.0)
        for joint in JOINTS:
            for ax in range(n_axes(joint)):
                dpg.set_value(f"_p_{joint}_{ax}", 0.0)

    def add_keyframe():
        core.add_keyframe()
        dpg.set_value("_kf_count", f"keyframes: {len(core.keyframes)}")

    def clear_keyframes():
        core.clear_keyframes()
        dpg.set_value("_kf_count", "keyframes: 0")

    def toggle_play():
        if core.playing:
            core.stop_playback()
            return
        rec = None
        if dpg.get_value("_record"):
            rec = f"playback_{time.time():.0f}"
            os.makedirs(rec, exist_ok=True)
        core.start_playback(dpg.get_value("_nframes"), record_dir=rec)

    with dpg.window(label="Control", width=360, height=args.H - 20,
                    pos=(10, 10)):
        dpg.add_slider_int(label="timestep", min_value=0,
                           max_value=core.model.num_timesteps - 1, tag="_t")
        dpg.add_checkbox(label="show mesh", tag="_mesh")
        dpg.add_slider_float(label="mesh opacity", default_value=0.5,
                             min_value=0, max_value=1, tag="_mop")
        dpg.add_slider_float(label="scaling modifier", default_value=1.0,
                             min_value=0, max_value=1, tag="_smod")
        with dpg.collapsing_header(label="FLAME joints", default_open=True):
            for joint in JOINTS:
                with dpg.tree_node(label=joint,
                                   default_open=(joint == "jaw_pose")):
                    for ax in range(n_axes(joint)):
                        dpg.add_slider_float(
                            label=f"{joint}[{ax}]", default_value=0.0,
                            min_value=-0.5, max_value=0.5,
                            tag=f"_p_{joint}_{ax}")
        with dpg.collapsing_header(label="expression", default_open=True):
            for i in range(N_EXPR):
                dpg.add_slider_float(label=f"expr {i}", default_value=0.0,
                                     min_value=-3, max_value=3, tag=f"_e{i}")
        dpg.add_button(label="reset sliders", callback=reset_sliders)
        with dpg.collapsing_header(label="keyframe timeline",
                                   default_open=True):
            dpg.add_text("keyframes: 0", tag="_kf_count")
            dpg.add_button(label="add keyframe", callback=add_keyframe)
            dpg.add_button(label="clear keyframes", callback=clear_keyframes)
            dpg.add_input_int(label="frames", default_value=125,
                              tag="_nframes")
            dpg.add_checkbox(label="record to video", tag="_record")
            dpg.add_button(label="play / pause", callback=toggle_play)
            dpg.add_button(
                label="export trajectory",
                callback=lambda: core.export_trajectory("trajectory.json"))
        dpg.add_button(
            label="screenshot",
            callback=lambda: core.save_image(f"capture_{time.time():.0f}.png"))

    def on_drag(sender, app_data):
        core.cam.orbit_x(-app_data[2] * 0.005)
        core.cam.orbit_y(-app_data[1] * 0.005)

    with dpg.handler_registry():
        dpg.add_mouse_drag_handler(button=dpg.mvMouseButton_Left,
                                   callback=on_drag)
        dpg.add_mouse_wheel_handler(callback=lambda s, a: core.cam.scale(a))
        dpg.add_mouse_drag_handler(
            button=dpg.mvMouseButton_Middle,
            callback=lambda s, a: core.cam.pan(dx=a[1] * 0.05, dy=a[2] * 0.05))

    dpg.create_viewport(title="GaussianAvatars Local Viewer (PyTorch)",
                        width=args.W + 20, height=args.H + 40)
    dpg.setup_dearpygui()
    dpg.show_viewport()

    while dpg.is_dearpygui_running():
        if core.tick_playback() is not None:
            dpg.set_value("_t", core.timestep)
        else:
            core.timestep = dpg.get_value("_t")
            if core.bound:
                for joint in JOINTS:
                    for ax in range(n_axes(joint)):
                        v = dpg.get_value(f"_p_{joint}_{ax}")
                        if v != 0.0:
                            core.set_pose(joint, ax, v)
                for i in range(N_EXPR):
                    v = dpg.get_value(f"_e{i}")
                    if v != 0.0:
                        core.set_expression(i, v)
        img = core.render(show_mesh=dpg.get_value("_mesh"),
                          mesh_opacity=dpg.get_value("_mop"),
                          scaling_modifier=dpg.get_value("_smod"))
        buf[:] = img.transpose(1, 2, 0)
        dpg.set_value("_texture", buf)
        dpg.render_dearpygui_frame()

    dpg.destroy_context()


if __name__ == "__main__":
    main()
