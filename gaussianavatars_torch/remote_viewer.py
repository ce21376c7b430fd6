"""Interactive remote viewer of a training run (the port's counterpart of
the root `remote_viewer.py`; reference remote_viewer.py):

    python -m gaussianavatars_torch.remote_viewer [--host 127.0.0.1]
        [--port 6009] [-W 960] [-H 540] [--radius 1] [--fovy 20]
        [--pause_rendering] [--no_training]

A dearpygui shell over the orbit camera (`viewer/orbit_camera.py`, OpenGL
convention) and the protocol client (`viewer/remote_client.py`) that talks
to `python -m gaussianavatars_torch.train` (or the JAX package's
`train.py`: the wire format is the same). It renders nothing itself, so it
runs on a host without a GPU. `dearpygui` is imported only in `main`; the
command exits with a message when it is missing.
"""

from __future__ import annotations

import math
import sys
import time
from argparse import ArgumentParser

import numpy as np

from gaussianavatars_torch.viewer.orbit_camera import OrbitCamera
from gaussianavatars_torch.viewer.remote_client import (
    RemoteRenderClient,
    ViewRequest,
)


def main(argv=None):
    parser = ArgumentParser(description="Remote viewer")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=6009)
    parser.add_argument("-W", type=int, default=960)
    parser.add_argument("-H", type=int, default=540)
    parser.add_argument("--radius", type=float, default=1.0)
    parser.add_argument("--fovy", type=float, default=20.0)
    parser.add_argument("--pause_rendering", action="store_true")
    parser.add_argument("--no_training", action="store_true")
    args = parser.parse_args(argv)

    try:
        import dearpygui.dearpygui as dpg
    except ImportError:
        print("the remote viewer needs dearpygui; drive "
              "gaussianavatars_torch.viewer.remote_client headless without "
              "it")
        sys.exit(1)

    cam = OrbitCamera(args.W, args.H, r=args.radius, fovy=args.fovy,
                      convention="opengl")
    client = RemoteRenderClient(args.host, args.port)
    state = {
        "training": not args.no_training,
        "pause": args.pause_rendering,
        "timestep": 0,
        "num_timesteps": 1,
        "buffer": np.ones((args.H, args.W, 3), np.float32),
        "drag_begin": None,
    }

    dpg.create_context()
    with dpg.texture_registry(show=False):
        dpg.add_raw_texture(
            args.W, args.H, state["buffer"], format=dpg.mvFormat_Float_rgb,
            tag="_texture",
        )
    with dpg.window(tag="_primary", width=args.W, height=args.H):
        dpg.add_image("_texture")
    dpg.set_primary_window("_primary", True)

    with dpg.window(label="Control", width=300, pos=(10, 10)):
        dpg.add_checkbox(label="train", default_value=state["training"],
                         tag="_chk_train")
        dpg.add_checkbox(label="pause rendering",
                         default_value=state["pause"], tag="_chk_pause")
        dpg.add_checkbox(label="show splatting", default_value=True,
                         tag="_checkbox_show_splatting")
        dpg.add_checkbox(label="show mesh", default_value=False,
                         tag="_checkbox_show_mesh")
        dpg.add_checkbox(label="original mesh", default_value=False,
                         tag="_checkbox_use_original_mesh")
        dpg.add_slider_float(label="mesh opacity", default_value=0.5,
                             min_value=0.0, max_value=1.0,
                             tag="_slider_mesh_opacity")
        dpg.add_slider_float(label="scaling", default_value=1.0,
                             min_value=0.01, max_value=2.0,
                             tag="_slider_scaling_modifier")
        dpg.add_slider_int(label="timestep", default_value=0, min_value=0,
                           max_value=0, tag="_slider_timestep")
        dpg.add_text("points: ?", tag="_log_num_points")

    def on_drag(sender, app_data):
        dx, dy = app_data[1], app_data[2]
        cam.orbit_x(-dy * 0.005)
        cam.orbit_y(-dx * 0.005)

    def on_wheel(sender, app_data):
        cam.scale(app_data)

    def on_mdrag(sender, app_data):
        cam.pan(dx=app_data[1] * 0.05, dy=app_data[2] * 0.05)

    with dpg.handler_registry():
        dpg.add_mouse_drag_handler(
            button=dpg.mvMouseButton_Left, callback=on_drag)
        dpg.add_mouse_wheel_handler(callback=on_wheel)
        dpg.add_mouse_drag_handler(
            button=dpg.mvMouseButton_Middle, callback=on_mdrag)

    dpg.create_viewport(title="GaussianAvatars Remote Viewer (PyTorch)",
                        width=args.W + 20, height=args.H + 40)
    dpg.setup_dearpygui()
    dpg.show_viewport()

    while dpg.is_dearpygui_running():
        if client.socket is None:
            if not client.connect(retries=1):
                time.sleep(0.5)
                dpg.render_dearpygui_frame()
                continue
        try:
            if dpg.get_value("_chk_pause"):
                client.request_pause(dpg.get_value("_chk_train"))
            else:
                req = ViewRequest(
                    width=args.W, height=args.H,
                    fovx=math.radians(cam.fovx),
                    fovy=math.radians(cam.fovy),
                    znear=cam.znear, zfar=cam.zfar,
                    world_view_transform=cam.world_view_transform,
                    full_proj_transform=cam.full_proj_transform,
                    timestep=dpg.get_value("_slider_timestep"),
                    do_training=dpg.get_value("_chk_train"),
                    scaling_modifier=dpg.get_value("_slider_scaling_modifier"),
                    show_splatting=dpg.get_value("_checkbox_show_splatting"),
                    show_mesh=dpg.get_value("_checkbox_show_mesh"),
                    mesh_opacity=dpg.get_value("_slider_mesh_opacity"),
                    use_original_mesh=dpg.get_value(
                        "_checkbox_use_original_mesh"),
                )
                img, stats = client.request_view(req)
                if img is not None:
                    state["buffer"][:] = img.astype(np.float32) / 255.0
                    dpg.set_value("_texture", state["buffer"])
                dpg.configure_item(
                    "_slider_timestep",
                    max_value=stats["num_timesteps"] - 1)
                dpg.set_value(
                    "_log_num_points", f"points: {stats['num_points']}")
        except Exception as exc:  # noqa: BLE001  (reconnect on any failure)
            print("communication interrupted:", exc)
            client.close()
            time.sleep(1)
        dpg.render_dearpygui_frame()

    dpg.destroy_context()
    client.close()


if __name__ == "__main__":
    main()
