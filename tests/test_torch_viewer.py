"""The port's viewers against the JAX package's, on the CPU:

  * the orbit camera: the same orbit / trackball / scale / pan sequence
    gives the same pose, view and projection matrices and intrinsics as
    JAX's `OrbitCamera` (1e-12, both numpy), and a camera.json saved by
    either loads in the other;
  * the wire protocol: the port's client sends the JAX client's bytes and
    the port's server replies with the JAX server's bytes; the port's
    server serves JAX's client and JAX's server the port's client over
    loopback (every port bound is port 0, every socket and thread has a
    timeout);
  * `training(gui=...)` of both packages on one dataset: a client pauses
    each at its first poll and requests a 32x24 view, then the view with
    the mesh, resumes, and at the second poll (after one step) asks for
    the mesh alone with the original FLAME parameters and with the
    current ones, at both timesteps, then lets go. The frames handed to the server agree within atol 5e-5,
    the wire frames within one level, the stats are equal;
  * `LocalViewerCore` against the root `local_viewer.LocalViewerCore` on
    the avatar `tests/test_local_viewer_core.py` saves: renders with and
    without the mesh, with an expression and a jaw-pose override and at
    scaling modifier 1.5 (atol 5e-5); keyframes, the interpolated
    trajectory and its export (1e-6); playback and recording;
  * both dearpygui shells run frames against a fake `dearpygui`, the local
    one rendering for real, the remote one talking to a real server;
  * both FPS benchmarks (`--n_iter 1 --n_rounds 1 --vis`, on the CPU) write
    the root scripts' frames within 1 level: the demo with --point_path on
    the saved avatar through the orbit camera, the dataset benchmark on
    the model directory the viewer's training run saved.
"""

import json
import math
import os
import socket
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from gaussianavatars_tpu.config import ModelConfig as JaxModelConfig
from gaussianavatars_tpu.config import OptimizationConfig as JaxOpt
from gaussianavatars_tpu.config import PipelineConfig as JaxPipeline
from gaussianavatars_tpu.train.loop import training as jax_training
from gaussianavatars_tpu.viewer import network_gui as jgui
from gaussianavatars_tpu.viewer import orbit_camera as jorbit
from gaussianavatars_tpu.viewer import remote_client as jclient
from gaussianavatars_torch import local_viewer as tviewer
from gaussianavatars_torch import remote_viewer as tremote
from gaussianavatars_torch.config import (
    ModelConfig,
    OptimizationConfig,
    PipelineConfig,
)
from gaussianavatars_torch.train.loop import training
from gaussianavatars_torch.viewer import network_gui as tgui
from gaussianavatars_torch.viewer import orbit_camera as torbit
from gaussianavatars_torch.viewer import remote_client as tclient

from .test_dpg_shells import install_stub_dpg
from .test_torch_blend import one_torch_thread  # noqa: F401
from .torch_fixtures import make_port_avatar_dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 120.0          # any socket read or thread join of these tests
TOL_RENDER = 5e-5        # PERF.md section 2: the port vs JAX's render


# ---- orbit camera -------------------------------------------------------------

def _drive(cam):
    cam.orbit_x(0.3)
    cam.orbit_y(-0.7)
    cam.orbit_z(0.2)
    cam.scale(1.5)
    cam.pan(dx=3.0, dy=-2.0, dz=1.0)
    p = np.array([0.1, 0.2, 0.97])
    q = np.array([-0.3, 0.1, 0.95])
    cam.trackball(p / np.linalg.norm(p), q / np.linalg.norm(q))
    cam.scale(-0.5)
    return cam


def _views(cam):
    return dict(pose=cam.pose, world_view=cam.world_view_transform,
                full_proj=cam.full_proj_transform,
                proj=cam.projection_matrix, intrinsics=cam.intrinsics,
                rotation=cam.rotation_matrix, orientation=cam.orientation,
                fovx=np.asarray(cam.fovx))


@pytest.mark.parametrize("convention", ["opengl", "opencv"])
def test_orbit_camera_matches_jax(tmp_path, convention):
    kw = dict(width=640, height=480, r=2.5, fovy=35.0, convention=convention)
    got = _views(_drive(torbit.OrbitCamera(
        save_path=str(tmp_path / "t.json"), **kw)))
    ref = _views(_drive(jorbit.OrbitCamera(
        save_path=str(tmp_path / "j.json"), **kw)))
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1e-12,
                                   err_msg=k)
    K = np.array([[500.0, 0, 320], [0, 480.0, 240], [0, 0, 1]])
    np.testing.assert_allclose(
        torbit.projection_from_intrinsics(K[None], (480, 640), flip_y=True),
        jorbit.projection_from_intrinsics(K[None], (480, 640), flip_y=True),
        atol=1e-12)


def test_camera_json_loads_across_packages(tmp_path):
    for writer, reader in ((torbit, jorbit), (jorbit, torbit)):
        path = str(tmp_path / f"{writer.__name__}.json")
        cam = _drive(writer.OrbitCamera(64, 48, save_path=path))
        cam.save()
        back = reader.OrbitCamera(64, 48, save_path=path)
        np.testing.assert_allclose(back.pose, cam.pose, atol=1e-12)
        np.testing.assert_allclose(back.look_at, cam.look_at, atol=0)
        assert back.radius == cam.radius and back.fovy == cam.fovy


# ---- wire protocol ------------------------------------------------------------

def _request():
    cam = torbit.OrbitCamera(32, 24, r=2.0, fovy=40.0, convention="opengl",
                             save_path="")
    return dict(width=32, height=24, fovx=math.radians(cam.fovx),
                fovy=math.radians(cam.fovy), znear=cam.znear, zfar=cam.zfar,
                world_view_transform=cam.world_view_transform,
                full_proj_transform=cam.full_proj_transform, timestep=1,
                do_training=False, show_mesh=True, mesh_opacity=0.25)


def _recv_all(sock):
    chunks = []
    while True:
        chunk = sock.recv(65536)
        if not chunk:
            return b"".join(chunks)
        chunks.append(chunk)


def test_wire_bytes_equal():
    """The clients send the same bytes; the servers reply the same bytes."""
    sent = {}
    for name, mod in (("port", tclient), ("jax", jclient)):
        a, b = socket.socketpair()
        b.settimeout(TIMEOUT)
        client = mod.RemoteRenderClient()
        client.socket = a
        client.request_pause(do_training=False)
        client.request_pause(do_training=True)
        client.close()
        sent[name] = _recv_all(b)
        b.close()
    assert sent["port"] == sent["jax"] and len(sent["port"]) > 0

    rng = np.random.default_rng(0)
    image = rng.random((3, 24, 32)).astype(np.float32) * 1.2 - 0.1
    stats = {"num_timesteps": 7, "num_points": 1234}
    replies = {}
    for name, mod in (("port", tgui), ("jax", jgui)):
        a, b = socket.socketpair()
        b.settimeout(TIMEOUT)
        server = mod.NetworkGUI()
        server.conn = a
        server.send(image, stats)
        server.send(None, stats)
        server.drop()
        replies[name] = _recv_all(b)
        b.close()
    assert replies["port"] == replies["jax"]
    assert len(replies["port"]) == 24 * 32 * 3 + 2 * (4 + len(
        json.dumps(stats)))


def test_view_request_bytes_equal():
    """A full view request of each client, and the message the server
    parses from it, are the same."""
    got = {}
    for name, mod in (("port", tclient), ("jax", jclient)):
        a, b = socket.socketpair()
        b.settimeout(TIMEOUT)
        client = mod.RemoteRenderClient()
        client.socket = a
        req = mod.ViewRequest(**_request())
        reply = threading.Thread(target=lambda: (
            b.sendall(bytes(24 * 32 * 3)), b.sendall(b"\x02\x00\x00\x00{}")))
        # the client reads the image and the stats after sending
        payload = {}

        def serve(b=b, payload=payload):
            length = int.from_bytes(b.recv(4, socket.MSG_WAITALL), "little")
            payload["raw"] = b.recv(length, socket.MSG_WAITALL)
            reply.start()

        t = threading.Thread(target=serve)
        t.start()
        img, stats = client.request_view(req)
        t.join(TIMEOUT)
        reply.join(TIMEOUT)
        assert not t.is_alive() and img.shape == (24, 32, 3) and stats == {}
        got[name] = payload["raw"]
        a.close()
        b.close()
    assert got["port"] == got["jax"]
    msg = json.loads(got["port"])
    for mod in (tgui, jgui):
        a, b = socket.socketpair()
        a.settimeout(TIMEOUT)
        b.sendall(len(got["port"]).to_bytes(4, "little") + got["port"])
        server = mod.NetworkGUI()
        server.conn = a
        cam, parsed = server.receive()
        assert parsed == dict(msg, do_training=False, keep_alive=True)
        assert (cam.width, cam.height, cam.timestep) == (32, 24, 1)
        if mod is tgui:
            port_cam = cam
        else:
            for k in ("world_view_transform", "full_proj_transform"):
                np.testing.assert_array_equal(getattr(port_cam, k),
                                              getattr(cam, k))
        a.close()
        b.close()


def _free_server(mod):
    """A listening server of `mod` on a free port: (server, port)."""
    server = mod.NetworkGUI(port=0)
    server.init()
    return server, server.listener.getsockname()[1]


@pytest.mark.parametrize("server_mod,client_mod",
                         [(tgui, jclient), (jgui, tclient)],
                         ids=["port-server", "jax-server"])
def test_loopback_across_packages(server_mod, client_mod):
    server, port = _free_server(server_mod)
    if server_mod is tgui:
        assert server.port == port != 0
    rng = np.random.default_rng(1)
    image = rng.random((3, 24, 32)).astype(np.float32)
    result = {}

    def serve():
        server.listener.settimeout(TIMEOUT)
        server.conn, _ = server.listener.accept()
        server.conn.settimeout(TIMEOUT)
        cam, result["msg"] = server.receive()
        result["cam"] = cam
        server.send(image, {"num_timesteps": 3, "num_points": 99})
        _, result["pause"] = server.receive()

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    client = client_mod.RemoteRenderClient(port=port, timeout=TIMEOUT)
    try:
        assert client.connect(retries=20, wait=0.1)
        img, stats = client.request_view(client_mod.ViewRequest(
            **dict(_request(), show_mesh=False)))
        client.request_pause(do_training=True)
        t.join(TIMEOUT)
        assert not t.is_alive()
    finally:
        client.close()
        server.close()
    np.testing.assert_array_equal(
        img, np.clip(image * 255.0, 0, 255).astype(np.uint8).transpose(
            1, 2, 0))
    assert stats == {"num_timesteps": 3, "num_points": 99}
    assert result["cam"].width == 32 and result["cam"].timestep == 1
    assert result["msg"]["do_training"] is False
    assert result["pause"]["resolution_x"] == 0
    assert result["pause"]["do_training"] is True


def test_init_reports_a_taken_port():
    server, port = _free_server(tgui)
    try:
        other = tgui.NetworkGUI(port=port)
        with pytest.raises(OSError):
            other.init()
        assert other.listener is None
    finally:
        server.close()


# ---- the viewer inside training -----------------------------------------------

SCHEDULE = dict(iterations=2, densify_from_iter=100,
                opacity_reset_interval=1000, position_lr_max_steps=2)


def _cfg(data, out):
    return dict(source_path=data, model_path=out, bind_to_mesh=True,
                eval=True, sh_degree=1)


def _gui_client(client, mod, out):
    """The test's viewer (`client` is connected): at the first poll a view
    and a view with the mesh (training paused), resume; at the second poll
    the mesh alone with the original and with the current FLAME
    parameters, resume, leave."""
    cam = torbit.OrbitCamera(32, 24, r=0.6, fovy=40.0, convention="opengl",
                             save_path="")
    base = dict(width=32, height=24, fovx=math.radians(cam.fovx),
                fovy=math.radians(cam.fovy), znear=cam.znear, zfar=cam.zfar,
                world_view_transform=cam.world_view_transform,
                full_proj_transform=cam.full_proj_transform, timestep=1,
                do_training=False)
    try:
        for name, extra in (
                ("view", {}), ("view_mesh", dict(show_mesh=True)),
                (None, None),
                ("orig_mesh_0", dict(show_splatting=False, show_mesh=True,
                                     use_original_mesh=True, timestep=0)),
                ("mesh_0", dict(show_splatting=False, show_mesh=True,
                                timestep=0)),
                ("orig_mesh_1", dict(show_splatting=False, show_mesh=True,
                                     use_original_mesh=True)),
                ("mesh_1", dict(show_splatting=False, show_mesh=True)),
                ("leave", None)):
            if name is None:
                client.request_pause(do_training=True)
            elif name == "leave":
                # at the last iteration the server keeps serving until the
                # client lets go (keep_alive false)
                client._send_json({"resolution_x": 0, "resolution_y": 0,
                                   "do_training": True,
                                   "keep_alive": False})
            else:
                out[name] = client.request_view(
                    mod.ViewRequest(**dict(base, **extra)))
    except Exception as exc:  # noqa: BLE001  (reported by the test)
        out["error"] = exc
    finally:
        client.close()


def _train_with_viewer(package, data, out_dir, **kwargs):
    """Train SCHEDULE with a viewer connected before the first poll; returns
    ({name: (wire image, stats)}, [images handed to `send`])."""
    mod, cmod = (tgui, tclient) if package == "port" else (jgui, jclient)
    server, port = _free_server(mod)
    handed = []
    send = server.send

    def recording_send(image, stats):
        handed.append(None if image is None else (
            image.detach().cpu().numpy() if isinstance(image, torch.Tensor)
            else np.asarray(image)))
        send(image, stats)

    server.send = recording_send
    out = {}
    # connected before training starts, so the first poll finds it
    viewer = cmod.RemoteRenderClient(port=port, timeout=TIMEOUT)
    assert viewer.connect(retries=20, wait=0.1)
    client = threading.Thread(target=_gui_client, args=(viewer, cmod, out),
                              daemon=True)
    client.start()
    try:
        if package == "port":
            training(ModelConfig(**_cfg(data, out_dir)),
                     OptimizationConfig(**SCHEDULE),
                     PipelineConfig(tile_size=16), gui=server, log_every=1,
                     device="cpu", **kwargs)
        else:
            jax_training(JaxModelConfig(**_cfg(data, out_dir)),
                         JaxOpt(**SCHEDULE),
                         JaxPipeline(backend="jnp", capacity=1 << 18,
                                     chunk=16, tile_size=16),
                         gui=server, log_every=1)
        client.join(TIMEOUT)
        assert not client.is_alive()
    finally:
        server.close()
    assert "error" not in out, out.get("error")
    return out, handed


@pytest.fixture(scope="module")
def gui_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("gui")
    data, assets = make_port_avatar_dataset(root)
    mp = pytest.MonkeyPatch()
    mp.setenv("FLAME_ASSET_DIR", assets)
    try:
        runs = {"port": _train_with_viewer(
                    "port", data, str(root / "port"),
                    saving_iterations={SCHEDULE["iterations"]}),
                "jax": _train_with_viewer("jax", data, str(root / "jax"))}
        yield dict(runs, port_dir=str(root / "port"), assets=assets)
    finally:
        mp.undo()


def test_gui_frames_match_jax(gui_runs):
    """See the module docstring."""
    (t_out, t_sent), (j_out, j_sent) = gui_runs["port"], gui_runs["jax"]
    names = ["view", "view_mesh", "orig_mesh_0", "mesh_0", "orig_mesh_1",
             "mesh_1"]
    assert set(t_out) == set(j_out) == set(names)
    assert len(t_sent) == len(j_sent) == len(names)
    for name, a, b in zip(names, t_sent, j_sent):
        assert a.shape == b.shape == (3, 24, 32), name
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL_RENDER,
                                   err_msg=name)
        (ta, ts), (ja, js) = t_out[name], j_out[name]
        assert ta.dtype == np.uint8 and ta.shape == (24, 32, 3)
        assert np.abs(ta.astype(int) - ja.astype(int)).max() <= 1, name
        assert ts == js == {"num_timesteps": 2, "num_points": 10144}
    # the frames show what they were asked for: the avatar, the mesh over
    # it, and, at the timestep the first step trained, a mesh that one
    # step of FLAME finetuning has moved from the dataset's
    assert np.abs(t_sent[0]).max() > 0.05
    assert np.abs(t_sent[1] - t_sent[0]).max() > 0.05
    for sent in (t_sent, j_sent):
        assert max(np.abs(sent[3] - sent[2]).max(),
                   np.abs(sent[5] - sent[4]).max()) > 0


def test_gui_render_error_is_printed_and_dropped(tmp_path, capfd):
    """A request the render cannot serve (a timestep past the model's) is
    printed with its traceback, the connection dropped, and training goes
    on."""
    from gaussianavatars_torch.benchmark import make_bound_bench_model
    from gaussianavatars_torch.train.loop import gui_poll, initial_state

    model = make_bound_bench_model(1, n_per_face=1, device="cpu")
    state = initial_state(model)
    server, port = _free_server(tgui)
    client = tclient.RemoteRenderClient(port=port, timeout=TIMEOUT)
    try:
        assert client.connect(retries=20, wait=0.1)
        req = tclient.ViewRequest(**_request())
        client._send_json({"resolution_x": 32, "resolution_y": 24,
                           "do_training": False, "keep_alive": True,
                           "fov_x": req.fovx, "fov_y": req.fovy,
                           "z_near": req.znear, "z_far": req.zfar,
                           "view_matrix": np.asarray(
                               req.world_view_transform).T.ravel().tolist(),
                           "view_projection_matrix": np.asarray(
                               req.full_proj_transform).T.ravel().tolist(),
                           "timestep": model.num_timesteps + 5})
        flame_fixed = {k: v for k, v in model.flame_param.items()
                       if k not in state.flame_tr}
        gui_poll(server, model, state, flame_fixed, PipelineConfig(), 1, 10,
                 {})
        assert server.conn is None
    finally:
        client.close()
        server.close()
    err = capfd.readouterr()
    assert "[gui] dropping viewer connection after error" in err.out
    assert "Traceback" in err.err


# ---- the local viewer core ---------------------------------------------------

@pytest.fixture(scope="module")
def saved_avatar(tmp_path_factory):
    """The avatar `tests/test_local_viewer_core.py` saves (2 timesteps,
    SH 1), and its FLAME assets in $FLAME_ASSET_DIR."""
    from gaussianavatars_tpu.models.flame import FlameHead
    from gaussianavatars_tpu.models.flame_gaussians import (
        FlameGaussianModel,
    )

    from .flame_fixtures import make_flame_assets
    from .test_flame_gaussians import make_meshes

    root = tmp_path_factory.mktemp("viewer_core")
    paths = make_flame_assets(str(root / "assets"), seed=3)
    mp = pytest.MonkeyPatch()
    mp.setenv("FLAME_ASSET_DIR", str(root / "assets"))
    head = FlameHead(300, 100, flame_model_path=paths["model"],
                     flame_lmk_embedding_path=paths["lmk"],
                     flame_template_mesh_path=paths["obj"],
                     flame_parts_path="/nonexistent")
    m = FlameGaussianModel(sh_degree=1, flame_head=head,
                           capacity_granularity=16384)
    m.load_meshes(make_meshes(2), {})
    m.create_from_pcd(None, None, 1.0)
    ply = str(root / "pc" / "point_cloud.ply")
    m.save_ply(ply)
    try:
        yield ply
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def cores(saved_avatar):
    sys.path.insert(0, REPO)
    from local_viewer import LocalViewerCore as JaxCore

    kw = dict(sh_degree=1, width=48, height=32, radius=0.8)
    jcore = JaxCore(saved_avatar, **kw)
    jcore.pipe.capacity = 1 << 18
    jcore.pipe.chunk = 16
    jcore.pipe.tile_size = 16
    tcore = tviewer.LocalViewerCore(saved_avatar, device="cpu", **kw)
    tcore.pipe.tile_size = 16
    return tcore, jcore


def test_viewer_core_renders_match_jax(cores):
    tcore, jcore = cores
    assert tcore.bound and tcore.model.num_timesteps == 2
    for core in cores:
        core.cam.orbit_y(0.4)
        core.timestep = 1
    frames = {}
    for name, act, kw in (
            ("plain", None, {}),
            ("mesh", None, dict(show_mesh=True, mesh_opacity=0.3)),
            ("expr", lambda c: c.set_expression(0, 2.5), {}),
            ("jaw", lambda c: c.set_pose("jaw_pose", 0, 0.3), {}),
            ("scaled", None, dict(scaling_modifier=1.5))):
        for core in cores:
            if act is not None:
                act(core)
        a, b = tcore.render(**kw), jcore.render(**kw)
        assert a.shape == b.shape == (3, 32, 48), name
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL_RENDER,
                                   err_msg=name)
        frames[name] = a
    assert np.abs(frames["plain"]).max() > 0.05
    for name in ("mesh", "expr", "scaled"):
        assert np.abs(frames[name] - frames["plain"]).max() > 1e-3, name
    assert np.abs(frames["jaw"] - frames["expr"]).max() > 0
    for core in cores:
        core.reset_overrides()


def test_viewer_core_keyframes_match_jax(cores, tmp_path):
    tcore, jcore = cores
    for core in cores:
        core.clear_keyframes()
        core.cam.reset()
        core.timestep = 0
        core.add_keyframe()
        core.cam.orbit_y(0.8)
        core.cam.scale(0.5)
        core.cam.pan(dx=2.0)
        core.timestep = 1
        core.add_keyframe()
        core.cam.orbit_x(-0.3)
        core.add_keyframe()
    assert tcore.keyframes == jcore.keyframes
    ft, fj = tcore.interpolate_trajectory(9), jcore.interpolate_trajectory(9)
    assert len(ft) == len(fj) == 9
    for a, b in zip(ft, fj):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_allclose(a[k], b[k], atol=1e-6, err_msg=k)
    tcore.export_trajectory(str(tmp_path / "t.json"), n_frames=7)
    jcore.export_trajectory(str(tmp_path / "j.json"), n_frames=7)
    with open(tmp_path / "t.json") as f, open(tmp_path / "j.json") as g:
        td, jd = json.load(f), json.load(g)
    assert td["keyframes"] == jd["keyframes"]
    np.testing.assert_allclose(
        [[*fr["rotation"], *fr["look_at"], fr["radius"], fr["fovy"],
          fr["timestep"]] for fr in td["frames"]],
        [[*fr["rotation"], *fr["look_at"], fr["radius"], fr["fovy"],
          fr["timestep"]] for fr in jd["frames"]], atol=1e-6)
    for core in cores:
        core.apply_frame(ft[4])
    np.testing.assert_allclose(tcore.cam.pose, jcore.cam.pose, atol=1e-6)
    assert tcore.timestep == jcore.timestep


def test_viewer_core_playback_records(cores, tmp_path):
    tcore, _ = cores
    tcore.clear_keyframes()
    tcore.timestep = 0
    tcore.add_keyframe()
    tcore.cam.orbit_x(0.5)
    tcore.timestep = 1
    tcore.add_keyframe()
    rec = str(tmp_path / "rec")
    os.makedirs(rec)
    assert tcore.start_playback(n_frames=3, record_dir=rec)
    played = []
    while tcore.playing:
        played.append(tcore.tick_playback())
    assert played == [0, 1, 2] and not tcore.playing
    assert sorted(p for p in os.listdir(rec) if p.endswith(".png")) == [
        "00000.png", "00001.png", "00002.png"]
    from gaussianavatars_torch.utils.png import read_png

    shot = read_png(os.path.join(rec, "00002.png"))
    want = np.clip(tcore.render() * 255 + 0.5, 0, 255).astype(
        np.uint8).transpose(1, 2, 0)
    np.testing.assert_array_equal(shot, want)
    assert tcore.start_playback(n_frames=2, loop=True)
    assert [tcore.tick_playback() for _ in range(3)] == [0, 1, 0]
    tcore.stop_playback()
    assert tcore.tick_playback() is None


def test_local_viewer_needs_a_gpu_unless_asked(saved_avatar):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tviewer.LocalViewerCore(saved_avatar, sh_degree=1, width=8, height=8)


# ---- the dearpygui shells -----------------------------------------------------

def test_local_viewer_shell_runs_a_frame(monkeypatch, saved_avatar):
    calls, values = install_stub_dpg(monkeypatch, n_frames=1)
    tviewer.main(["--point_path", saved_avatar, "--sh_degree", "1",
                  "-W", "24", "-H", "16", "--radius", "0.8",
                  "--device", "cpu"])
    names = [c[0] for c in calls]
    assert names.count("render_dearpygui_frame") == 1
    assert "_e0" in values and "_p_jaw_pose_0" in values
    tex = values["_texture"]
    assert tex.shape == (16, 24, 3) and np.isfinite(tex).all()
    assert np.abs(tex - 1.0).max() > 0.05          # the avatar, not blank
    assert "destroy_context" in names


def test_remote_viewer_shell_talks_to_a_server(monkeypatch):
    calls, values = install_stub_dpg(monkeypatch, n_frames=3)
    server, port = _free_server(tgui)
    image = np.full((3, 24, 32), 0.5, np.float32)
    served = []

    def serve():
        server.listener.settimeout(TIMEOUT)
        server.conn, _ = server.listener.accept()
        server.conn.settimeout(TIMEOUT)
        try:
            while True:
                cam, msg = server.receive()
                served.append(msg)
                if cam is not None:
                    server.send(image, {"num_timesteps": 4,
                                        "num_points": 42})
        except (ConnectionError, OSError):
            pass

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    try:
        tremote.main(["--port", str(port), "-W", "32", "-H", "24"])
        t.join(TIMEOUT)
        assert not t.is_alive()
    finally:
        server.close()
    assert len(served) == 3
    assert served[0]["resolution_x"] == 32 and served[0]["do_training"]
    assert values["_log_num_points"] == "points: 42"
    np.testing.assert_allclose(values["_texture"], 127 / 255.0, rtol=1e-6)
    assert [c[0] for c in calls].count("render_dearpygui_frame") == 3


# ---- the FPS benchmarks -------------------------------------------------------

def _root_script(script, argv, cwd, assets):
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
               FLAME_ASSET_DIR=assets, OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, os.path.join(REPO, script), *argv],
                         cwd=cwd, env=env, capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return res.stdout


def _level_diff(a_path, b_path):
    from gaussianavatars_torch.utils.png import read_png

    a, b = read_png(a_path), read_png(b_path)
    assert a.shape == b.shape
    return int(np.abs(a.astype(int) - b.astype(int)).max())


def test_fps_benchmark_demo_vis_matches_root(saved_avatar, tmp_path,
                                            monkeypatch):
    """`--point_path` through the orbit camera: the --vis frame of the port
    and of the root script within 1 level."""
    from gaussianavatars_torch import fps_benchmark_demo

    argv = ["--point_path", saved_avatar, "--sh_degree", "1", "--width",
            "48", "--height", "32", "--n_iter", "1", "--n_rounds", "1",
            "--radius", "0.8", "--fovy", "25", "--timestep", "1", "--vis"]
    root_dir, port_dir = tmp_path / "root", tmp_path / "port"
    root_dir.mkdir()
    port_dir.mkdir()
    out = _root_script("fps_benchmark_demo.py", argv, str(root_dir),
                       os.environ["FLAME_ASSET_DIR"])
    assert "round 0:" in out
    monkeypatch.chdir(port_dir)
    fps = fps_benchmark_demo.main(argv + ["--device", "cpu"])
    assert len(fps) == 1 and fps[0] > 0
    vis = fps_benchmark_demo.VIS_PATH
    assert _level_diff(str(port_dir / vis), str(root_dir / vis)) <= 1


def test_fps_benchmark_dataset_vis_matches_root(gui_runs, tmp_path,
                                               monkeypatch):
    """The first view of each split of a trained model directory: the
    --vis frames of the port and of the root script within 1 level."""
    from gaussianavatars_torch import fps_benchmark_dataset

    argv = ["-m", gui_runs["port_dir"], "--n_iter", "1", "--n_rounds", "1",
            "--tile_size", "16", "--vis"]
    root_dir, port_dir = tmp_path / "root", tmp_path / "port"
    root_dir.mkdir()
    port_dir.mkdir()
    out = _root_script("fps_benchmark_dataset.py", argv, str(root_dir),
                       gui_runs["assets"])
    monkeypatch.setenv("FLAME_ASSET_DIR", gui_runs["assets"])
    monkeypatch.chdir(port_dir)
    fps = fps_benchmark_dataset.main(argv + ["--device", "cpu"])
    assert sorted(fps) == ["test", "train", "val"]
    for split in fps:
        assert f"{split} round 0:" in out
        name = f"fps_benchmark_{split}.png"
        assert _level_diff(str(port_dir / name), str(root_dir / name)) <= 1
