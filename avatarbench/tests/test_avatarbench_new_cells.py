"""The cells `scene-train` (loop kind "train_scene", the 3DGS scene of
`scene3dgs.py`) and `avatar-train-decode` (loop kind "train_decode", the
views read by the program's `CameraLoader` from PNGs) at the tiny size on
the CPU: the reference against the program, the metrics they report, the
scene's mixture and the loader's decodes in every epoch."""

import json
import math

import pytest
import torch

from avatarbench import harness, scene3dgs
from avatarbench.tests import tiny

# the program against the reference at the tiny size, as in
# test_avatarbench_dry_run.py
TINY = {"loss_gap": 1e-4, "loss1_gap": 1e-4, "grad_gap": 1e-3,
        "change_gap": 1e-3}


@pytest.mark.parametrize("workload,trace", [
    ("scene-train", False), ("scene-train", True),
    ("avatar-train-decode", True)])
def test_tiny_run(workload, trace):
    lines = []
    out = tiny.run(workload, trace=trace, lines=lines)
    assert out["correct"], out["check"]
    for name, c in out["check"].items():
        assert c["value"] is not None and c["value"] <= TINY[name], name
    names = set(out["metrics"])
    if not trace:
        assert names == {"setup_s"}
        return
    assert out["metrics"]["slots_kept.train"]["value"] > 0
    assert "flame_binding_ms.train" in names \
        or workload == "scene-train"
    assert ("load_wait_ms.train" in names) \
        == (workload == "avatar-train-decode")


def test_loader_decodes_every_epoch(capsys):
    """The decode loop's cache holds half the views: after the window each
    epoch it went through decoded views again."""
    tiny.run("avatar-train-decode", seconds=1.0)
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith('{"what": "loader"')]
    (loader,) = lines
    assert len(loader["decodes_by_epoch"]) >= 2
    assert all(n > 0 for n in loader["decodes_by_epoch"])


def test_scene_mixture():
    root = tiny.ROOT
    _, _, cfg, _, _ = harness.find_cell(root, "scene-train")
    spec = cfg["scene"]
    p = scene3dgs.scene_params(7, 20_000, spec, 16, "cpu")
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        "xyz": (20_000, 3), "features_dc": (20_000, 3),
        "features_rest": (20_000, 45), "scaling": (20_000, 3),
        "rotation": (20_000, 4), "opacity": (20_000, 1)}
    r = p["xyz"].norm(dim=1)
    n_obj = round(spec["object_share"] * 20_000)
    assert float(r[:n_obj].max()) <= spec["object_radius"]
    lo, hi = spec["background_radius"]
    assert lo <= float(r[n_obj:].min()) and float(r[n_obj:].max()) <= hi
    # background scales follow the distance: log-scale slope ~1 in log r
    s = p["scaling"][n_obj:, 0]
    slope = torch.cov(torch.stack([torch.log(r[n_obj:]), s]))[0, 1] \
        / torch.var(torch.log(r[n_obj:]))
    assert abs(float(slope) - 1.0) < 0.1
    flat = p["scaling"][:, 2] - p["scaling"][:, 0]
    assert abs(float(flat.mean()) - math.log(spec["flatten"])) < 0.05
    assert torch.equal(scene3dgs.scene_params(7, 20_000, spec, 16, "cpu")[
        "xyz"], p["xyz"])
