"""A tiny run of every traffic mix on the CPU: the result line's keys,
the reference against the program, and the metrics each cell reports."""

import json

import pytest

from avatarbench.tests import tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device"]
# the program against the reference at the tiny size, on the CPU: few
# Gaussians on screen, so one element's round-off weighs more in a leaf
# than at the cells' sizes, whose limits are in limits/
TINY = {"loss_gap": 1e-4, "loss1_gap": 1e-4, "grad_gap": 1e-3, "change_gap": 1e-3,
        "level_gap_max": 2, "level_gap_mean": 1e-2}


@pytest.mark.parametrize("workload,trace", [
    ("cloud-train", False), ("cloud-train", True), ("avatar-train", False),
    ("avatar-train", True), ("avatar-replay", False),
    ("avatar-replay", True)])
def test_tiny_run(workload, trace):
    lines = []
    out = tiny.run(workload, trace=trace, lines=lines)
    assert list(out)[:5] == KEYS and list(out)[-1] == "check"
    json.dumps(out, allow_nan=False)
    for name, c in out["check"].items():
        assert c["value"] is not None and c["value"] <= TINY[name], name
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert out["device"]["platform"] == "cpu"
    names = set(out["metrics"])
    if not trace:
        assert "setup_s" in names and "breakdown" not in out
        if "train" in workload:
            # a device time: a CPU run has none and leaves it out
            assert "train_device_ms" not in names
        else:
            assert "frame_ms" in names
    else:
        assert "breakdown" in out and "busy_s" in out["device"]
        assert "device_idle.train" in names or "device_idle.render" in names
        if "train" in workload:
            assert out["metrics"]["iter_wall_ms.train"]["value"] > 0
        # no device kernels on the CPU: no roofline is reported
        assert not any("roofline" in n for n in names)
    if workload == "cloud-train" and trace:
        assert "flame_binding_ms.train" not in names
    if "train" in workload:
        # the steps compared are the window's: an epoch start after the
        # warm-up's 3 steps
        detail = [json.loads(x) for x in lines if '"check_detail"' in x][0]
        assert detail["k0"] >= 3
