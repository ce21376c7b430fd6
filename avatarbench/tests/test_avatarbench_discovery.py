"""A new configuration, traffic mix, loop kind, cell and per-layer metric
are new files and new entries: nothing else is edited."""

import json
import os
import shutil

from avatarbench import harness
from avatarbench.tests import tiny

DATA = ("configs", "traffic", "limits", "layers", "end_to_end", "loops")

REVERSED = """\
from avatarbench.loops.train import TrainViews


class Reversed(TrainViews):
    def view(self, k):
        return len(self.views) - 1 - super().view(k)


LOOP = Reversed
"""


def test_new_files_make_a_new_cell(tmp_path):
    root = str(tmp_path)
    for d in DATA:
        shutil.copytree(os.path.join(tiny.ROOT, "avatarbench", d),
                        os.path.join(root, "avatarbench", d))
    shutil.copy(os.path.join(tiny.ROOT, "BENCHMARK.json"), root)
    data = os.path.join(root, "avatarbench")
    with open(os.path.join(data, "configs", "3dgs-cloud-100k.json")) as fh:
        cfg = dict(json.load(fh), name="3dgs-cloud-50k", gaussians=50_000)
    with open(os.path.join(data, "configs", "3dgs-cloud-50k.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(data, "traffic", "train-views.json")) as fh:
        tr = dict(json.load(fh), cameras=5, kind="train_reversed")
    with open(os.path.join(data, "traffic", "train-five.json"), "w") as f:
        json.dump(tr, f)
    with open(os.path.join(data, "loops", "train_reversed.py"), "w") as f:
        f.write(REVERSED)
    shutil.copy(os.path.join(data, "limits", "cloud-train.json"),
                os.path.join(data, "limits", "cloud50-train.json"))
    with open(os.path.join(data, "layers", "profiled_steps.train.py"),
              "w") as f:
        f.write("def read(d):\n    return float(d.profiled.iterations)\n")
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    bench["configs"].append(dict(
        name="3dgs-cloud-50k", source="https://example.org/cloud",
        file="avatarbench/configs/3dgs-cloud-50k.json", reduced=[],
        why="a smaller cloud"))
    bench["workloads"].append(dict(
        name="cloud50-train", config="3dgs-cloud-50k", traffic="train-five",
        chips=1, why="five cameras"))
    for m in bench["end_to_end"]:
        if m["name"] == "train_device_ms":
            m["workloads"].append("cloud50-train")
    bench["per_layer"].append(dict(
        name="profiled_steps.train", unit="steps", better="higher",
        source="program_span", layer="whole train step",
        moves="train_device_ms", workloads=["cloud50-train"]))
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)

    _, cell, cfg, tr, _ = harness.find_cell(root, "cloud50-train")
    assert cfg["gaussians"] == 50_000 and tr["cameras"] == 5
    assert harness.loop_class(root, tr["kind"]).__name__ == "Reversed"
    _, layers = harness.cell_metrics(bench, "cloud50-train")
    assert [m["name"] for m in layers] == ["profiled_steps.train"]
    out = tiny.run("cloud50-train", trace=True, root=root)
    assert out["metrics"]["profiled_steps.train"]["value"] == 2.0
    assert out["correct"], out["check"]
    out = tiny.run("cloud50-train", root=root)
    # train_device_ms is a device time: a CPU run leaves it out
    assert set(out["metrics"]) == {"setup_s"}
