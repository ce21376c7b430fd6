"""The plain reference imports nothing of the program or of JAX; the
benchmark's run leaves no JAX module loaded."""

import json
import subprocess
import sys

from avatarbench.tests import tiny

FORBIDDEN = {"gaussianavatars_torch", "jax", "jaxlib", "gaussianavatars_tpu",
             "flax"}


def _modules_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\nprint(json.dumps("
         "sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=tiny.ROOT, capture_output=True, text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_imports_nothing_of_the_program():
    loaded = _modules_after(
        "import avatarbench.reference.train, avatarbench.reference.render, "
        "avatarbench.reference.flame, avatarbench.scene, "
        "avatarbench.work.counts")
    assert not loaded & FORBIDDEN


def test_run_loads_no_jax():
    loaded = _modules_after(
        "import torch\ntorch.set_num_threads(2)\n"
        "from avatarbench.tests import tiny\n"
        "assert tiny.run('cloud-train', trace=True)['correct']")
    assert "gaussianavatars_torch" in loaded
    assert not loaded & (FORBIDDEN - {"gaussianavatars_torch"})
