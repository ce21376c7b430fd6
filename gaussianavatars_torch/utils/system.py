"""System utilities (port of `gaussianavatars_tpu/utils/system.py`;
reference utils/general_utils.py:112-133 and utils/system_utils.py).

Only the seeding half of `safe_state` is ported: the port prints plain
lines and does not replace `sys.stdout` with a timestamping writer."""

from __future__ import annotations

import os
import random

import numpy as np
import torch


def safe_state(seed: int = 0):
    """Seed the process RNGs: `random` (the camera shuffles), numpy's
    global generator and torch's."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def mkdir_p(path: str):
    os.makedirs(path, exist_ok=True)


def search_for_max_iteration(folder: str) -> int:
    """The largest N of the `iteration_N` entries of `folder`
    (reference utils/system_utils.py:26-28)."""
    return max(int(f.split("_")[-1]) for f in os.listdir(folder))
