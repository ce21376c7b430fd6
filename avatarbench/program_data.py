"""The measured program's data path, beside `program.py`'s model entries:
the camera record, the prefetching camera loader, the training loop's
device cache of ground truths and the PNG writer of its datasets,
imported from `gaussianavatars_torch` for the loops that read their
ground truth from files."""

from __future__ import annotations

from gaussianavatars_torch.data.cameras import Camera
from gaussianavatars_torch.data.loader import CameraLoader
from gaussianavatars_torch.train.loop import GroundTruthCache
from gaussianavatars_torch.utils.png import write_png

__all__ = ["Camera", "CameraLoader", "GroundTruthCache", "write_png"]
