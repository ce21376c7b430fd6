"""Host milliseconds from the backward mark to the stats mark: the Adam
step and the densification statistics (`train/optim.py`, `train/loop.py`)."""

from avatarbench.measures import span_ms

read = span_ms("backward", "stats")
