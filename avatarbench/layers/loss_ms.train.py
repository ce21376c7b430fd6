"""Host milliseconds from the composite mark to the forward mark: the
losses (`train/losses.py`, `ops/ssim.py`)."""

from avatarbench.measures import span_ms

read = span_ms("composite", "forward")
