"""A frame's share of the FP32 peak, from the frozen frame count
`work/counts.py::frame_flops`."""

from avatarbench.measures import mfu
from avatarbench.work import counts

read = mfu(counts.frame_flops)
