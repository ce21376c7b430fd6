"""The train step's share of the FP32 peak, from the frozen step count
`work/counts.py::step_flops`."""

from avatarbench.measures import mfu
from avatarbench.work import counts

read = mfu(counts.step_flops)
