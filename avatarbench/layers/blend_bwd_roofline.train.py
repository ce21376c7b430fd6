"""Kernel K2's share of its roofline (`csrc/blend_bwd.cu`): the work
counted by `work/counts.py::blend_bwd` over the device time launched
inside the autograd node of `BlendImage`'s backward."""

from avatarbench.measures import blend_bwd_roofline

read = blend_bwd_roofline
