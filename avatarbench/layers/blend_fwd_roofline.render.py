"""Kernel K1's share of its roofline (`ops/tile_blend.py`,
`csrc/blend_fwd.cu`): the work counted by `work/counts.py::blend_fwd`
over the device time launched between the pack_gather and blend marks."""

from avatarbench.measures import blend_fwd_roofline

read = blend_fwd_roofline
