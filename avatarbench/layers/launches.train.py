"""Launches of device work (kernels, copies, sets) an iteration inside the
program's `ga:train_step` range, on any thread (the backward's from
autograd's), over the profiled iterations: the work the host launches, counted."""

from avatarbench.program_trace import launches

read = launches("train_step")
