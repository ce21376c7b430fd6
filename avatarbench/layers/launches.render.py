"""Launches of device work (kernels, copies, sets) an iteration inside the
program's `ga:render` range (the frame's conversion and copy in
`to_wire` are outside it), over the profiled iterations: the work the
host launches, counted."""

from avatarbench.program_trace import launches

read = launches("render")
