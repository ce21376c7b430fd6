"""Host milliseconds an iteration of the FLAME regularizers
(`train/loop.py::_flame_regularizers`, the program's `ga:flame_reg`
range inside the loss stack), over the profiled iterations."""

from avatarbench.program_trace import span_ms

read = span_ms("flame_reg")
