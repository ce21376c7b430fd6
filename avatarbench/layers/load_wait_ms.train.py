"""Host milliseconds an iteration that the issuing thread waited for its
view in the camera loader (`data/loader.py::CameraLoader.__next__`, the
program's `ga:load_wait` ranges), over the profiled iterations."""

from avatarbench.program_trace import span_ms

read = span_ms("load_wait")
