"""Host milliseconds an iteration spent inside the program's sync spans
(`ga:sync.*` ranges), the host blocked until the device reached the sync,
over the profiled iterations."""

from avatarbench.program_trace import sync_wait_ms

read = sync_wait_ms
