"""Device-idle milliseconds an iteration that the host syncs cause: from
each `ga:sync.*` range's start to the first device activity after it
ends, less the device's busy time in between, over the profiled
iterations."""

from avatarbench.program_trace import sync_idle_ms

read = sync_idle_ms
