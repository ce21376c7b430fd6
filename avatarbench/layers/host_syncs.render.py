"""Host syncs an iteration: the program's sync spans (`ga:sync.*` ranges:
FLAME's copy from the host in `ops/lbs.py`, the binning's slot count and
compaction in `ops/binning_dense.py` / `ops/binning.py`, and in a frame
`to_wire`'s copy to the host) over the profiled iterations."""

from avatarbench.program_trace import host_syncs

read = host_syncs
