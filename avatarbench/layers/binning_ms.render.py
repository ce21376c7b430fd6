"""Host milliseconds from the projection mark to the pack_gather mark: the
binning and the stream gather (`ops/binning_dense.py`,
`ops/instance_pack.py`), with the wait of the binning's host sync."""

from avatarbench.measures import span_ms

read = span_ms("projection", "pack_gather")
