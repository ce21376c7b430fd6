"""Host milliseconds from the binding mark to the projection mark: the EWA
projection and the SH colours (`ops/projection.py`, `ops/sh.py`)."""

from avatarbench.measures import span_ms

read = span_ms("binding", "projection")
