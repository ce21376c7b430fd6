"""Host milliseconds from the forward mark to the backward mark: autograd's
backward, K2 (`csrc/blend_bwd.cu`) among it."""

from avatarbench.measures import span_ms

read = span_ms("forward", "backward")
