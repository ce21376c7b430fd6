"""Host milliseconds from the composite mark to the frame's uint8 pixels on
the host: the conversion, the copy and the wait for the device."""

from avatarbench.measures import span_ms

read = span_ms("composite", "delivered")
