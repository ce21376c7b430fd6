"""The device's idle share of the render."""

from avatarbench.measures import device_idle

read = device_idle
