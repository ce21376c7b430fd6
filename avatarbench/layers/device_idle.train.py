"""The device's idle share of the train step."""

from avatarbench.measures import device_idle

read = device_idle
