"""The device-busy reading of `train_device_ms`: the union of the device's
intervals from the profiler's events, on either form of event."""

import torch

from avatarbench import trace


class NewEvent:
    """An event that names its activity kind, in nanoseconds."""

    def __init__(self, kind, a, b):
        self.kind, self.a, self.b = kind, a, b

    def activity_type(self):
        return self.kind

    def start_ns(self):
        return self.a

    def duration_ns(self):
        return self.b - self.a


class OldEvent:
    """An event that names only its device, in microseconds."""

    def __init__(self, device, a, b):
        self.device, self.a, self.b = device, a, b

    def device_type(self):
        return self.device

    def start_us(self):
        return self.a

    def duration_us(self):
        return self.b - self.a


def busy_ns(events):
    spans = [trace._interval_ns(e) for e in events if trace._on_device(e)]
    return trace._union(spans)[0]


def test_union_of_device_activity_only():
    events = [NewEvent("kernel", 0, 10), NewEvent("gpu_memcpy", 5, 20),
              NewEvent("cuda_runtime", 0, 100), NewEvent("gpu_memset", 30, 35)]
    assert busy_ns(events) == 25


def test_events_without_activity_kind():
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    events = [OldEvent(cuda, 1, 3), OldEvent(cpu, 0, 50),
              OldEvent(cuda, 2, 6)]
    assert busy_ns(events) == 5000


def test_no_device_time_off_a_gpu():
    calls = []
    assert trace.device_busy_s(lambda: calls.append(1), 3,
                               torch.device("cpu")) is None
    assert calls == []
