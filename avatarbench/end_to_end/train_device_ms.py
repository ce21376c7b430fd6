"""Device milliseconds a train iteration: the busy union of the device's
kernels, copies and sets in the profiler's events over the traffic's
fixed block (`device_iterations` from the restored start, a whole epoch
of the avatar's views), run after the window, over the block's
iterations. None off a GPU: a CPU run has no device time."""


def read(w):
    return w.device_ms
