"""Milliseconds a frame: the window's wall time over the frames delivered
to the host."""


def read(w):
    return 1e3 * w.seconds / w.n
