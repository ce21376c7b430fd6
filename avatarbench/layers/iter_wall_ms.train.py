"""Wall milliseconds a train iteration, on the host clock: the traced
window's wall time, closed by a synchronisation, over the iterations it
completed. The host issues the step, so this follows the host's speed."""


def read(d):
    return 1e3 * d.window.seconds / d.window.n
