"""The 95th percentile of the frames' latencies over the whole window, a
frame timed from its start to its uint8 pixels on the host."""

import numpy as np


def read(w):
    return 1e3 * float(np.percentile(w.latencies, 95))
