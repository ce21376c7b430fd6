"""Kept slots an iteration: the instance stream's length after the
binning's cull, from the program's counter `slots_kept` (its profiler
ranges `ga.count:slots_kept=<n>`, `gaussianavatars_torch/utils/trace.py`),
the mean over the profiled iterations; None where the program opens no
such range."""

PREFIX = "ga.count:slots_kept="


def read(d):
    p = d.profiled
    kept = [int(r["name"][len(PREFIX):]) for r in p.ranges
            if r["name"].startswith(PREFIX)]
    if not kept:
        return None
    return sum(kept) / p.iterations
