"""The program's own spans in the profiled iterations.

The program opens the profiler range `ga:<span>` around each of its spans
while a profiler is active (`gaussianavatars_torch/utils/trace.py`): the
roots `ga:train_step` and `ga:render`, the stages under them, `ga:to_wire`,
and each host sync as `ga:sync.<site>`. These bodies read those
ranges from the profiled iterations of a traced run (`LayerData.profiled`,
`trace.Profiled`) for the readers `layers/<metric>.py`. Each returns None
where its ranges are not there: a program without them, or, for what
needs device activity, a run without a device.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

PREFIX = "ga:"
SYNC = PREFIX + "sync."


def _ranges(p, match) -> list:
    """(start, end, name) of the profiled ranges whose name `match`
    accepts, in microseconds, sorted."""
    return sorted((r["ts"], r["ts"] + r["dur"], r["name"])
                  for r in p.ranges if match(r["name"]))


def _device_busy(p) -> list:
    """The union of the device's activity, as sorted disjoint
    [start, end] intervals in microseconds."""
    merged = []
    for a, b in sorted((e["ts"], e["ts"] + e["dur"])
                       for evs in p.by_corr.values() for e in evs):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _busy_between(merged, starts, a, b) -> float:
    """Microseconds of `merged` inside [a, b]."""
    total = 0.0
    for s, e in merged[max(bisect.bisect_right(starts, a) - 1, 0):]:
        if s >= b:
            break
        total += max(0.0, min(e, b) - max(s, a))
    return total


def sync_sites(p) -> dict:
    """Per sync site (`ga:sync.<site>`) an iteration: its syncs (`n`), the
    host milliseconds inside them (`wait_ms`), and the device-idle
    milliseconds they cause (`idle_ms`: from each sync's start to the first
    device activity that starts after it ends, less the device's busy time
    in between; None without device activity)."""
    merged = _device_busy(p)
    starts = [s for s, _ in merged]
    act = sorted(e["ts"] for evs in p.by_corr.values() for e in evs)
    out: dict = {}
    for a, b, name in _ranges(p, lambda n: n.startswith(SYNC)):
        site = out.setdefault(name[len(PREFIX):], [0, 0.0, 0.0])
        site[0] += 1
        site[1] += b - a
        i = bisect.bisect_left(act, b)
        if i < len(act):
            site[2] += (act[i] - a) - _busy_between(merged, starts, a, act[i])
    k = p.iterations
    return {name: {"n": n / k, "wait_ms": 1e-3 * wait / k,
                   "idle_ms": 1e-3 * idle / k if merged else None}
            for name, (n, wait, idle) in out.items()}


def _has_spans(p) -> bool:
    return any(r["name"].startswith(PREFIX) for r in p.ranges)


def host_syncs(d):
    """Host syncs an iteration: the `ga:sync.*` ranges over the profiled
    iterations; None where the program opened no `ga:` range."""
    if not _has_spans(d.profiled):
        return None
    return sum(s["n"] for s in sync_sites(d.profiled).values())


def sync_wait_ms(d):
    """Host milliseconds an iteration inside the `ga:sync.*` ranges (the
    host blocked until the device reached the sync); None where the
    program opened no `ga:` range."""
    if not _has_spans(d.profiled):
        return None
    return sum(s["wait_ms"] for s in sync_sites(d.profiled).values())


def sync_idle_ms(d):
    """Device-idle milliseconds an iteration that the host syncs cause
    (`sync_sites`); None where there is no sync range or no device
    activity."""
    idle = [s["idle_ms"] for s in sync_sites(d.profiled).values()]
    if not idle or None in idle:
        return None
    return sum(idle)


def span_ms(span: str):
    """A reader of the host milliseconds an iteration inside the ranges
    `ga:<span>`; None where there are none."""
    def read(d):
        p = d.profiled
        found = _ranges(p, lambda n: n == PREFIX + span)
        if not found:
            return None
        return 1e-3 * sum(b - a for a, b, _ in found) / p.iterations
    return read


def launches(root: str):
    """A reader of the launches of device work (kernels, copies, sets: the
    runtime and driver calls whose correlation id names device activity)
    an iteration inside the ranges `ga:<root>`, on any thread; None where
    there is no such range or no device activity."""
    def read(d):
        p = d.profiled
        roots = _ranges(p, lambda n: n == PREFIX + root)
        if not roots or not p.by_corr:
            return None
        n = 0
        for a, b, _ in roots:
            lo = bisect.bisect_left(p.launch_ts, a)
            hi = bisect.bisect_left(p.launch_ts, b)
            n += sum(1 for _, _, corr in p.launches[lo:hi]
                     if corr in p.by_corr)
        return n / p.iterations
    return read


def idle_by_span(p) -> list:
    """The device's idle seconds in the profiled window, each gap put down
    to the innermost `ga:` range open at its start ("other" outside them):
    [(span, seconds)], the largest first. Empty without device activity."""
    merged = _device_busy(p)
    win = _ranges(p, lambda n: n == "bench:window")
    if not merged or not win:
        return []
    w0, w1, _ = win[0]
    spans = _ranges(p, lambda n: n.startswith(PREFIX))
    gaps = defaultdict(float)
    edges = [w0] + [x for a, b in merged for x in (a, b)] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        name = "other"
        for s, e, n in spans:
            if s > a:
                break
            if a < e:
                name = n[len(PREFIX):]     # the latest to open: innermost
        gaps[name] += (b - a) * 1e-6
    return sorted(gaps.items(), key=lambda kv: -kv[1])
