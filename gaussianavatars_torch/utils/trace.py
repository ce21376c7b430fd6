"""Host spans and counters of the hot path.

Every stage of a train step, a render and a frame's conversion for the
wire runs inside `with span(name, mark):`. The roots are "train_step" and
"render" ("rasterize" and "to_wire" when called on their own). Under a
root: "flame_frames" (FLAME at the timestep and the face frames),
"binding", and "rasterize" with "projection", "binning", "pack_gather",
"blend" (K1) and "composite"; in a step also "forward" (the loss stack,
with "flame_reg"), "backward" (with "blend_bwd", K2's launch), "adam" and
"stats". Each host sync of the hot path runs inside `sync(name)`, a span
of kind "sync" whose name starts with "sync." and that adds 1 to the
counter "host_syncs": the FLAME skinning's copy from the host
("sync.lbs_row"), the binning's slot count and compaction ("sync.slots",
"sync.keep") and `to_wire`'s copy to the host ("sync.to_host").

Three things may watch a span, each without the others:

- the tracer, once `start()`ed, keeps every span's name, kind, start and
  end (`time.perf_counter_ns`), parent, iteration id (one per root span,
  so one per step or render call) and counters in memory, until `drain()`
  hands out the closed records. Self time is computed when read
  (`self_ns`, `totals`), not while the spans run.
- an active `torch.profiler`: the span opens the range `ga:<name>`, so
  the profiler's trace names the host work around every device gap.
  `Tracer.wall_ns` puts a record on that trace's clock (`ts` microseconds
  after `baseTimeNanoseconds`, on the wall clock).
- `mark`, the caller's per-stage hook (the benchmark's host clock, the
  chip smoke test's CUDA events): called with the span's name when the
  span ends without an exception.

With none of them, `span` and `sync` return one shared null context:
nothing is allocated and no clock is read. Spans come from one thread at
a time: autograd's device thread runs K2's span while the issuing thread
waits inside "backward".
"""

from __future__ import annotations

import time

from torch.autograd import _profiler_enabled
from torch.autograd.profiler import record_function

STAGE, SYNC = "stage", "sync"
HOST_SYNCS = "host_syncs"
RANGE_PREFIX = "ga:"


class Record:
    """One span: times in `time.perf_counter_ns`, `end_ns` None while
    open, `parent` the enclosing span's record (None for a root)."""

    __slots__ = ("name", "kind", "parent", "iteration", "counters",
                 "start_ns", "end_ns")

    def __init__(self, name: str, kind: str, parent, iteration: int):
        self.name, self.kind = name, kind
        self.parent, self.iteration = parent, iteration
        self.counters: dict = {}
        self.start_ns = self.end_ns = None

    @property
    def duration_ns(self) -> int:
        return self.end_ns - self.start_ns


class Tracer:
    """The records of the spans since `start()` or the last `drain()`, and
    one pair of clocks read together, to put them on the wall clock."""

    def __init__(self):
        self.perf0_ns, self.wall0_ns = time.perf_counter_ns(), time.time_ns()
        self.records: list[Record] = []     # in the order they opened
        self.open: list[Record] = []
        self.iterations = 0                 # root spans opened

    def wall_ns(self, t_ns: int) -> int:
        """A `perf_counter_ns` reading on the wall clock (`time_ns`)."""
        return self.wall0_ns + (t_ns - self.perf0_ns)

    def _open(self, name: str, kind: str) -> Record:
        parent = self.open[-1] if self.open else None
        if parent is None:
            self.iterations += 1
        rec = Record(name, kind, parent, self.iterations)
        self.records.append(rec)
        self.open.append(rec)
        rec.start_ns = time.perf_counter_ns()
        return rec

    def _close(self, rec: Record):
        rec.end_ns = time.perf_counter_ns()
        self.open.remove(rec)

    def drain(self) -> list[Record]:
        done = [r for r in self.records if r.end_ns is not None]
        self.records = [r for r in self.records if r.end_ns is None]
        return done


_tracer: Tracer | None = None


def start() -> Tracer:
    """Start keeping records (the running tracer if there is one)."""
    global _tracer
    if _tracer is None:
        _tracer = Tracer()
    return _tracer


def stop() -> Tracer | None:
    """Stop keeping records; returns the tracer with what it kept."""
    global _tracer
    tracer, _tracer = _tracer, None
    return tracer


def active() -> Tracer | None:
    return _tracer


def drain() -> list[Record]:
    """The closed records since the last drain, removed from the tracer
    (none when no tracer runs)."""
    return [] if _tracer is None else _tracer.drain()


class _Null:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()


class _Span:
    __slots__ = ("tracer", "name", "kind", "mark", "rec", "range")

    def __init__(self, tracer, name: str, kind: str, mark):
        self.tracer, self.name, self.kind, self.mark = tracer, name, kind, mark
        self.rec = None
        self.range = (record_function(RANGE_PREFIX + name)
                      if _profiler_enabled() else None)

    def __enter__(self):
        if self.range is not None:
            self.range.__enter__()
        if self.tracer is not None:
            self.rec = self.tracer._open(self.name, self.kind)
            if self.kind == SYNC:
                self.rec.counters[HOST_SYNCS] = 1
        return self

    def __exit__(self, exc_type, exc, tb):
        if self.rec is not None:
            self.tracer._close(self.rec)
        if self.range is not None:
            self.range.__exit__(exc_type, exc, tb)
        if self.mark is not None and exc_type is None:
            self.mark(self.name)
        return False


def span(name: str, mark=None):
    """The context of one stage; `mark(name)` is called as it ends."""
    if _tracer is None and mark is None and not _profiler_enabled():
        return _NULL
    return _Span(_tracer, name, STAGE, mark)


def sync(name: str):
    """The context of one host sync (`name` starts with "sync."): a span
    of kind "sync" that counts 1 in "host_syncs"."""
    if _tracer is None and not _profiler_enabled():
        return _NULL
    return _Span(_tracer, name, SYNC, None)


# ---- reading the records -------------------------------------------------

def self_ns(records: list[Record]) -> list[int]:
    """Each record's self time: its duration less the part of it that
    its children in `records` cover."""
    children: dict[int, list] = {}
    for r in records:
        if r.parent is not None:
            children.setdefault(id(r.parent), []).append(
                (r.start_ns, r.end_ns))
    out = []
    for r in records:
        covered, end = 0, r.start_ns
        for a, b in sorted(children.get(id(r), ())):
            a, b = max(a, end), min(b, r.end_ns)
            if b > a:
                covered += b - a
                end = b
        out.append(r.duration_ns - covered)
    return out


def totals(records: list[Record]) -> dict:
    """Per span name: the spans (`n`), their summed milliseconds (`ms`)
    and self milliseconds (`self_ms`) and their summed counters."""
    out: dict = {}
    for r, s in zip(records, self_ns(records)):
        t = out.setdefault(r.name, {"n": 0, "ms": 0.0, "self_ms": 0.0})
        t["n"] += 1
        t["ms"] += r.duration_ns * 1e-6
        t["self_ms"] += s * 1e-6
        for k, v in r.counters.items():
            t[k] = t.get(k, 0) + v
    return out
