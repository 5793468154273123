"""Tracing / profiling of the PyTorch port.

- ``span(name)``: a named interval of the program (a context manager):
  its start and end, its parent span, and the minute it belongs to (the
  ordinal of the enclosing ``minute`` span).  Off by default.
- ``count(name, n=1)``: a counter, attributed to the innermost open span
  (the step counts its host syncs as ``sync.<site>``).
- ``trace(logdir)``: capture a ``torch.profiler`` trace of a code block,
  the host's operators and the card's kernels, exported as a Chrome
  trace (viewable in Perfetto or chrome://tracing).  While a profiler
  records, every span is also a ``record_function`` range (``annotate``),
  so the program's operators are named on the timeline.

Off, ``span`` returns one shared object that does nothing and ``count``
tests one attribute: nothing is allocated, synchronised or launched.

On, the tracer never synchronises the device itself.  Where the card is
in use, a span's time is that of a pair of timing ``torch.cuda.Event``s
recorded at its ends, so it holds the device work the span queued; their
elapsed times are read once the end event has completed (``Event.query``)
or when a consumer collects the records.  On the CPU a span's time is
that of its host stamps.

The shared clock: host stamps are ``time.time_ns()``, the Unix-epoch
nanoseconds on which ``torch.profiler`` places its events (microseconds
after ``prof.profiler.kineto_results.trace_start_ns()``); ``collect``
places the device events on it too, through one event recorded on the
idle device at the time of the call.

Memory: per-name aggregates (calls, seconds, self seconds, counter
totals) are kept for the whole run; the raw records of the spans are
kept only while a consumer asks for them (``enable(records=True)``,
``tracing(records=True)``).  A span's self time is its time less the time
of its children (which lie inside it and one after another on either
clock).
"""

from __future__ import annotations

import collections
import contextlib
import os
import time

import torch

# the name of the span that opens a minute: every span inside it carries
# the minute's ordinal
MINUTE = "minute"
# closed spans left waiting for their device times before the tracer
# reads those that have completed (besides at the close of every root)
_PENDING_MAX = 4096


def _synchronize():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a torch.profiler trace of the enclosed block into
    ``logdir/trace_<pid>_<ns>.json`` (Chrome trace format): the host's
    operators and, on a host with a card, the card's kernels.  Yields
    the profiler."""
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(logdir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        _synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def annotate(name: str):
    """Named range visible in profiler timelines."""
    return torch.profiler.record_function(name)


class _NoSpan:
    """The span of a tracer that is off: does nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("tracer", "name", "id", "parent", "minute", "host0",
                 "host1", "ev0", "ev1", "range", "counts", "child_ns",
                 "ns", "start", "end")

    def __init__(self, tracer, name):
        self.tracer = tracer
        self.name = name
        self.counts = None
        self.child_ns = 0.0
        self.start = None

    def __enter__(self):
        t = self.tracer
        t._next_id += 1
        self.id = t._next_id
        self.parent = t._stack[-1] if t._stack else None
        if self.name == MINUTE:
            t._minutes += 1
            t.minute = t._minutes
        self.minute = t.minute
        self.range = None
        self.host0 = time.time_ns()
        if torch._C._autograd._profiler_enabled():
            self.range = annotate(self.name)
            self.range.__enter__()
        self.ev0 = self.ev1 = None
        if torch.cuda.is_initialized():
            self.ev0 = t._event()
            self.ev0.record()
        t._stack.append(self)
        return self

    def __exit__(self, *exc):
        t = self.tracer
        if self.ev0 is not None:
            self.ev1 = t._event()
            self.ev1.record()
        if self.range is not None:
            self.range.__exit__(None, None, None)
            self.range = None
        self.host1 = time.time_ns()
        t._stack.pop()
        if self.name == MINUTE:
            t.minute = self.parent.minute if self.parent is not None \
                else None
        t._closed.append(self)
        if self.parent is None or len(t._closed) > _PENDING_MAX:
            t._resolve(wait=False)
        return False


class Tracer:
    """Spans and counters of the program (one per process: ``TRACER``)."""

    def __init__(self):
        self.on = False
        self.minute = None
        self._keep = 0
        self._minutes = 0
        self._next_id = 0
        self._stack = []
        self._closed = collections.deque()
        self._kept = []
        self._events = []
        self._totals = {}

    # -- the program's side --------------------------------------------
    def span(self, name: str):
        """A span named name (a context manager)."""
        if not self.on:
            return _NO_SPAN
        return _Span(self, name)

    def count(self, name: str, n: int = 1) -> None:
        """Add n to the counter name, in the innermost open span."""
        if not self.on:
            return
        owner = self._stack[-1] if self._stack else None
        if owner is not None:
            if owner.counts is None:
                owner.counts = {}
            owner.counts[name] = owner.counts.get(name, 0) + n
        counts = self._total(owner.name if owner is not None else None)[3]
        counts[name] = counts.get(name, 0) + n

    # -- the consumer's side -------------------------------------------
    def enable(self, records: bool = False) -> None:
        """Turn the tracer on; with records, keep the record of every
        span that closes from now on (for a consumer that reads them
        until the process ends)."""
        self.on = True
        if records:
            self._keep += 1

    def disable(self) -> None:
        """Turn the tracer off; the records and aggregates stay."""
        self.on = False

    def reset(self) -> None:
        """Forget every record, aggregate and minute ordinal (the tracer
        must have no open span)."""
        self._resolve(wait=True)
        self._keep = 0
        self._minutes = 0
        self.minute = None
        self._kept = []
        self._totals = {}

    def collect(self) -> list:
        """The kept records, oldest first, each a dict: ``name``, ``id``,
        ``parent`` (the parent's id or None), ``minute`` (the ordinal or
        None), ``start``/``end`` (ns on the shared clock: the device's
        events where the card was in use, else the host stamps),
        ``host_start``/``host_end`` (the host stamps), ``seconds``,
        ``self_seconds`` and ``counts`` ({counter: n} inside the span
        and not in a child).  Waits for the device once."""
        self._resolve(wait=True)
        pending = [s for s in self._kept if s.start is None]
        if any(s.ev0 is not None for s in pending):
            torch.cuda.synchronize()
            anchor = torch.cuda.Event(enable_timing=True)
            h0 = time.time_ns()
            anchor.record()
            anchor.synchronize()
            now = 0.5 * (h0 + time.time_ns())
        for s in pending:
            if s.ev0 is None:
                s.start, s.end = s.host0, s.host1
            else:
                s.start = now - 1e6 * s.ev0.elapsed_time(anchor)
                s.end = now - 1e6 * s.ev1.elapsed_time(anchor)
                s.ev0 = s.ev1 = None
        return [{"name": s.name, "id": s.id,
                 "parent": s.parent.id if s.parent is not None else None,
                 "minute": s.minute, "start": s.start, "end": s.end,
                 "host_start": s.host0, "host_end": s.host1,
                 "seconds": 1e-9 * s.ns,
                 "self_seconds": 1e-9 * (s.ns - s.child_ns),
                 "counts": dict(s.counts or {})} for s in self._kept]

    def summary(self) -> dict:
        """{span name: {"calls", "seconds", "self_seconds", "counts"}} over
        everything traced so far; counters counted outside every span
        are under the name None.  Waits for the device once."""
        self._resolve(wait=True)
        return {name: {"calls": c, "seconds": 1e-9 * ns,
                       "self_seconds": 1e-9 * self_ns,
                       "counts": dict(counts)}
                for name, (c, ns, self_ns, counts) in self._totals.items()}

    # -- inside ----------------------------------------------------------
    def _total(self, name):
        agg = self._totals.get(name)
        if agg is None:
            agg = self._totals[name] = [0, 0.0, 0.0, {}]
        return agg

    def _event(self):
        return self._events.pop() if self._events else torch.cuda.Event(
            enable_timing=True)

    def _resolve(self, wait: bool) -> None:
        """Read the times of the closed spans, oldest first, up to the
        first whose end event has not completed (with wait: all)."""
        closed = self._closed
        while closed:
            s = closed[0]
            if s.ev1 is not None:
                if not wait and not s.ev1.query():
                    return
                if wait:
                    s.ev1.synchronize()
                s.ns = 1e6 * s.ev0.elapsed_time(s.ev1)
            else:
                s.ns = float(s.host1 - s.host0)
            closed.popleft()
            if s.parent is not None:
                s.parent.child_ns += s.ns
            agg = self._total(s.name)
            agg[0] += 1
            agg[1] += s.ns
            agg[2] += s.ns - s.child_ns
            if self._keep:
                self._kept.append(s)
            else:
                if s.ev1 is not None:
                    self._events += (s.ev0, s.ev1)
                    s.ev0 = s.ev1 = None
                s.parent = None


TRACER = Tracer()
span = TRACER.span
count = TRACER.count
enable = TRACER.enable
disable = TRACER.disable
reset = TRACER.reset
collect = TRACER.collect
summary = TRACER.summary


@contextlib.contextmanager
def tracing(records: bool = False):
    """The tracer on inside the block, with records keeping the records
    of the spans that close in it; as it was before, after it."""
    was, keep = TRACER.on, TRACER._keep
    TRACER.enable(records)
    try:
        yield TRACER
    finally:
        TRACER.on = was
        TRACER._keep = keep
