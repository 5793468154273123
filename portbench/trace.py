"""What the ``--trace 1`` run records, from outside the program.

* Spans: host-clock intervals around calls into the program's layers,
  recorded by wrappers that the run installs (``instrument``) and takes
  out again.  Outside the profiled slice each span is synchronised
  (``torch.cuda.synchronize()`` at both ends), so that its length holds
  the device work it queued; inside the slice the spans only read the
  host clock, and name what the host was doing while the device idled.
* Counters and records: the program's own launch counters, and values
  taken from the calls of a target (the Ros3 infos that
  ``GasKernel.integrate`` returns, a kernel's input shapes).
* What is wrapped is declared by the per-layer metrics' readers
  (``SPANS``, ``LAUNCHES``, ``RECORDS``; ``instrument``), so a new metric
  brings its own spans and counters in its own file.
* The profiled slice: ``torch.profiler`` with CUDA activity only, over a
  fixed stretch at the start of the window, bracketed by two marker
  kernels that tie the device's clock to the host's.

``busy_seconds`` is frozen: copied from ``chip_smoke.profile_call``
(chip_smoke.py:693-700, commit b2518445).
"""

from __future__ import annotations

import time

import torch


def busy_seconds(intervals) -> float:
    """Length of the union of [start, end) intervals, in the intervals'
    unit (chip_smoke.profile_call's sweep)."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def idle_gaps(intervals, lo: float, hi: float) -> list:
    """[(start, end)] of the time in [lo, hi) that no interval covers."""
    gaps, end = [], lo
    for a, b in sorted(intervals):
        if a > end:
            gaps.append((end, min(a, hi)))
        end = max(end, b)
    if end < hi:
        gaps.append((end, hi))
    return [(a, b) for a, b in gaps if b > a]


class Spans:
    """Span records (name, host start, host end, depth, synced)."""

    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.sync = True
        self.records = []
        self.depth = 0

    def _now(self, synced):
        if synced and self.cuda:
            torch.cuda.synchronize()
        return time.perf_counter()

    def call(self, name, fn, *args, **kw):
        synced = self.sync
        t0 = self._now(synced)
        self.depth += 1
        try:
            out = fn(*args, **kw)
        finally:
            self.depth -= 1
        self.records.append((name, t0, self._now(synced), self.depth,
                             synced))
        return out

    def wrap(self, name, fn):
        def spanned(*args, **kw):
            return self.call(name, fn, *args, **kw)
        return spanned

    def synced_ms(self) -> dict:
        """{name: [ms of each synchronised span of that name]}."""
        out = {}
        for name, t0, t1, _, synced in self.records:
            if synced:
                out.setdefault(name, []).append(1e3 * (t1 - t0))
        return out

    def innermost(self, h: float) -> str:
        """Name of the deepest span open at host time h."""
        best, depth = "outside_spans", -1
        for name, t0, t1, d, _ in self.records:
            if t0 <= h < t1 and d > depth:
                best, depth = name, d
        return best


class Profile:
    """The profiled slice: ``start`` and ``stop`` around it."""

    def __init__(self, spans: Spans):
        self.spans = spans
        self.prof = None
        self.open = False
        self.done = False
        self.host = None

    def _marker(self):
        t = time.perf_counter()
        torch.ones(1, device="cuda").add_(1.0)
        return t

    def start(self):
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        self.spans.sync = False
        self.open = True
        self.host = [self._marker(), None]

    def stop(self):
        self.host[1] = self._marker()
        torch.cuda.synchronize()
        self.host.append(time.perf_counter())
        self.prof.stop()
        self.open = False
        self.done = True
        self.spans.sync = True

    def summary(self) -> dict | None:
        """The slice's device numbers: wall and busy seconds, device
        seconds by kernel name, and the idle time by the innermost span
        that the host had open."""
        from torch.autograd import DeviceType
        if self.prof is None:
            return None
        events = sorted((e.time_range.start, e.time_range.end, e.name)
                        for e in self.prof.events()
                        if e.device_type == DeviceType.CUDA)
        if len(events) < 2:
            return None
        m0, m1 = events[0], events[-1]     # the two markers
        inside = events[1:-1]
        spans = [(a, b) for a, b, _ in inside]
        wall = self.host[2] - self.host[0]
        by_name = {}
        for a, b, name in inside:
            by_name[name] = by_name.get(name, 0.0) + (b - a) * 1e-6
        # device clock (us) to host clock (s): the markers' launches
        scale = ((self.host[1] - self.host[0]) / ((m1[0] - m0[0]) * 1e-6)
                 if m1[0] > m0[0] else 1.0)

        def host_of(d):
            return self.host[0] + (d - m0[0]) * 1e-6 * scale

        idle = {}
        for a, b in idle_gaps(spans, m0[1], m1[0]):
            name = self.spans.innermost(host_of(0.5 * (a + b)))
            idle[name] = idle.get(name, 0.0) + (b - a) * 1e-6
        return {"wall_s": wall, "busy_s": busy_seconds(spans) * 1e-6,
                "events": len(inside), "kernels": by_name,
                "idle": idle}


def kernel_seconds(profile: dict, key: str) -> float:
    """Device seconds of the kernels whose name holds key."""
    return sum(s for name, s in profile["kernels"].items() if key in name)


def resolve(model, target: str):
    """(owner, attribute, value) of a target ``"<where>:<a.b.c>"``:
    ``where`` is ``model`` (the attributes from the model instance on) or
    a module of the program; None where a part is missing."""
    import importlib
    where, path = target.split(":")
    try:
        obj = model if where == "model" else importlib.import_module(where)
    except ImportError:
        return None
    *parents, attr = path.split(".")
    for part in parents:
        obj = getattr(obj, part, None)
        if obj is None:
            return None
    value = getattr(obj, attr, None)
    return None if value is None else (obj, attr, value)


class Wrapped:
    """A callable put in the place of ``obj``: calls go to ``call``, and
    every other attribute is read from and written to ``obj`` (so that a
    function's own counters, such as ``launches``, keep counting)."""

    def __init__(self, obj, call):
        object.__setattr__(self, "_obj", obj)
        object.__setattr__(self, "_call", call)

    def __call__(self, *args, **kw):
        return self._call(*args, **kw)

    def __getattr__(self, attr):
        return getattr(self._obj, attr)

    def __setattr__(self, attr, value):
        setattr(self._obj, attr, value)


def instrument(model, spans: Spans, profile: Profile, readers) -> dict:
    """Install, for the traced run, what the readers declare:

    * ``SPANS`` ``{name: target}``: a span around every call of target;
    * ``LAUNCHES`` ``{name: target}``: the target's ``launches`` counter,
      read at the window's start and end;
    * ``RECORDS`` ``{name: {"target", "take", "slice"}}``: after every
      call of target (with ``slice``, only inside the profiled slice),
      ``take(args, kwargs, result)`` is kept.

    A target is ``"<module>:<attribute>"`` or ``"model:<attribute>"``
    (``resolve``); one that the model lacks is left out.  The harness's
    own spans, ``minute`` (in ``run``) and ``substep``, are always there.
    Returns the handle that ``collect`` reads and ``undo`` takes out."""
    want_spans = {"substep": "model:substep"}
    launches, records = {}, {}
    for reader in readers:
        want_spans.update(getattr(reader, "SPANS", {}))
        launches.update(getattr(reader, "LAUNCHES", {}))
        records.update(getattr(reader, "RECORDS", {}))
    undo, kept = [], {name: [] for name in records}

    def patch(target, make):
        found = resolve(model, target)
        if found is None:
            return
        owner, attr, value = found
        undo.append((owner, attr, attr in vars(owner),
                     vars(owner).get(attr)))
        setattr(owner, attr, Wrapped(value, make(value)))

    for name, target in want_spans.items():
        patch(target, lambda fn, name=name: (
            lambda *a, **kw: spans.call(name, fn, *a, **kw)))
    for name, rec in records.items():
        def make(fn, name=name, rec=rec):
            def recorded(*a, **kw):
                out = fn(*a, **kw)
                if profile.open or not rec.get("slice"):
                    kept[name].append(rec["take"](a, kw, out))
                return out
            return recorded
        patch(rec["target"], make)
    counters = {name: resolve(model, target)
                for name, target in launches.items()}
    counters = {k: v[2] for k, v in counters.items() if v is not None}
    return {"undo": undo, "records": kept, "counters": counters,
            "launches0": {k: f.launches for k, f in counters.items()}}


def collect(handle, spans: Spans) -> dict:
    """What the window recorded: the counters' launches since the
    window's start, the records (0-d tensors as numbers) and each span's
    calls."""
    def plain(x):
        if torch.is_tensor(x):
            return x.item()
        if isinstance(x, (tuple, list)):
            return type(x)(plain(v) for v in x)
        return x
    calls = {}
    for name, *_ in spans.records:
        calls[name] = calls.get(name, 0) + 1
    return {"launches": {k: f.launches - handle["launches0"][k]
                         for k, f in handle["counters"].items()},
            "records": {k: [plain(v) for v in vals]
                        for k, vals in handle["records"].items()},
            "span_calls": calls}


def undo(handle) -> None:
    for owner, attr, had, old in reversed(handle["undo"]):
        if had:
            setattr(owner, attr, old)
        else:
            delattr(owner, attr)


def launch_bounds(records, seconds) -> float | None:
    """Least seconds of a kernel's launches in the slice: the sum of
    ``seconds(*row)`` over the recorded rows, or None without a launch."""
    if not records:
        return None
    return sum(seconds(*row) for row in records)
