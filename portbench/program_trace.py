"""The program's own tracer (``mistra_tpu_torch.utils.profiling``), read
by the per-layer metrics whose source is a program span or counter.

Importing this module turns the tracer on and keeps its records: the
harness imports the readers, and so this module, only in a traced run
and before it builds the model, so the set-up's spans are recorded and
an untraced run is never traced.  Where the program has no such tracer,
every function here returns None.

The window: the records of the window's minutes, those of the last
``trace["minutes"]`` ``minute`` spans that no other span holds (the
window runs whole minutes, last in the run).
"""

from __future__ import annotations

try:
    from mistra_tpu_torch.utils import profiling as _profiling
except ImportError:
    _profiling = None

ON = all(hasattr(_profiling, f) for f in ("enable", "collect"))
if ON:
    _profiling.enable(records=True)


def records() -> list | None:
    """Every kept record of the program's spans (``profiling.collect``),
    oldest first, or None without a tracer."""
    return _profiling.collect() if ON else None


def window(trace: dict) -> list | None:
    """The records of the window's minutes, or None where the program
    recorded fewer minutes than the window ran."""
    minutes = trace["minutes"]
    recs = records()
    if not recs or minutes <= 0:
        return None
    roots = [r for r in recs if r["name"] == "minute" and r["parent"] is None]
    if len(roots) < minutes:
        return None
    ordinals = {r["minute"] for r in roots[-minutes:]}
    return [r for r in recs if r["minute"] in ordinals]


def ms_per_minute(trace: dict, names) -> float | None:
    """Milliseconds per window minute in the spans named ``names``."""
    recs = window(trace)
    if recs is None:
        return None
    return 1e3 * sum(r["seconds"] for r in recs
                     if r["name"] in names) / trace["minutes"]


def first(name: str) -> dict | None:
    """The first record of a span named name that no other span holds."""
    for r in records() or ():
        if r["name"] == name and r["parent"] is None:
            return r
    return None
