"""The readers of the program's own spans and counters
(``program_trace``) on hand-made tracer records."""

from __future__ import annotations

import pytest

from portbench import program_trace, registry

MS = 1e-3


def _rec(i, name, parent, minute, seconds, counts=None):
    return {"name": name, "id": i, "parent": parent, "minute": minute,
            "start": 0.0, "end": 0.0, "host_start": 0, "host_end": 0,
            "seconds": seconds, "self_seconds": seconds,
            "counts": counts or {}}


def _minute(first_id, ordinal, chem=True):
    """One minute's records: 6 substeps, each with kon (3 Newton checks)
    and, with chem, the chemistry operators and solve; the photolysis on
    even minutes; 10 ms each but the solve's parts."""
    out, i, root = [], first_id, first_id
    i += 1
    for _ in range(6):
        sub = i
        i += 1
        out.append(_rec(i, "kon", sub, ordinal, 10 * MS,
                        {"sync.newton": 3}))
        i += 1
        if chem:
            for name in ("difc", "konc", "sedl", "feedback"):
                out.append(_rec(i, name, sub, ordinal, 10 * MS))
                i += 1
            solve = i
            i += 1
            out.append(_rec(i, "liq_parm", solve, ordinal, 2 * MS))
            out.append(_rec(i + 1, "rate_constants", solve, ordinal, 3 * MS))
            out.append(_rec(i + 2, "ros3_tot", solve, ordinal, 50 * MS,
                            {"sync.ros3": 20}))
            out.append(_rec(i + 3, "rate_constants", solve, ordinal, 1 * MS))
            i += 4
            out.append(_rec(solve, "chem_solve", sub, ordinal, 60 * MS))
        out.append(_rec(sub, "substep", root, ordinal, 100 * MS))
    if chem and ordinal % 2 == 0:
        out.append(_rec(i, "photolysis", root, ordinal, 40 * MS))
        i += 1
    out.append(_rec(root, "minute", None, ordinal, 1.0,
                    {"sync.photolysis": 1} if chem else {}))
    return out, i + 1


def _run(minutes, chem=True):
    recs = [_rec(1, "init_state", None, None, 2.5),
            _rec(2, "init_state", None, None, 9.0)]
    i = 3
    for m in range(1, minutes + 1):
        got, i = _minute(i, m, chem)
        recs += got
    return recs


@pytest.fixture
def records(monkeypatch):
    def use(recs):
        monkeypatch.setattr(program_trace, "records", lambda: recs)
    return use


def _read(name, trace):
    return registry.metric_reader(name).read(trace)


def test_window_is_the_last_minutes(records):
    records(_run(5))
    got = program_trace.window({"minutes": 2})
    assert {r["minute"] for r in got} == {4, 5}
    assert sum(r["name"] == "minute" for r in got) == 2
    assert program_trace.window({"minutes": 6}) is None
    assert program_trace.window({"minutes": 0}) is None


def test_ms_per_minute_readers(records):
    records(_run(4))
    trace = {"minutes": 2}
    # 6 substeps x 4 operators x 10 ms
    assert _read("chem_ops_ms_per_min", trace) == pytest.approx(240.0)
    assert _read("liq_parm_ms_per_min", trace) == pytest.approx(12.0)
    assert _read("rate_constants_ms_per_min", trace) == pytest.approx(24.0)
    # one of the two minutes recomputes the J-rates
    assert _read("photolysis_ms_per_min", trace) == pytest.approx(20.0)


def test_host_syncs_per_substep(records):
    records(_run(3))
    # 3 Newton and 20 Ros3 checks per substep, one photolysis check per
    # minute of 6 substeps
    assert _read("host_syncs_per_substep", {"minutes": 3}) == \
        pytest.approx(23 + 1 / 6)
    records(_run(3, chem=False))
    assert _read("host_syncs_per_substep", {"minutes": 1}) == 3.0


def test_init_state_is_the_first(records):
    records(_run(1))
    assert _read("init_state_s", {"minutes": 1}) == 2.5


@pytest.mark.parametrize("name", [
    "chem_ops_ms_per_min", "liq_parm_ms_per_min",
    "rate_constants_ms_per_min", "photolysis_ms_per_min",
    "host_syncs_per_substep", "init_state_s"])
def test_nothing_to_read_gives_none(records, name):
    """A program without the tracer (records None) or without records
    reads None, and raises nothing."""
    records(None)
    assert _read(name, {"minutes": 2}) is None
    records([])
    assert _read(name, {"minutes": 2}) is None
