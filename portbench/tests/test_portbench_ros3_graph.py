"""The reader of ``ros3_graph_iter_pct`` on hand-made tracer records: the
window's ``ros3.graph_iters`` over its ``ros3.iters``, and nothing where
the program counts no Ros3 iteration (a program without the counters, a
cell without chemistry)."""

from __future__ import annotations

import pytest

from portbench import program_trace, registry


def _rec(i, name, parent, minute, counts=None):
    return {"name": name, "id": i, "parent": parent, "minute": minute,
            "start": 0.0, "end": 0.0, "host_start": 0, "host_end": 0,
            "seconds": 0.01, "self_seconds": 0.01, "counts": counts or {}}


def _run(per_minute):
    """A minute per item: its ros3_tot span's counts, under a substep."""
    recs, i = [], 1
    for minute, counts in enumerate(per_minute, start=1):
        recs += [_rec(i + 2, "ros3_tot", i + 1, minute, counts),
                 _rec(i + 1, "substep", i, minute),
                 _rec(i, "minute", None, minute)]
        i += 3
    return recs


@pytest.fixture
def records(monkeypatch):
    def use(recs):
        monkeypatch.setattr(program_trace, "records", lambda: recs)
    return use


def _read(trace):
    return registry.metric_reader("ros3_graph_iter_pct").read(trace)


def test_share_of_the_window(records):
    # the first minute captures (one iteration op by op), the window's
    # two replay every iteration but a quarter of the last
    records(_run([{"ros3.iters": 150, "ros3.graph_iters": 149,
                   "ros3.graph_captures": 1},
                  {"ros3.iters": 140, "ros3.graph_iters": 140},
                  {"ros3.iters": 160, "ros3.graph_iters": 120}]))
    assert _read({"minutes": 2}) == pytest.approx(100.0 * 260 / 300)
    assert _read({"minutes": 1}) == pytest.approx(75.0)


def test_op_by_op_reads_zero(records):
    records(_run([{"ros3.iters": 40}, {"ros3.iters": 30}]))
    assert _read({"minutes": 2}) == 0.0


@pytest.mark.parametrize("recs", [None, [], _run([{}, {"sync.ros3": 9}])])
def test_nothing_to_read_gives_none(records, recs):
    records(recs)
    assert _read({"minutes": 2}) is None
