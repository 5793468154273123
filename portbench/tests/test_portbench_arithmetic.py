"""The yardstick's arithmetic on hand-made intervals, shapes and traces."""

from __future__ import annotations

import pytest
import torch

from portbench import registry, roofline, trace


def test_busy_union_of_overlapping_intervals():
    iv = [(0.0, 10.0), (5.0, 12.0), (20.0, 25.0), (21.0, 22.0), (30, 30)]
    assert trace.busy_seconds(iv) == 17.0
    assert trace.busy_seconds([]) == 0.0
    assert trace.busy_seconds([(3.0, 4.0), (0.0, 1.0)]) == 2.0


def test_idle_gaps_are_the_complement():
    iv = [(2.0, 4.0), (3.0, 6.0), (8.0, 9.0)]
    assert trace.idle_gaps(iv, 0.0, 10.0) == [(0.0, 2.0), (6.0, 8.0),
                                              (9.0, 10.0)]
    gaps = trace.idle_gaps(iv, 0.0, 10.0)
    assert sum(b - a for a, b in gaps) + trace.busy_seconds(iv) == 10.0


def test_least_seconds_takes_the_larger_bound():
    # 3.35e12 bytes take 1 s; 67e12 operations take 1 s
    assert roofline.least_seconds(3.35e12, 1.0, "float32") == 1.0
    assert roofline.least_seconds(1.0, 2 * 67e12, "float64") == 2.0


def test_bott_bounds_count_bytes_once():
    rows, nkt, sig = 1000, 70, 500
    ops = 4 * rows * nkt + 100 * sig
    assert roofline.bott_advect_seconds(rows, nkt, sig, 4, "float32") == \
        pytest.approx(max(3 * rows * nkt * 4 / 3.35e12, ops / 67e12))
    assert roofline.bott_dwsum_seconds(rows, nkt, sig, 8, "float64") == \
        pytest.approx(max((2 * rows * nkt + nkt + rows) * 8 / 3.35e12,
                          ops / 67e12))


def test_inverse_bound():
    n, m = 12672, 80
    # reads and writes n m^2 doubles: bytes bound 2 n m^2 8 / 3.35e12
    assert roofline.inverse_seconds(n, m, 8, "float64") == pytest.approx(
        max(2 * n * m * m * 8 / 3.35e12, 2.0 * n * m ** 3 / 67e12))
    # the multiphase blocks: 0.387 ms of bytes (PERF.md's table)
    assert roofline.inverse_seconds(n, m, 8, "float64") == pytest.approx(
        3.874e-4, rel=1e-3)


def _profile(**kw):
    p = {"wall_s": 2.0, "busy_s": 0.5, "events": 10, "idle": {},
         "kernels": {"void bott_dwsum_kernel<float>(x)": 0.004,
                     "void bott_advect_kernel<float>(x)": 0.002,
                     "gj_inverse_kernel<double, 3, 10>": 0.01,
                     "elementwise": 0.4}}
    p.update(kw)
    return p


def _trace(profile=None, **kw):
    t = {"minutes": 4, "substeps": 24,
         "span_ms": {"radiation": [150.0, 250.0], "kon": [10.0, 30.0]},
         "span_calls": {"radiation": 4, "kon": 24, "substep": 24},
         "launches": {"bott_dwsum": 48},
         "records": {"bott_dwsum": [(1000, 70, 500, 4, "float32")],
                     "bott_advect": [],
                     "inverse": [(64, 80, 8, "float64")] * 2,
                     "ros3_tot": [], "ros3_gas": []},
         "profile": profile}
    t.update(kw)
    return t


def read(name, t):
    return registry.metric_reader(name).read(t)


def test_readers_on_a_hand_made_trace():
    t = _trace(_profile())
    assert read("device_idle_pct", t) == pytest.approx(75.0)
    assert read("bott_dwsum_roofline_pct", t) == pytest.approx(
        100.0 * roofline.bott_dwsum_seconds(1000, 70, 500, 4, "float32")
        / 0.004)
    assert read("bott_advect_roofline_pct", t) is None     # no launch
    assert read("gj_inverse_roofline_pct", t) == pytest.approx(
        100.0 * 2 * roofline.inverse_seconds(64, 80, 8, "float64") / 0.01)
    assert read("newton_iters_per_substep", t) == 2.0
    assert read("ros3_iters_per_substep", t) is None
    assert read("radiation_ms_per_min", t) == 200.0     # once a minute
    assert read("growth_ms_per_min", t) == 120.0        # once a substep
    assert read("chem_solve_ms_per_min", t) is None


def test_readers_find_nothing_without_a_profile():
    t = _trace(None, span_ms={}, launches={},
               records={"ros3_tot": [7, 3] * 12, "ros3_gas": [2] * 24})
    for name in ("device_idle_pct", "bott_dwsum_roofline_pct",
                 "gj_inverse_roofline_pct", "newton_iters_per_substep",
                 "radiation_ms_per_min"):
        assert read(name, t) is None
    assert read("ros3_iters_per_substep", t) == 7.0


def test_spans_nest_and_name_the_innermost():
    spans = trace.Spans(cuda=False)
    spans.call("minute", lambda: spans.call("kon", lambda: None))
    names = [r[0] for r in spans.records]
    assert names == ["kon", "minute"]
    kon, minute = spans.records
    assert kon[3] > minute[3]
    assert spans.innermost(0.5 * (kon[1] + kon[2])) == "kon"
    assert spans.innermost(minute[2] + 1.0) == "outside_spans"
    ms = spans.synced_ms()
    assert set(ms) == {"kon", "minute"} and len(ms["kon"]) == 1


def test_instrument_installs_what_readers_declare_and_undoes_it():
    import sys
    import types

    class Kernel:
        def integrate(self, y):
            return y, {"nsteps": torch.tensor([3, 5])}

    class Model:
        def __init__(self):
            self.kernel = Kernel()

        def substep(self, s):
            return self.kernel.integrate(s)[0]

    mod = types.ModuleType("portbench_test_kernels")

    def launch(x):
        mod.launch.launches += 1     # counts on the module's name
        return x
    launch.launches = 0
    mod.launch = launch
    sys.modules[mod.__name__] = mod
    reader = types.SimpleNamespace(
        SPANS={"solve": "model:kernel.integrate",
               "absent": "model:nothing.here"},
        LAUNCHES={"launch": "portbench_test_kernels:launch"},
        RECORDS={"steps": {"target": "model:kernel.integrate",
                           "take": lambda a, kw, out: out[1]["nsteps"].max()},
                 "sliced": {"target": "portbench_test_kernels:launch",
                            "take": lambda a, kw, out: a[0], "slice": True}})
    model = Model()
    spans = trace.Spans(cuda=False)
    handle = trace.instrument(model, spans, trace.Profile(spans), [reader])
    try:
        model.substep(1)
        mod.launch(2)
        model.substep(1)
        data = trace.collect(handle, spans)
    finally:
        trace.undo(handle)
        del sys.modules[mod.__name__]
    assert data["launches"] == {"launch": 1}
    assert data["records"] == {"steps": [5, 5], "sliced": []}  # no slice
    assert data["span_calls"] == {"solve": 2, "substep": 2}
    assert "integrate" not in vars(model.kernel)
    assert "substep" not in vars(model)
    assert mod.launch is launch and launch.launches == 1
