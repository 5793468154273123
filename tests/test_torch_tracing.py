"""The port's tracer (``utils/profiling.py``: ``span``, ``count``) on the
CPU, on the tiny grid's BTZ96 minute and multiphase minute (the small tot
stand-in, 2 columns, one of them at noon on a minute that recomputes the
J-rates): off it records nothing; on, the minute is bit-equal to the one
traced off, the spans form one ``minute`` tree per minute with the
operators in the step's order, a span's self time is its time less its
children's, the host-sync counters equal the checks of the loops that
make them, and the host stamps lie on ``torch.profiler``'s clock.  The
card test (``gpu``) holds a span's interval on the shared clock against
the kernel it launched and the idle time before it."""

from __future__ import annotations

import json
import time

import pytest
import torch

import mistra_tpu_torch as pt
from _torch_cli import BTZ96 as CLI_BTZ96
from _torch_cli import TINY, write_namelist
from mistra_tpu_torch import cli
from mistra_tpu_torch.chemistry.gas_kernel import GasKernel
from mistra_tpu_torch.chemistry.mech import write_synthetic_tot_mechanism
from mistra_tpu_torch.io.checkpoint import flatten_state
from mistra_tpu_torch.photolysis.tables import \
    write_synthetic_photolysis_tables
from mistra_tpu_torch.physics import growth
from mistra_tpu_torch.physics.surface import write_synthetic_clarke_table
from mistra_tpu_torch.radiation.tables import \
    write_synthetic_radiation_tables
from mistra_tpu_torch.utils import profiling

torch.set_num_threads(1)

TINY_GRID = dict(nf=20, n_extra=10, nka=16, nkt=16, nb=8)
BTZ96 = dict(chem=False, mic=True, tw=288.15, zinv=100.0, dtinv=7.0, ug=8.5,
             vg=0.0, nw_prof_opt=1, wmax=-0.005, z0=0.0001, alat=55.0)
PHYSICS = ["difm", "difp", "kon", "sedp", "equil", "surf0"]
MULTIPHASE = ["difm", "difc", "difp", "kon", "konc", "sedp", "equil",
              "surf0", "sea_salt", "gasdrydep", "sedc", "sedl", "chem_solve",
              "feedback"]
CHEM_SOLVE = ["liq_parm", "rate_constants", "ros3_tot", "rate_constants",
              "ros3_gas"]


@pytest.fixture(autouse=True)
def _tracer_off():
    profiling.disable()
    profiling.reset()
    yield
    profiling.disable()
    profiling.reset()


def _model(tmp, multiphase):
    inp, mech = tmp / "inp", tmp / "mech"
    inp.mkdir()
    write_synthetic_clarke_table(inp)
    write_synthetic_radiation_tables(inp)
    kw = dict(BTZ96, dtype="float64", inpdir=str(inp))
    if multiphase:
        mech.mkdir()
        write_synthetic_photolysis_tables(inp)
        write_synthetic_tot_mechanism(str(mech), 12, 25)
        kw.update(chem=True, nkc_l=4, mechdir=str(mech))
    model = pt.Model(pt.MistraConfig(grid=pt.GridParams(**TINY_GRID), **kw),
                     device="cpu")
    state = model.init_state(2)
    # the second column at noon, and the minute ends on minute 2, when the
    # J-rates are recomputed where the sun is up
    tim = state.tim.replace(lst=torch.tensor([0, 12], dtype=torch.int32),
                            lmin=torch.ones(2, dtype=torch.int32))
    return model, state.replace(tim=tim)


def _minute(tmp, multiphase):
    """The minute traced off and on from the same state, with the Newton
    iterations of each kon call and the Ros3 checks of each solve
    counted from outside (spies that pass every call through)."""
    model, start = _model(tmp, multiphase)
    profiling.disable()
    profiling.reset()
    off = model.minute_step(start)
    off_summary, off_records = profiling.summary(), profiling.collect()

    newton, ros3 = [], []
    kon, dwsum, integrate = growth.kon, growth.bott_dwsum, GasKernel.integrate

    def kon_spy(*a, **kw):
        newton.append(0)
        return kon(*a, **kw)

    def dwsum_spy(*a, **kw):
        newton[-1] += 1
        return dwsum(*a, **kw)

    def integrate_spy(self, *a, **kw):
        y, info = integrate(self, *a, **kw)
        ros3.append(int(info["nsteps"].max()) + 1)
        return y, info

    growth.kon, growth.bott_dwsum = kon_spy, dwsum_spy
    GasKernel.integrate = integrate_spy
    try:
        with profiling.tracing(records=True):
            on = model.minute_step(start)
            records = profiling.collect()
    finally:
        growth.kon, growth.bott_dwsum = kon, dwsum
        GasKernel.integrate = integrate
    profiling.reset()
    return dict(off=off, on=on, off_summary=off_summary,
                off_records=off_records, records=records,
                newton=newton, ros3=ros3)


@pytest.fixture(scope="module")
def btz96(tmp_path_factory):
    return _minute(tmp_path_factory.mktemp("btz96"), False)


@pytest.fixture(scope="module")
def multiphase(tmp_path_factory):
    return _minute(tmp_path_factory.mktemp("multiphase"), True)


def _children(records, parent):
    return [r for r in records if r["parent"] == parent["id"]]


def _named(records, name):
    return [r for r in records if r["name"] == name]


def test_tracing_off_records_nothing(btz96):
    assert btz96["off_summary"] == {} and btz96["off_records"] == []
    # one shared object, whatever the name; a count is dropped
    assert profiling.span("a") is profiling.span("b")
    profiling.count("sync.x")
    assert profiling.summary() == {}


@pytest.mark.parametrize("run", ["btz96", "multiphase"])
def test_minute_bit_equal_with_tracing_on(run, request):
    got = request.getfixturevalue(run)
    off, on = flatten_state(got["off"]), flatten_state(got["on"])
    assert off.keys() == on.keys()
    for k in off:
        assert torch.equal(off[k], on[k]), k


@pytest.mark.parametrize("run", ["btz96", "multiphase"])
def test_span_tree_follows_the_step(run, request):
    recs = request.getfixturevalue(run)["records"]
    roots = [r for r in recs if r["parent"] is None]
    assert [r["name"] for r in roots] == ["minute"]
    minute = roots[0]
    assert {r["minute"] for r in recs} == {minute["minute"]}
    parts = _children(recs, minute)
    assert [r["name"] for r in parts] == \
        ["pre_minute"] + ["substep"] * 6 + ["post_minute"]
    assert [r["name"] for r in _children(recs, parts[0])] == ["partdep"]
    ops = MULTIPHASE if run == "multiphase" else PHYSICS
    for sub in parts[1:7]:
        assert [r["name"] for r in _children(recs, sub)] == ops
    post = ["radiation"] + (["photolysis"] if run == "multiphase" else [])
    assert [r["name"] for r in _children(recs, parts[7])] == post
    if run == "multiphase":
        for solve in _named(recs, "chem_solve"):
            assert [r["name"] for r in _children(recs, solve)] == CHEM_SOLVE


def test_self_time_is_the_time_less_the_children(multiphase):
    recs = multiphase["records"]
    for r in recs:
        kids = _children(recs, r)
        assert r["self_seconds"] == pytest.approx(
            r["seconds"] - sum(k["seconds"] for k in kids), abs=1e-9)
        assert r["self_seconds"] >= 0.0
        # on the CPU the interval is the host stamps', and children lie in
        # it one after another
        assert (r["start"], r["end"]) == (r["host_start"], r["host_end"])
        assert r["seconds"] == pytest.approx(1e-9 * (r["end"] - r["start"]))
        ends = r["start"]
        for k in kids:
            assert ends <= k["start"] <= k["end"] <= r["end"]
            ends = k["end"]
    # and by construction: a parent that sleeps 20 ms around a child that
    # sleeps 30 ms
    with profiling.tracing(records=True):
        with profiling.span("outer"):
            time.sleep(0.02)
            with profiling.span("inner"):
                time.sleep(0.03)
        outer, inner = profiling.collect()[::-1]
    assert outer["name"] == "outer" and inner["parent"] == outer["id"]
    assert 0.02 <= outer["self_seconds"] < 0.03 <= inner["seconds"]


@pytest.mark.parametrize("run", ["btz96", "multiphase"])
def test_newton_syncs_are_subkons_checks(run, request):
    got = request.getfixturevalue(run)
    kons = _named(got["records"], "kon")
    # one check per iteration and the one that ends the loop
    assert [k["counts"]["sync.newton"] for k in kons] == \
        [n + 1 for n in got["newton"]]
    assert len(kons) == 6 and all(n >= 1 for n in got["newton"])
    # sedp's Courant loop counts its own checks, once or more per substep
    assert all(r["counts"]["sync.sedp"] >= 1
               for r in _named(got["records"], "sedp"))


def test_ros3_syncs_are_the_loops_checks(multiphase):
    recs = multiphase["records"]
    solves = [r for r in recs if r["name"] in ("ros3_tot", "ros3_gas")]
    assert [r["counts"]["sync.ros3"] for r in solves] == multiphase["ros3"]
    assert len(solves) == 12
    # the photolysis check, once per minute in post_minute
    post = _named(recs, "post_minute")[0]
    assert post["counts"] == {"sync.photolysis": 1}


def test_aggregates_without_records():
    with profiling.tracing():
        for _ in range(3):
            with profiling.span("a"):
                profiling.count("sync.a", 2)
                with profiling.span("b"):
                    pass
        assert profiling.collect() == []
    s = profiling.summary()
    assert s["a"]["calls"] == 3 and s["b"]["calls"] == 3
    assert s["a"]["counts"] == {"sync.a": 6} and s["b"]["counts"] == {}
    assert s["a"]["self_seconds"] == pytest.approx(
        s["a"]["seconds"] - s["b"]["seconds"])


def test_span_starts_on_the_profilers_clock():
    from torch.profiler import ProfilerActivity, profile
    with profiling.tracing(records=True):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with profiling.span("clock_probe"):
                torch.ones(8).sum()
        rec, = profiling.collect()
    t0 = prof.profiler.kineto_results.trace_start_ns()
    ev, = [e for e in prof.events() if e.name == "clock_probe"]
    assert abs(t0 + 1e3 * ev.time_range.start - rec["host_start"]) < 1e6


def test_cli_profile_reports_spans(tmp_path, monkeypatch):
    inp = tmp_path / "inp"
    inp.mkdir()
    write_synthetic_clarke_table(inp)
    write_synthetic_radiation_tables(inp)
    monkeypatch.setenv("INPDIR", str(inp))
    nml = write_namelist(tmp_path / "namelist", **CLI_BTZ96)
    out, prof = tmp_path / "out", tmp_path / "prof"
    assert cli.main(["--namelist", nml, "--platform", "cpu", "--grid", TINY,
                     "--minutes", "4", "--outdir", str(out),
                     "--profile", str(prof)]) == 0
    trace, = prof.glob("trace_*.json")
    names = {e.get("name") for e in json.loads(trace.read_text())[
        "traceEvents"]}
    assert {"minute", "substep", "kon", "radiation"} <= names
    spans, = prof.glob("spans_*.json")
    minutes = {r["minute"] for r in json.loads(spans.read_text())
               if r["name"] == "minute"}
    assert len(minutes) == 3          # minutes 2-4
    assert not profiling.TRACER.on


@pytest.mark.gpu
def test_card_span_holds_its_kernel_and_the_idle_before_it():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.ones(1, device="cuda").add_(1.0)
    torch.cuda.synchronize()
    with profiling.tracing(records=True):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with profiling.span("card_probe"):
                time.sleep(0.02)
                torch.cuda._sleep(50_000_000)
            torch.cuda.synchronize()
        rec, = profiling.collect()
    t0 = prof.profiler.kineto_results.trace_start_ns()
    # torch.cuda._sleep's spin kernel; the span's own range is a CUDA
    # event of its name too (a user annotation)
    kernel, = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and e.name != "card_probe"]
    k0 = t0 + 1e3 * kernel.time_range.start
    k1 = t0 + 1e3 * kernel.time_range.end
    # the kernel lies inside the span, and so does the host's 20 ms before
    # it, in which the card idled
    assert rec["start"] <= k0 - 19e6 and k1 <= rec["end"] + 1e5
    assert rec["start"] >= rec["host_start"] - 1e6
    assert rec["seconds"] >= 0.02 + 1e-9 * (k1 - k0)
