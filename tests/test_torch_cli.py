"""The port's run harness (``python -m mistra_tpu_torch``) against the JAX
package's (``python -m mistra_tpu``) on one namelist: the BTZ96 settings
in float64 on the tests' tiny grid (``--grid``) with the synthetic
Clarke, PIFM2 and Mie tables in INPDIR, from 11:46 for 16 minutes, so the
run writes the initial record, the 15-minute snapshot, the 12:00 hourly
profiles and the 12:00 checkpoint.  tima.out, profm.out, profr.out and
every netCDF record agree within 1e-6 of each field's scale; a port run
restarted from the 12:00 checkpoint equals the run in one piece bit for
bit.  Runs of both CLIs with chem=T, nuc and binout, whose step only
advances the clock, check what the 15-minute snapshot adds: the budget
and nucleation records, against the port's own driver and against JAX's
records."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import mistra_tpu_torch as pt
from _torch_cli import (BTZ96, TINY, assert_nc_close, assert_text_close,
                        nc_vars, run_jax_cli, run_port_cli, write_namelist)
from mistra_tpu_torch.chemistry.mech import write_synthetic_gas_mechanism
from mistra_tpu_torch.cli import override_grid
from mistra_tpu_torch.io import netcdf as ncio
from mistra_tpu_torch.io.checkpoint import restore_checkpoint
from mistra_tpu_torch.io.output import read_output
from mistra_tpu_torch.photolysis.tables import \
    write_synthetic_photolysis_tables
from mistra_tpu_torch.physics.surface import write_synthetic_clarke_table
from mistra_tpu_torch.radiation.tables import \
    write_synthetic_radiation_tables

START_MINUTE = 46
MINUTES = 16
TOL = 1e-6
G = dict(nf=20, n=30, nka=16, nkt=16)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX outdir, port outdir, port restart outdir, input dir)."""
    d = tmp_path_factory.mktemp("cli")
    inp = d / "inp"
    inp.mkdir()
    write_synthetic_clarke_table(inp)
    write_synthetic_radiation_tables(inp)
    nml = write_namelist(d / "namelist", nhour=11, **BTZ96)
    env = {"INPDIR": str(inp)}
    common = ["--namelist", nml, "--grid", TINY]
    jout, tout, rout = d / "jax", d / "port", d / "restart"
    run_jax_cli(START_MINUTE, [*common, "--minutes", str(MINUTES),
                               "--outdir", str(jout)], env)
    mp = pytest.MonkeyPatch()
    try:
        run_port_cli(mp, START_MINUTE, [*common, "--minutes", str(MINUTES),
                                        "--outdir", str(tout)], env)
        run_port_cli(mp, START_MINUTE, [
            *common, "--minutes", str(MINUTES - 14), "--outdir", str(rout),
            "--restart", str(tout / "restart_day0_12h.pt")], env)
    finally:
        mp.undo()
    return jout, tout, rout, inp


@pytest.mark.parametrize("name", ["tima.out", "profm.out", "profr.out"])
def test_text_output_matches_jax(runs, name):
    jout, tout, _, _ = runs
    assert_text_close(jout / name, tout / name, TOL)


def test_profiles_cross_the_hour(runs):
    """The run crossed 12:00 once: one block of each hourly profile."""
    _, tout, _, _ = runs
    for name in ("profm.out", "profr.out"):
        stamps = [ln for ln in (tout / name).read_text().splitlines()
                  if ln.startswith("# day")]
        assert len(stamps) == 1 and " 12:00 " in stamps[0] + " ", stamps


@pytest.mark.skipif(not ncio.available(),
                    reason="native netCDF library or libnetcdf unavailable")
@pytest.mark.parametrize("file,shapes", [
    ("grid.nc", {"eta": (G["n"],), "etw": (G["n"],), "rn": (G["nka"],),
                 "rq": (G["nkt"], G["nka"]), "en": (G["nka"],),
                 "e": (G["nkt"],), "rpw": (G["nka"],)}),
    ("meteo.nc", {**{k: ("T", G["n"]) for k in (
        "u", "v", "t", "theta", "xm1", "xm2", "feu", "tke", "rho", "p",
        "dtrad", "atkh")}, "time": ("T",), "u0": ("T",)}),
    ("mic.nc", {"fsum": ("T", G["n"]), "lcl": ("T",), "lct": ("T",),
                "part1D": ("T", G["nka"] - 1, G["nf"])}),
    ("part.nc", {"ff": ("T", G["nkt"], G["nka"], G["n"])}),
])
def test_netcdf_records_match_jax(runs, file, shapes):
    """Two records (the initial one and the 15-minute snapshot); part.nc
    one (the initial spectrum: the 30-minute cadence)."""
    jout, tout, _, _ = runs
    assert_nc_close(jout / file, tout / file, shapes, TOL)
    if "T" in str(shapes):
        r = ncio.NcReader(str(tout / file))
        assert r.dimlen("time") == (1 if file == "part.nc" else 2)
        r.close()


def test_final_aerosol_matches_jax(runs):
    jout, tout, _, _ = runs
    a = np.load(jout / "aerosol_final.npy")
    b = np.load(tout / "aerosol_final.npy")
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= TOL * np.abs(a).max()


def test_restart_run_equals_the_run_in_one_piece(runs):
    """2 minutes from the 12:00 checkpoint end where the 16 minutes in one
    piece end, every field bit for bit; its tima lines are the last 2 of
    the run in one piece."""
    _, tout, rout, _ = runs
    whole = torch.load(tout / "restart.pt", weights_only=True)["fields"]
    split = torch.load(rout / "restart.pt", weights_only=True)["fields"]
    assert whole.keys() == split.keys()
    for k in whole:
        assert whole[k].dtype == split[k].dtype
        assert torch.equal(whole[k], split[k]), k
    lines = (tout / "tima.out").read_text().splitlines()
    assert (rout / "tima.out").read_text().splitlines() == lines[-2:]


def test_checkpoints_written_at_noon_and_at_the_end(runs):
    _, tout, _, _ = runs
    names = sorted(p.name for p in tout.glob("restart*.pt"))
    assert names == ["restart.pt", "restart_day0_12h.pt"]
    noon = torch.load(tout / "restart_day0_12h.pt", weights_only=True)
    assert int(noon["fields"]["tim.lst"][0]) == 12
    assert int(noon["fields"]["tim.lmin"][0]) == 0


@pytest.fixture(scope="module")
def budget_runs(tmp_path_factory):
    """chem=T (the gas-phase driver) with nuc and binout, 15 minutes from
    12:00 whose step only advances the clock and the deposition velocities
    (``pre_minute``), through both CLIs: (JAX outdir, port outdir,
    namelist, input dir)."""
    d = tmp_path_factory.mktemp("budgets")
    inp, mech = d / "inp", d / "mech"
    inp.mkdir()
    mech.mkdir()
    write_synthetic_clarke_table(inp)
    write_synthetic_radiation_tables(inp)
    write_synthetic_photolysis_tables(inp)
    write_synthetic_gas_mechanism(str(mech), 45)
    nml = write_namelist(d / "nml", nhour=12, nkc_l=0,
                         nuc=".true.", binout=".true.",
                         mechdir=f"'{mech}'", **dict(BTZ96, chem=".true."))
    env = {"INPDIR": str(inp)}
    common = ["--namelist", nml, "--grid", TINY, "--minutes", "15"]
    jout, tout = d / "jax", d / "port"
    run_jax_cli(0, [*common, "--outdir", str(jout)], env, step="pre_minute")
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(pt.Model, "minute_step", pt.Model.pre_minute)
        run_port_cli(mp, 0, [*common, "--outdir", str(tout)], env)
    finally:
        mp.undo()
    return jout, tout, nml, inp


def test_snapshot_writes_budgets_and_nucleation(budget_runs, monkeypatch):
    """The port's 15-minute snapshot writes one budget record, the rates
    of the levels (and the S channels' at every level) each minute summed
    over 60 s, and one nucleation record recomputed at dd = 60 s, its
    count the rate times 900 s (the JAX CLI's cadence)."""
    _, out, nml, inp = budget_runs
    monkeypatch.setenv("INPDIR", str(inp))
    cfg = pt.config_from_namelist(nml)
    override_grid(cfg, TINY)
    model = pt.Model(cfg, device="cpu")
    state = restore_checkpoint(str(out / "restart.pt"), model.init_state(1))
    drv = model._chemistry
    n = cfg.grid.n
    levels = ncio.budget_levels(cfg)
    inst = drv.reaction_rates_at(state, levels).T.numpy()
    s_ch = np.array([int(ln.split()[0]) for ln in
                     (out / "s_channels.txt").read_text().splitlines()])
    s_inst = np.zeros((len(s_ch), n))
    s_inst[:, 1:n - 1] = drv.reaction_rates_at(
        state, np.arange(1, n - 1)).T.numpy()[s_ch]
    _, diag = model._nucleation(state, 60.0)
    if ncio.available():
        rec = {**nc_vars(out / "rxn.nc", {
            "rate": (1, drv.mech.nrxn, len(levels)),
            "cum": (1, drv.mech.nrxn, len(levels)),
            "s_rate": (1, len(s_ch), n), "s_cum": (1, len(s_ch), n)}),
               **nc_vars(out / "nuc.nc", {"xn_app": (1, n),
                                          "xn_apacc": (1, n)})}
    else:
        groups = read_output(str(out / "output"))
        rec = {**groups["rxn"], **groups["nuc"]}
    rate, cum, xn, acc = (rec[k][0] for k in ("rate", "cum", "xn_app",
                                               "xn_apacc"))
    scale = np.abs(inst).max()
    assert scale > 0
    assert np.abs(rate - inst).max() <= 1e-12 * scale
    # the state of every minute has the rates of the last (the clock and
    # partdep alone move)
    assert np.abs(cum - 900.0 * inst).max() <= 1e-10 * 900.0 * scale
    s_scale = np.abs(s_inst).max()
    assert s_scale > 0
    assert np.abs(rec["s_rate"][0] - s_inst).max() <= 1e-12 * s_scale
    assert np.abs(rec["s_cum"][0] - 900.0 * s_inst).max() \
        <= 1e-10 * 900.0 * s_scale
    want = diag["xn_app"][0].numpy()
    assert np.abs(want).max() > 0
    assert np.abs(xn - want).max() <= 1e-12 * max(np.abs(want).max(), 1e-300)
    np.testing.assert_allclose(acc, 900.0 * xn, rtol=1e-14)


@pytest.mark.skipif(not ncio.available(),
                    reason="native netCDF library or libnetcdf unavailable")
@pytest.mark.parametrize("file", ["rxn.nc", "nuc.nc"])
def test_budget_and_nucleation_records_match_jax(budget_runs, file):
    """Every variable of the budget and nucleation files of the two CLIs'
    runs within 1e-6 of its scale: the per-reaction rates and their sums
    at the budget levels, the S channels' at every level, the nucleation
    diagnostics and their cumulative count."""
    jout, tout, nml, _ = budget_runs
    cfg = pt.config_from_namelist(nml)
    override_grid(cfg, TINY)
    n, nlev = cfg.grid.n, len(ncio.budget_levels(cfg))
    if file == "rxn.nc":
        assert (jout / "s_channels.txt").read_text() \
            == (tout / "s_channels.txt").read_text()
        nch = len((tout / "s_channels.txt").read_text().splitlines())
        r = ncio.NcReader(str(tout / file))
        nrxn = r.dimlen("nrxn")
        r.close()
        shapes = {"level_index": (nlev,), "s_channel_rxn": (nch,),
                  "rate": ("T", nrxn, nlev), "cum": ("T", nrxn, nlev),
                  "s_rate": ("T", nch, n), "s_cum": ("T", nch, n)}
    else:
        shapes = {k: ("T", n) for k in ("xn_app", "xn_apacc", "grorate",
                                        "dnucv", "concnuc", "j_real")}
    assert_nc_close(jout / file, tout / file, shapes, TOL)
    for out in (jout, tout):
        r = ncio.NcReader(str(out / file))
        assert r.dimlen("time") == 1
        r.close()
