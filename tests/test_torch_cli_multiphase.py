"""The port's run harness against the JAX package's on a chem=T
namelist: the multiphase driver (nkc_l=4) with the small tot stand-in
(``write_synthetic_tot_mechanism(dir, 12, 25)``) and the synthetic
photolysis tables, ``binout`` on, BTZ96 settings in float64 on the tiny
grid, from 11:59 for 2 minutes across the hour.  mass.out, profc.out,
profm.out, tima.out and the chem.nc, jrat.nc and rxn.nc records agree
within 1e-6 of each field's scale (each species and J slot to its own)."""

from __future__ import annotations

import numpy as np
import pytest

import mistra_tpu_torch as pt
from _torch_cli import (BTZ96, TINY, assert_text_close, nc_vars,
                        run_jax_cli, run_port_cli, write_namelist)
from mistra_tpu_torch.chemistry.mech import write_synthetic_tot_mechanism
from mistra_tpu_torch.io import netcdf as ncio
from mistra_tpu_torch.photolysis.tables import \
    write_synthetic_photolysis_tables
from mistra_tpu_torch.physics.surface import write_synthetic_clarke_table
from mistra_tpu_torch.radiation.tables import \
    write_synthetic_radiation_tables

TOL = 1e-6
N = 30


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli_mp")
    inp, mech = d / "inp", d / "mech"
    inp.mkdir()
    mech.mkdir()
    write_synthetic_clarke_table(inp)
    write_synthetic_radiation_tables(inp)
    write_synthetic_photolysis_tables(inp)
    write_synthetic_tot_mechanism(str(mech), 12, 25)
    nml = write_namelist(d / "namelist", nhour=11, nkc_l=4,
                         binout=".true.", mechdir=f"'{mech}'",
                         **dict(BTZ96, chem=".true."))
    env = {"INPDIR": str(inp)}
    common = ["--namelist", nml, "--grid", TINY, "--minutes", "2"]
    jout, tout = d / "jax", d / "port"
    run_jax_cli(59, [*common, "--outdir", str(jout)], env)
    mp = pytest.MonkeyPatch()
    try:
        run_port_cli(mp, 59, [*common, "--outdir", str(tout)], env)
    finally:
        mp.undo()
    return jout, tout


@pytest.mark.parametrize("name", ["mass.out", "profc.out", "profm.out",
                                  "tima.out"])
def test_text_output_matches_jax(runs, name):
    jout, tout = runs
    assert_text_close(jout / name, tout / name, TOL)


def test_budget_channels_match_jax(runs):
    jout, tout = runs
    for name in ("species.txt", "s_channels.txt"):
        assert (jout / name).read_text() == (tout / name).read_text()


def rows_err(a, b, axis):
    """max over rows (species, slots, reactions) of |a - b| relative to
    the row's largest |a| over time and levels."""
    other = tuple(i for i in range(a.ndim) if i != axis)
    scale = np.maximum(np.abs(a).max(axis=other, keepdims=True), 1e-300)
    return float((np.abs(a - b) / scale).max())


@pytest.mark.skipif(not ncio.available(),
                    reason="native netCDF library or libnetcdf unavailable")
def test_netcdf_records_match_jax(runs):
    """chem.nc and jrat.nc: the initial record (the 15-minute snapshot
    lies beyond 2 minutes); rxn.nc defined with its levels and channels
    and no record yet."""
    jout, tout = runs
    nspec = len((tout / "species.txt").read_text().split())
    nch = len((tout / "s_channels.txt").read_text().splitlines())
    for file, shapes, axis in (
            ("chem.nc", {"conc": ("T", nspec, N)}, 1),
            ("jrat.nc", {"photol_j": ("T", ncio.NPHRXN, N)}, 1)):
        a, b = nc_vars(jout / file, shapes), nc_vars(tout / file, shapes)
        for k in shapes:
            assert a[k].shape == b[k].shape and a[k].shape[0] == 1
            assert rows_err(a[k], b[k], axis) <= TOL, (file, k)
    nlev = len(ncio.budget_levels(pt.MistraConfig(
        grid=pt.GridParams(nf=20, n_extra=10, nka=16, nkt=16, nb=8))))
    shapes = {"level_index": (nlev,), "s_channel_rxn": (nch,)}
    a, b = nc_vars(jout / "rxn.nc", shapes), nc_vars(tout / "rxn.nc", shapes)
    for k in shapes:
        np.testing.assert_array_equal(a[k], b[k])
    r = ncio.NcReader(str(tout / "rxn.nc"))
    assert r.dimlen("time") == 0
    r.close()
