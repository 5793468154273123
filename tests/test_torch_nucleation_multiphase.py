"""Parity of the PyTorch port's nucleation with the multiphase driver
(nuc=T at nkc_l=4 with mic=T, the JAX package's default chemistry) with
the JAX package: the vapors bound through the tot mechanism's indices,
one ``NucleationDriver`` step with napari only and with both mechanisms
(appnucl2), each with and without the feedback into the particles
(ifeed), the consumed H2SO4 moved into its dissolved form ``H2SO4l1``;
and two nuc=T multiphase minutes at the configuration's defaults (both
mechanisms, ifeed=0) of a noon and a midnight column against the jitted
JAX minute (ifeed=1 minutes: test_torch_nucleation_feedback.py).  Tiny
grid, the small tot stand-in (its gas part holds H2SO4 and NH3; OIO would
take the stand-in past 40 gas species and ~50 aqueous stems per bin,
whose JAX minute takes minutes to compile), radiation and photolysis
on."""

from __future__ import annotations

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (assert_close, assert_rows_close, foggy,
                           make_models, step_both, to_numpy,
                           to_port_columns)

# float64, the same formulas on the same inputs (test_torch_nucleation.py)
TOL = 1e-10
# vapor concentrations [mol/m3] of the JAX package's nucleation tests
VAPORS = {"H2SO4": 5e-9, "NH3": 1e-9}


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    return make_models(tmp_path_factory.mktemp("inp"), radiation=True,
                       mechdir=tmp_path_factory.mktemp("mech"),
                       multiphase=True, nuc=True)


@pytest.fixture(scope="module")
def columns(models):
    """Two foggy columns with seeded vapor profiles in the tot
    concentrations: the JAX states and the port batch (whose drivers the
    port's init installs)."""
    jm, tm, js = models
    tm.init_state(1)
    n2i = jm._chemistry.tot_n2i
    states = []
    for seed in (1, 2):
        s = foggy(js, jm.cfg.grid.nf, seed=seed)
        rng = np.random.default_rng(seed)
        conc = np.array(s.chem.conc)
        for name, val in VAPORS.items():
            conc[n2i[name]] = val * 10.0 ** rng.uniform(-1.0, 1.0,
                                                        conc.shape[1])
        states.append(s.replace(chem=s.chem.replace(conc=jnp.asarray(conc))))
    return states, to_port_columns(states)


def test_vapors_bind_to_the_tot_mechanism(models):
    """Both drivers find H2SO4 and NH3 at the same indices of the tot
    mechanism, whose concentrations (``conc``) the step changes."""
    jm, tm, _ = models
    tm.init_state(1)
    jd, td = jm._nucleation, tm._nucleation
    assert td.vapors == [(nm, int(i), m) for nm, i, m in jd.vapors]
    assert [v[0] for v in td.vapors] == ["H2SO4", "NH3"]
    assert td.n2i is tm._chemistry.tot_n2i and td.conc_name == "conc"
    assert "H2SO4l1" in td.n2i


@pytest.mark.parametrize("ifeed", [0, 1])
@pytest.mark.parametrize("lovejoy", [False, True],
                         ids=["napari", "appnucl2"])
def test_multiphase_driver_matches_jax(models, columns, lovejoy, ifeed):
    """One 10-s nucleation step of each column: the particles, every tot
    species (H2SO4 and NH3 consumed, H2SO4l1 gaining what H2SO4 lost to
    the new particles) and the diagnostics."""
    jm, tm, _ = models
    states, ts = columns
    jd, td = jm._nucleation, tm._nucleation
    for d in (jd, td):
        d.napari, d.lovejoy, d.ifeed = True, lovejoy, ifeed
    wants = [jd(s, 10.0) for s in states]
    got, gdiag = td(ts, 10.0)
    for c, (ws, wdiag) in enumerate(wants):
        w = to_numpy(ws)
        assert_close(w.micro.ff, got.micro.ff[c:c + 1], TOL, "ff")
        assert_close(w.micro.fsum, got.micro.fsum[c:c + 1], TOL, "fsum")
        assert_rows_close(w.chem.conc, got.chem.conc[c:c + 1], TOL, "conc")
        for name, val in wdiag.items():
            assert_close(val, gdiag[name][c:c + 1], TOL, name)
    assert (gdiag["xn_app"] > 0.1).any(), "no level nucleated"
    sink = td.n2i["H2SO4l1"]
    assert (got.chem.conc[:, sink] > ts.chem.conc[:, sink]).any()
    added = bool((got.micro.ff.sum() > ts.micro.ff.sum()).item())
    assert added == (ifeed != 0)


def test_two_multiphase_nucleation_minutes_match_jax(models):
    """nuc=T with the multiphase driver at the configuration's defaults
    (napari and lovejoy: appnucl2; ifeed=0) in the column minute, after
    the tot solve and the mass feedback: every field of a noon and a
    midnight column over two minutes; the nucleation consumed H2SO4 and
    moved it into H2SO4l1."""
    jm, tm, js = models
    tm.init_state(1)
    for d in (jm._nucleation, tm._nucleation):
        d.napari, d.lovejoy, d.ifeed = True, True, 0
    with counting_nucleation(tm) as moved:
        step_both(jm, tm, js)
    assert len(moved) == 12 and max(moved) > 0.0


@contextlib.contextmanager
def counting_nucleation(tm):
    """Collects, for every nucleation call of the port's model, the
    largest H2SO4l1 gain of any cell."""
    drv = tm._nucleation
    sink = drv.n2i["H2SO4l1"]
    moved = []

    def spy(state, dt):
        out, diag = type(drv).__call__(drv, state, dt)
        gain = out.chem.conc[:, sink] - state.chem.conc[:, sink]
        moved.append(float(gain.max()))
        return out, diag

    tm._nucleation = spy
    try:
        yield moved
    finally:
        tm._nucleation = drv
