"""Parity of the PyTorch port's nucleation (``physics/nucleation.py``) with
the JAX package: the Napari polynomial, ternucl and oionucl on seeded
inputs over their valid ranges (float64, and float32 against float64),
the background spectrum, and ``NucleationDriver`` with napari only,
lovejoy only, both (appnucl2) and neither, each with and without the
feedback into the particles (ifeed), on two foggy columns in one batch;
and two nuc=T minutes (both mechanisms, ifeed=1) of a noon and a midnight
column against the jitted JAX minute.  Tiny grid, the small gas stand-in
with OIO in it (n_gas >= 41), radiation and photolysis on."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (assert_close, assert_rows_close, foggy,
                           make_models, step_both, to_numpy,
                           to_port_columns)

from mistra_tpu.physics import nucleation as jnuc
from mistra_tpu_torch.physics import nucleation as tnuc

# float64, the same formulas on the same inputs: far below 1e-10 of each
# quantity's scale (the rates span many decades: each is held to its own
# value)
TOL = 1e-10
# the stand-in's gas species through OIO (the 41st named species)
N_GAS_NUC = 45
# vapor concentrations [mol/m3] of the JAX package's nucleation tests
VAPORS = {"H2SO4": 5e-9, "NH3": 1e-9, "OIO": 5e-10}


def seeded(seed, n=257):
    """Seeded inputs over the Napari fit's valid ranges: RH 0.05-0.95,
    NH3 0.1-100 ppt, H2SO4 1e3-1e9 /cm3 (below 1e4 the rate is 0), T
    240-300 K; OIO 1e-3-1e2 ppt."""
    rng = np.random.default_rng(seed)
    return dict(rh=rng.uniform(0.05, 0.95, n),
                nh3=10.0 ** rng.uniform(-1.0, 2.0, n),
                h2so4=10.0 ** rng.uniform(3.0, 9.0, n),
                temp=rng.uniform(240.0, 300.0, n),
                oio=10.0 ** rng.uniform(-3.0, 2.0, n))


def assert_each_close(want, got, tol, what):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    err = np.abs(got - want) / np.maximum(np.abs(want), 1e-300)
    err = np.where(want == 0.0, np.abs(got), err)
    assert err.max() <= tol, f"{what}: {err.max():.3e} > {tol:.1e}"


@pytest.mark.parametrize("seed", [0, 1])
def test_rate_functions_match_jax(seed):
    x = seeded(seed)
    j = {k: jnp.asarray(v) for k, v in x.items()}
    t = {k: torch.as_tensor(v) for k, v in x.items()}
    assert_each_close(jnuc.j_nuc_napari(j["rh"], j["nh3"], j["h2so4"],
                                        j["temp"]),
                      tnuc.j_nuc_napari(t["rh"], t["nh3"], t["h2so4"],
                                        t["temp"]), TOL, "j_nuc_napari")
    want = jnuc.ternucl(j["rh"], j["nh3"], j["h2so4"], j["temp"])
    got = tnuc.ternucl(t["rh"], t["nh3"], t["h2so4"], t["temp"])
    for name, w, g in zip(("jn", "nh", "nn", "dc"), want, got):
        assert_each_close(w, g, TOL, f"ternucl {name}")
    assert (got[0] > 0.0).any() and (got[0] == 0.0).any()
    for name, w, g in zip(("jnio", "d"), jnuc.oionucl(j["oio"], j["temp"]),
                          tnuc.oionucl(t["oio"], t["temp"])):
        assert_each_close(w, g, TOL, f"oionucl {name}")


def test_rate_functions_in_float32():
    """float32 inputs: the port computes the Napari rate and composition
    in float64 and returns them in float32, so they are the float64
    values to float32's rounding; JAX's float32 path (the cubic-in-T
    coefficients cancel to ~1e-2 of their terms) is within ~1e-3 of them.
    oionucl runs in float32 and stays within float32's rounding of its
    float64 values."""
    x = seeded(2)
    t32 = {k: torch.as_tensor(v, dtype=torch.float32) for k, v in x.items()}
    t64 = {k: v.double() for k, v in t32.items()}
    j32 = {k: jnp.asarray(v.numpy()) for k, v in t32.items()}
    for fn, args, tol in ((tnuc.ternucl, ("rh", "nh3", "h2so4", "temp"),
                           1e-6),
                          (tnuc.oionucl, ("oio", "temp"), 1e-4)):
        got = fn(*(t32[a] for a in args))
        ref = fn(*(t64[a] for a in args))
        jx = getattr(jnuc, fn.__name__)(*(j32[a] for a in args))
        for g, r, w in zip(got, ref, jx):
            assert g.dtype == torch.float32 and torch.isfinite(g).all()
            assert_each_close(r.numpy(), g.numpy(), tol, fn.__name__)
            assert_each_close(g.numpy(), np.asarray(w), 2e-3,
                              f"JAX float32 {fn.__name__}")


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    return make_models(tmp_path_factory.mktemp("inp"), radiation=True,
                       mechdir=tmp_path_factory.mktemp("mech"),
                       n_gas=N_GAS_NUC, nuc=True, ifeed=1)


@pytest.fixture(scope="module")
def columns(models):
    """Two foggy columns with seeded vapor profiles: the JAX states and
    the port batch (whose drivers the port's init installs)."""
    jm, tm, js = models
    tm.init_state(1)
    n2i = jm._chemistry.name2i
    states = []
    for seed in (1, 2):
        s = foggy(js, jm.cfg.grid.nf, seed=seed)
        rng = np.random.default_rng(seed)
        sgas = np.array(s.chem.sgas)
        for name, val in VAPORS.items():
            sgas[n2i[name]] = val * 10.0 ** rng.uniform(-1.0, 1.0,
                                                         sgas.shape[1])
        states.append(s.replace(chem=s.chem.replace(sgas=jnp.asarray(sgas))))
    return states, to_port_columns(states)


def test_background_spectrum_matches_jax(models, columns):
    jm, tm, _ = models
    states, ts = columns
    member = torch.as_tensor(tnuc.background_membership(tm.grids.micro))
    got = tnuc.background_spectrum(ts.micro.ff, member)
    for c, s in enumerate(states):
        want = jnuc.background_spectrum(s.micro.ff, jm.grids.micro,
                                        jnp.float64)
        assert_close(want, got[c:c + 1], TOL, "np_1d")


@pytest.mark.parametrize("ifeed", [0, 1])
@pytest.mark.parametrize("napari,lovejoy", [
    (True, False), (False, True), (True, True), (False, False)],
    ids=["napari", "lovejoy", "appnucl2", "neither"])
def test_driver_matches_jax(models, columns, napari, lovejoy, ifeed):
    """One 10-s nucleation step of each column: the particles, every gas
    species (the vapors consumed) and the diagnostics."""
    jm, tm, _ = models
    states, ts = columns
    jd, td = jm._nucleation, tm._nucleation
    assert [v[0] for v in td.vapors] == [v[0] for v in jd.vapors] == [
        "OIO", "H2SO4", "NH3"]
    for d in (jd, td):
        d.napari, d.lovejoy, d.ifeed = napari, lovejoy, ifeed
    wants = [jd(s, 10.0) for s in states]
    got, gdiag = td(ts, 10.0)
    for c, (ws, wdiag) in enumerate(wants):
        w = to_numpy(ws)
        assert_close(w.micro.ff, got.micro.ff[c:c + 1], TOL, "ff")
        assert_close(w.micro.fsum, got.micro.fsum[c:c + 1], TOL, "fsum")
        assert_rows_close(w.chem.sgas, got.chem.sgas[c:c + 1], TOL, "sgas")
        for name, val in wdiag.items():
            assert_close(val, gdiag[name][c:c + 1], TOL, name)
    xn = torch.stack([gdiag["xn_app"][c] for c in range(2)])
    assert (xn > 0.1).any(), "no level nucleated"
    added = bool((got.micro.ff.sum() > ts.micro.ff.sum()).item())
    assert added == (ifeed != 0)


def test_two_nucleation_minutes_match_jax(models, columns):
    """nuc=T with both mechanisms (appnucl2) and ifeed=1 in the column
    minute, after the chemistry: every field of a noon and a midnight
    column over two minutes; the nucleation added particles.  The port's
    drivers are those its init installs (the ``columns`` fixture)."""
    jm, tm, js = models
    for d in (jm._nucleation, tm._nucleation):
        d.napari, d.lovejoy, d.ifeed = True, True, 1
    _, ts0, ts = step_both(jm, tm, js)
    assert ts.micro.ff[:, :, 0].sum() > ts0.micro.ff[:, :, 0].sum()
