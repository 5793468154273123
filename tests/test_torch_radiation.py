"""Parity of the PyTorch port's PIFM2 radiation with the JAX package:
table loaders, each solver function, the driver's static build and calls,
and the Mie absorption that kon takes.  Tiny grid, synthetic tables
(``write_synthetic_radiation_tables``) read by both packages, float64
unless stated; two columns in one batch (a noon and a midnight one) check
the column axis."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (B, assert_close, assert_equal_int, column,
                           field_err, foggy, make_models, to_port_columns)

from mistra_tpu.config import MistraConfig as JaxConfig
from mistra_tpu.grids import make_grids as jax_make_grids
from mistra_tpu.model import solar_zenith
from mistra_tpu.physics import growth as jgrowth
from mistra_tpu.radiation import driver as jdriver
from mistra_tpu.radiation import solver as jsolver
from mistra_tpu.radiation import tables as jtables
from mistra_tpu_torch.physics import growth as tgrowth
from mistra_tpu_torch.radiation import driver as tdriver
from mistra_tpu_torch.radiation import solver as tsolver
from mistra_tpu_torch.radiation import tables as ttables

# float64, the same formulas on the same inputs: XLA and torch differ only
# in summation order and the last bits of exp/sqrt/pow, far below 1e-10 of
# each output's scale through the solve (measured ~1e-13, the heating rate
# being a difference of fluxes); a wrong term or index shows at 1e-3 or more
TOL = 1e-10
# the static build is the same host numpy on states equal to ~1e-15
STATIC_TOL = 1e-12
# float32 driver call against JAX float32 on the same inputs: both round
# each operation to 2^-24 ~ 6e-8, in different orders (einsums, fused XLA
# loops).  The fluxes and totrad keep ~1e-6 .. 1e-5 of their scale
# (measured 6.5e-7 for sl, 1.3e-5 for totrad).  The heating rate is the
# layer difference of net fluxes of ~400 W m-2, each a sum over 121 pairs:
# rounding of ~2e-4 W m-2 over a 10-m layer (rho c_p dz ~ 1.2e4 J m-2 K-1)
# is ~2e-8 K s-1, ~1e-4 of dtrad's ~1.6e-4 K s-1 scale (measured 1.5e-4)
F32_TOL = {"dtrad": 5e-4, "totrad": 1e-4, "sk": 1e-5, "sl": 1e-5}

NOON, MIDNIGHT = 0, 1


@pytest.fixture(scope="module")
def inp(tmp_path_factory):
    path = tmp_path_factory.mktemp("inp")
    ttables.write_synthetic_radiation_tables(path)
    return path


@pytest.fixture(scope="module")
def models(inp):
    """(JAX model, port model with its driver installed, JAX init state)."""
    jm, tm, js = make_models(inp, radiation=True)
    tm.init_state(1)
    return jm, tm, js


def at_noon(jm, js):
    tim = js.tim.replace(lst=jnp.int32(12))
    u0 = solar_zenith(tim.lst, tim.lmin, jm.astro.alat, jm.astro.declin)
    return js.replace(tim=tim, rad=js.rad.replace(u0=u0))


@pytest.fixture(scope="module")
def noon_midnight(models):
    """A foggy noon column and the initial midnight column: the JAX states
    and the port batch."""
    jm, _, js = models
    states = [at_noon(jm, foggy(js, jm.cfg.grid.nf, seed=3)), js]
    return states, to_port_columns(states)


def close_by_column(want_cols, got, tol, what):
    """got [B, ...] against the JAX per-column results want_cols[c]."""
    for c, w in enumerate(want_cols):
        assert_close(w, column(got, c), tol, f"{what}[{c}]")


# --------------------------------------------------------------------------
# tables
# --------------------------------------------------------------------------

def test_load_pifm2_matches_jax(inp):
    want = jtables.load_pifm2(str(inp))
    got = ttables.load_pifm2(str(inp))
    for f in dataclasses.fields(want):
        w, g = getattr(want, f.name), getattr(got, f.name)
        if isinstance(w, dict):
            assert w.keys() == g.keys(), f.name
            for k in w:
                assert np.array_equal(w[k], g[k]), f"{f.name}[{k}]"
        else:
            assert np.array_equal(w, g), f.name


def test_mie_tables_and_optics_match_jax(inp):
    mie = jtables.load_mie_tables(str(inp))
    assert np.array_equal(mie, ttables.load_mie_tables(str(inp)))
    micro = jax_make_grids(JaxConfig(chem=False)).micro   # production grid
    want = jtables.interpolate_particle_optics(mie, micro.rn, micro.rq)
    got = ttables.interpolate_particle_optics(mie, micro.rn, micro.rq)
    for w, g in zip(want, got):
        assert np.array_equal(w, g)


def test_synthetic_tables_keep_the_solvers_invariants(inp):
    tb = ttables.load_pifm2(str(inp))
    assert sum(len(h) for h in tb.hk.values()) == 121
    for band, h in tb.hk.items():
        assert (h > 0).all() and abs(h.sum() - 1.0) < 1e-8, band
    assert (tb.s0b > 0).all() and abs(tb.s0tot - 1340.0) < 1.0
    assert (np.diff(tb.ret) > 0).all()
    assert abs(tb.ret[0] - 4.18e-6) < 1e-12 and abs(tb.ret[-1] - 3.123e-5) \
        < 1e-12
    assert (np.diff(tb.feux) > 0).all() and 0.0 <= tb.feux[0] \
        and tb.feux[-1] < 1.0
    assert (tb.saanew <= tb.seanew).all() and (tb.saanew >= 0).all()
    assert (tb.ganew >= 0).all() and (tb.ganew < 1).all()
    assert (tb.berayl > 0).all()
    assert tb.o3un.shape == (52,) and (np.diff(tb.o3un) < 0).all()
    mie = ttables.load_mie_tables(str(inp))
    qabs, qext, asym = mie[..., 0], mie[..., 1], mie[..., 2]
    assert (qext >= qabs).all() and (qabs >= 0).all()
    assert (asym >= 0).all() and (asym < 1).all()


def test_synthetic_optical_depths_span_the_pairs(models):
    """The ln-k tables give the H2O and CO2 pairs optical depths from
    ~1e-4 to ~10 in the lowest (10-m) layer of the initial profile; the
    ozone bands 1 and 12 follow the ozone profile, small near the
    surface."""
    _, tm, _ = models
    drv = tm._radiation
    tx, px, _, xm1x, *_ = drv.load_profile(tm.init_state(1))
    qmo3 = torch.as_tensor(drv.qmo3[::-1].copy())[None]
    tg, _ = tsolver.gas_tau(drv.pt, torch.flip(px, [-1]),
                            torch.flip(tx, [-1]), torch.flip(xm1x, [-1]),
                            qmo3)
    band = drv.pt.band_of_pair
    lowest = tg[0, torch.as_tensor((band != 0) & (band != 11)), -1]
    assert 1e-6 < lowest.min() < 1e-3 and 3.0 < lowest.max() < 100.0


# --------------------------------------------------------------------------
# solver functions on seeded inputs, B = 2
# --------------------------------------------------------------------------

L = 24


def profiles(seed=0):
    """Top-down t, p, xm1, qmo3 [B, L+1]: pressure from 0 at the top to
    above the last standard pressure, with levels exactly at standard
    pressures (the interpolation's edges)."""
    rng = np.random.default_rng(seed)
    p = np.sort(np.concatenate(
        [[0.0, 10.0, 1000.0, 10000.0, 25100.0, 100000.0],
         np.geomspace(20.0, 102000.0, L - 5)]))
    p = np.stack([p, p * rng.uniform(0.97, 1.0)])
    p[:, 0] = 0.0
    t = rng.uniform(200.0, 300.0, (B, L + 1))
    xm1 = 10.0 ** rng.uniform(-6.0, -2.0, (B, L + 1))
    qmo3 = 10.0 ** rng.uniform(-9.0, -6.0, (B, L + 1))
    return t, p, xm1, qmo3


def optics(seed=1, P=9):
    """dtau, om [B, P, 2, L] and pl [B, P, 2, 2, L] hitting every branch
    of the coefficient selections (no extinction, no scattering, no
    absorption, Rayleigh-like phase functions)."""
    rng = np.random.default_rng(seed)
    shape = (B, P, 2, L)
    dtau = 10.0 ** rng.uniform(-9.0, 1.5, shape)
    om = rng.uniform(0.0, 1.0, shape)
    om[rng.uniform(size=shape) < 0.15] = 0.01
    om[rng.uniform(size=shape) < 0.15] = 0.9995
    om[rng.uniform(size=shape) < 0.1] = 0.0
    g = rng.uniform(0.0, 0.9, shape)
    g[rng.uniform(size=shape) < 0.2] = 0.01
    pl = np.stack([3.0 * g, 5.0 * g * g], axis=3)
    return dtau, om, pl


def frac_of(seed=2):
    rng = np.random.default_rng(seed)
    frac = rng.uniform(0.0, 1.0, (B, L))
    frac[rng.uniform(size=frac.shape) < 0.3] = 0.0
    frac[rng.uniform(size=frac.shape) < 0.2] = 1.0
    return frac


U0 = np.array([0.85, 0.004])            # noon, night


def tt(x):
    return torch.tensor(np.asarray(x))


def jj(x, c):
    return jnp.asarray(np.asarray(x)[c])


@pytest.fixture(scope="module")
def pairs(inp):
    tb = ttables.load_pifm2(str(inp))
    return jsolver.PairTables(tb), tsolver.PairTables(tb)


def test_interp_k_matches_jax(pairs):
    jpt, tpt = pairs
    t, p, _, _ = profiles()
    for coef, stanp, tref in ((tpt.cs_solar, tsolver.STANP_S, 245.0),
                              (tpt.c10ch4, tsolver.STANP_I, 245.0),
                              (tpt.ci_h2o, tsolver.STANP_I,
                               tpt.tref_i[:, None])):
        got = tsolver.interp_k(tt(coef), tt(stanp), tt(p), tt(t),
                               tref if np.isscalar(tref) else tt(tref))
        want = [jsolver.interp_k(jnp.asarray(coef), stanp, jj(p, c),
                                 jj(t, c), tref) for c in range(B)]
        close_by_column(want, got, TOL, "fkg")


def test_gas_tau_matches_jax(pairs):
    jpt, tpt = pairs
    t, p, xm1, qmo3 = profiles()
    tg, hk = tsolver.gas_tau(tpt, tt(p), tt(t), tt(xm1), tt(qmo3))
    assert tg.shape == (B, tpt.npairs, L)
    want = []
    for c in range(B):
        wtg, whk = jsolver.gas_tau(jpt, jj(p, c), jj(t, c), jj(xm1, c),
                                   jj(qmo3, c), jnp.float64)
        want.append(wtg)
        assert np.array_equal(np.asarray(whk), hk.numpy())
    close_by_column(want, tg, TOL, "tg")


def test_frr_matches_jax():
    frac = frac_of()
    bb, cc = tsolver.frr(tt(frac))
    for c in range(B):
        wbb, wcc = jsolver.frr(jj(frac, c))
        assert_close(wbb, column(bb, c), TOL, "bb")
        assert_close(wcc, column(cc, c), TOL, "cc")


def test_water_optics_matches_jax(pairs):
    jpt, tpt = pairs
    rng = np.random.default_rng(3)
    ret = tpt.tb.ret
    # inside the table, below, above and exactly on tabulated radii
    rew = rng.uniform(0.5 * ret[0], 1.5 * ret[-1], (B, L))
    rew[0, :4] = ret[:4]
    rew[1, :2] = (ret[0], ret[-1])
    rew[1, 2] = 0.0
    rho2w = np.where(rng.uniform(size=(B, L)) < 0.6,
                     10.0 ** rng.uniform(-5.0, -3.0, (B, L)), 1e-6)
    thk = rng.uniform(5.0, 2000.0, (B, L))
    frac = frac_of()
    got = tsolver.water_optics(tpt, tt(frac), tt(rew), tt(rho2w), tt(thk))
    for c in range(B):
        want = jsolver.water_optics(jpt.tb, jj(frac, c), jj(rew, c),
                                    jj(rho2w, c), jj(thk, c), jnp.float64)
        for name, w, g in zip(("t2w", "w2w", "pl2w"), want, got):
            assert_close(w, column(g, c), TOL, name)


def test_qopcon_matches_jax():
    t, p, xm1, _ = profiles()
    vv = tsolver.VV_CONT
    got = tsolver.qopcon(tt(vv)[None, :, None], tt(t)[:, None, :],
                         tt(p)[:, None, :], tt(xm1)[:, None, :])
    for c in range(B):
        want = jax.vmap(lambda v: jsolver.qopcon(
            v, jj(t, c), jj(p, c), jj(xm1, c)))(jnp.asarray(vv))
        assert_close(want, column(got, c), TOL, "tgcon")


def test_plkavg_matches_jax():
    """All 12 IR bands at once against JAX's band-by-band calls, over
    temperatures that put c2 nu / T on the series' split points (and on
    1.5), and below 1e-4 K."""
    wvl = tsolver.WVL
    c2 = 1.438786
    edges = np.array(tsolver.PLANCK_VCP[:-1] + (1.5,))
    t = np.concatenate([[0.0, 5e-5, 150.0, 288.0, 330.0],
                        (c2 * wvl[[1, 3, 6, 9]][:, None] / edges).ravel()])
    t = np.stack([t, t[::-1]])
    got = tsolver.plkavg(tt(wvl[1:, None]), tt(wvl[:-1, None]),
                         tt(t)[:, None, :])
    for c in range(B):
        want = jnp.stack([jsolver.plkavg(wvl[b + 1], wvl[b], jj(t, c))
                          for b in range(12)])
        assert_close(want, column(got, c), TOL, "pib")


def test_planck_series_terms_at_the_split_points():
    """The exponential series takes term jm >= 2 iff v < VCP[jm-2], which
    is the JAX package's count searchsorted(-vcp, -v, 'left') + 1 >= jm,
    also on the split points themselves."""
    vcp = np.array(tsolver.PLANCK_VCP)
    v = np.concatenate([vcp, np.nextafter(vcp, np.inf),
                        np.nextafter(vcp, -np.inf), [0.3, 20.0]])
    v = v[v >= 0.0]
    _, d, _ = tsolver._planck_series(tt(v))
    mmax = np.searchsorted(-vcp, -v, side="left") + 1
    conc = 15.0 / np.pi ** 4
    want = np.zeros_like(v)
    for jm in range(1, 8):
        mv = jm * v
        term = np.exp(-np.minimum(v, 80.0)) ** jm \
            * (6.0 + mv * (6.0 + mv * (3.0 + mv))) / jm ** 4
        want += np.where(jm <= mmax, term, 0.0)
    np.testing.assert_allclose(d.numpy(), conc * want, rtol=1e-13)


def test_total_tau_matches_jax():
    rng = np.random.default_rng(4)
    P = 7
    lay = [10.0 ** rng.uniform(-8.0, 0.0, (B, P, L)) for _ in range(6)]
    lay[2] = rng.uniform(0.0, 1.0, (B, P, L))          # waer
    lay[0][0, 0] = 0.0                                 # no Rayleigh/aerosol
    lay[1][0, 0] = 0.0
    pl2 = [rng.uniform(0.0, 2.0, (B, P, 2, L)) for _ in range(2)]
    dtaur, taer, waer, tgcon, tg, t2w = lay
    w2w = rng.uniform(0.3, 1.0, (B, P, L))
    args = (dtaur, taer, waer, pl2[0], tgcon, tg, t2w, w2w, pl2[1])
    got = tsolver.total_tau(*(tt(x) for x in args))
    for c in range(B):
        want = jsolver.total_tau(*(jj(x, c) for x in args))
        for name, w, g in zip(("dtau", "om", "pl"), want, got):
            assert_close(w, column(g, c), TOL, name)


def test_kurzw_coefficients_match_jax():
    dtau, om, pl = optics()
    got = tsolver.kurzw_coefficients(tt(dtau), tt(om), tt(pl), tt(U0))
    for c in range(B):
        want = jsolver.kurzw_coefficients(jj(dtau, c), jj(om, c),
                                          jj(pl, c), U0[c])
        for k, (w, g) in enumerate(zip(want, got)):
            assert_close(w, column(g, c), TOL, f"a{k + 1}")


def test_kurzw_propagate_matches_jax():
    dtau, om, pl = optics()
    a = [x.numpy() for x in tsolver.kurzw_coefficients(
        tt(dtau), tt(om), tt(pl), tt(U0))]
    bb, cc = (x.numpy() for x in tsolver.frr(tt(frac_of())))
    alb = np.random.default_rng(5).uniform(0.05, 0.8, dtau.shape[1])
    got = tsolver.kurzw_propagate(tt(a[0]), tt(a[1]), tt(a[2]), tt(a[5]),
                                  tt(bb), tt(cc), tt(U0), tt(alb))
    names = ("sf", "sw", "ssf", "ssw", "f1f", "f1w", "f2f", "f2w")
    for c in range(B):
        want = jsolver.kurzw_propagate(
            jj(a[0], c), jj(a[1], c), jj(a[2], c), jj(a[5], c), jj(bb, c),
            jj(cc, c), U0[c], jnp.asarray(alb))
        for name, w, g in zip(names, want, got):
            assert_close(w, column(g, c), TOL, name)


def test_langw_coefficients_match_jax():
    """a6 of the absorbing and scattering case is (1 - a4 - a5) /
    ((alph1 + alph2) dtau): at dtau ~ 1e-7 and om near 1 the numerator
    (~1e-10) is a difference of order-one terms, so each package's value
    carries an absolute rounding error of a few eps / ((alph1 + alph2)
    dtau) (6e-9 at dtau = 1.2e-7, om = 0.9995 here).  a6 is held to that
    bound, with alph1 + alph2 = 1.66 (1 - om + 2 b0 om) >= 0.1 for these
    phase functions (b0 >= 0.0375); everything else to TOL."""
    dtau, om, pl = optics(seed=6)
    got = tsolver.langw_coefficients(tt(dtau), tt(om), tt(pl))
    eps = np.finfo(np.float64).eps
    for c in range(B):
        want = jsolver.langw_coefficients(jj(dtau, c), jj(om, c), jj(pl, c))
        for name, w, g in zip(("a4", "a5"), want, got):
            assert_close(w, column(g, c), TOL, name)
        w6 = np.asarray(want[2])
        bound = TOL * np.abs(w6).max() + 64.0 * eps / (0.1 * dtau[c])
        assert (np.abs(got[2][c].numpy() - w6) <= bound).all(), "a6"


def ir_system(seed=7):
    """a4, a5, a6, pib, pibs, frac, emis, bb, cc of an IR pair batch."""
    dtau, om, pl = optics(seed=seed)
    a4, a5, a6 = (x.numpy() for x in tsolver.langw_coefficients(
        tt(dtau), tt(om), tt(pl)))
    rng = np.random.default_rng(seed)
    P = dtau.shape[1]
    pib = rng.uniform(10.0, 120.0, (B, P, L + 1))
    pibs = rng.uniform(10.0, 120.0, (B, P))
    emis = rng.uniform(0.9, 1.0, P)
    frac = frac_of(seed)
    bb, cc = (x.numpy() for x in tsolver.frr(tt(frac)))
    return a4, a5, a6, pib, pibs, frac, emis, bb, cc


def test_langw_rhs_matches_jax():
    a4, a5, a6, pib, pibs, frac, emis, bb, _ = ir_system()
    got = tsolver.langw_rhs(tt(a4), tt(a5), tt(a6), tt(pib), tt(pibs),
                            tt(frac), tt(emis), tt(bb))
    for c in range(B):
        want = jsolver.langw_rhs(jj(a4, c), jj(a5, c), jj(a6, c),
                                 jj(pib, c), jj(pibs, c), jj(frac, c),
                                 jnp.asarray(emis), jj(bb, c))
        for name, w, g in zip(("f1f", "f1w", "f2f", "f2w"), want, got):
            assert_close(w, column(g, c), TOL, name)


def test_jeanfr_matches_jax():
    a4, a5, a6, pib, pibs, frac, emis, bb, cc = ir_system(seed=8)
    rhs = [x.numpy() for x in tsolver.langw_rhs(
        tt(a4), tt(a5), tt(a6), tt(pib), tt(pibs), tt(frac), tt(emis),
        tt(bb))]
    ae = 1.0 - emis
    got = tsolver.jeanfr(tt(a4), tt(a5), tt(bb), tt(cc),
                         *(tt(x) for x in rhs), tt(ae))
    for c in range(B):
        want = jsolver.jeanfr(jj(a4, c), jj(a5, c), jj(bb, c), jj(cc, c),
                              *(jj(x, c) for x in rhs), jnp.asarray(ae))
        for name, w, g in zip(("f1f", "f1w", "f2f", "f2w"), want, got):
            assert_close(w, column(g, c), TOL, name)


# --------------------------------------------------------------------------
# driver
# --------------------------------------------------------------------------

def test_build_static_matches_jax(models):
    jm, tm, _ = models
    jd, td = jm._radiation, tm._radiation
    for name in ("zx", "thk", "qmo3", "t_up", "p_up", "xm1_up", "bea_up",
                 "baa_up", "ga_up"):
        w, g = getattr(jd, name), getattr(td, name)
        assert g.shape == w.shape, name
        assert field_err(w, g[None]) <= STATIC_TOL, name


def test_qabs_installed_like_jax(models):
    jm, tm, _ = models
    assert np.array_equal(jm.consts["qabs"], tm.consts["qabs"])
    assert jm.consts["qabs"].max() > 0.0


def test_rotate_back_is_the_index_map():
    n, nrlay = 7, 12
    x = np.arange(3 * nrlay, dtype=np.float64).reshape(3, nrlay) + 1.0
    j = np.arange(1, n)
    want = np.concatenate([np.zeros((3, 1)), x[:, nrlay - j]], axis=1)
    got = tdriver.rotate_back(tt(x), n)
    assert np.array_equal(got.numpy(), want)


@pytest.fixture(scope="module")
def jax_rad(models):
    return jax.jit(models[0]._radiation)


def test_driver_matches_jax_noon_and_midnight(models, noon_midnight,
                                              jax_rad):
    """dtrad, totrad, sk and sl of a noon and a midnight column in one
    batch, each against its own JAX call."""
    _, tm, _ = models
    states, ts = noon_midnight
    assert float(ts.rad.u0[NOON]) > 0.5 > 0.01 > float(ts.rad.u0[MIDNIGHT])
    got = tm._radiation(ts).rad
    want = [jax_rad(s).rad for s in states]
    for name in ("dtrad", "totrad", "sk", "sl"):
        close_by_column([getattr(w, name) for w in want], getattr(got, name),
                        TOL, name)
    assert got.sk[NOON] > 0.0 and got.sk[MIDNIGHT] == 0.0


def test_nstrahl_matches_jax(models, noon_midnight):
    """The solve alone, from the driver's top-down inputs."""
    jm, tm, _ = models
    states, ts = noon_midnight
    td = tm._radiation
    prof = td.load_profile(ts)
    c = td._consts(ts.met.t.device)

    def flip(x):
        return torch.flip(x, [-1])

    tx, px, rhox, xm1x, tsfc, bea, baa, ga = prof
    zeros = torch.zeros((B, td.gp.nrlay), dtype=tx.dtype)
    got = tdriver.nstrahl(td.pt, flip(tx), flip(px), flip(rhox), flip(xm1x),
                          tsfc, c["qmo3_td"].expand(B, -1), flip(bea),
                          flip(baa), flip(ga), zeros, zeros, zeros,
                          c["thk_td"].expand(B, -1), ts.rad.u0, c["albedo"],
                          c["emis"], c["berayl"])
    jd = jm._radiation
    jax_nstrahl = jax.jit(lambda *a: jdriver.nstrahl(jd.pt, jd.tb, *a,
                                                     jnp.float64))
    for col in range(B):
        def j(x):
            return jnp.asarray(x[col].numpy()[..., ::-1].copy())
        zl = jnp.zeros(td.gp.nrlay)
        want = jax_nstrahl(
            j(tx), j(px), j(rhox), j(xm1x), jnp.asarray(tsfc[col].item()),
            jnp.asarray(jd.qmo3[::-1].copy()), j(bea), j(baa), j(ga), zl, zl,
            zl, jnp.asarray(jd.thk[::-1].copy()),
            jnp.asarray(ts.rad.u0[col].item()), jnp.asarray(jd.albedo),
            jnp.asarray(jd.emis), jnp.asarray(jd.tb.berayl))
        for name, w, g in zip(("hr", "totrad", "fnseb", "flgeg"), want, got):
            assert_close(w, column(g, col), TOL, name)


def test_kon_takes_the_mie_absorption_like_jax(models, noon_midnight,
                                               jax_rad):
    """kon with the driver's qabs and the radiation fields of a noon and
    a midnight call (the droplets' radiative term on)."""
    jm, tm, _ = models
    states, ts = noon_midnight
    states = [jax_rad(s) for s in states]
    out = tgrowth.kon(tm, to_port_columns(states), 10.0)
    jax_kon = jax.jit(lambda s: jgrowth.kon(jm, s, 10.0))
    for c, js in enumerate(states):
        want = jax_kon(js)
        for name in ("t", "xm1", "feu", "xm2"):
            assert_close(getattr(want.met, name),
                         column(getattr(out.met, name), c), TOL, name)
        assert_close(want.micro.ff, column(out.micro.ff, c), TOL, "ff")
        assert_equal_int(want.micro.lct, column(out.micro.lct, c), "lct")


def test_driver_float32_matches_jax_float32(tmp_path):
    """One float32 call of a noon and a midnight column.  The JAX float32
    state carries u0 in float64 (its clock arithmetic promotes under x64);
    the port computes u0 in the state's dtype, so it gets u0 in float32."""
    jm, tm, js = make_models(tmp_path, dtype="float32", radiation=True)
    states = [at_noon(jm, js), js]
    ts = to_port_columns(states)
    ts = ts.replace(rad=ts.rad.replace(u0=ts.rad.u0.float()))
    got = tdriver.RadiationDriver(tm)(ts).rad
    jax_rad = jax.jit(jm._radiation)
    want = [jax_rad(s).rad for s in states]
    for name in ("dtrad", "totrad", "sk", "sl"):
        assert getattr(got, name).dtype == torch.float32, name
        close_by_column([getattr(w, name) for w in want], getattr(got, name),
                        F32_TOL[name], name)
