"""Parity of the PyTorch port's gas-phase chemistry driver with the JAX
package: the synthetic gas mechanism (``write_synthetic_gas_mechanism``,
read by both packages), ``init_chem_state``, ``gasdrydep``, ``sedc``,
``eulerian_advection`` (neula=0), the het-on-dry-aerosol rates, ``difc``,
the rate environment and ``integrate_column``.  Tiny grid, float64, the
small gas stand-in (``_torch_parity.N_GAS`` gas species + 7 binned); a
noon column with perturbed concentrations and the midnight initial column
in one batch."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (N_GAS, assert_close, assert_equal_int, column,
                           foggy, make_models, to_port_columns)

from mistra_tpu.chemistry import gas_kernel as jgk
from mistra_tpu.chemistry import mech as jmech
from mistra_tpu.model import solar_zenith
from mistra_tpu.physics import diffusion as jdiffusion
from mistra_tpu_torch.chemistry import gas_kernel as tgk
from mistra_tpu_torch.chemistry import mech as tmech
from mistra_tpu_torch.physics import diffusion as tdiffusion

# float64, the same formulas on the same inputs: the drivers' algebra
# differs from JAX's only in the last bits of exp/sqrt/pow and in
# summation order (far below 1e-10 of each field's scale; a wrong term or
# index shows at 1e-3 or more).  The Ros3 solve takes the same steps in
# both packages, so its ~1e-16 differences pass through ~10 stage solves
# per step of a well-conditioned stage matrix and stay near 1e-12
TOL = 1e-10
NOON, MIDNIGHT = 0, 1
BINNED = {"HNO3l1", "DUMM1", "NH3l1", "SO4l1", "HNO3l2", "NH3l2", "SO4l2"}


# --------------------------------------------------------------------------
# the stand-in mechanism
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n_gas", [N_GAS, 95])
def test_gas_stand_in_loads_like_jax(tmp_path, n_gas):
    """The same Mechanism in both packages, binned like the reference's
    gas.eqn, so that both GasKernels pick the block-arrow solver; at the
    defaults the reference's shape (nvar 102, 331 reactions, ma 4, mg
    95)."""
    tmech.write_synthetic_gas_mechanism(tmp_path, n_gas)
    mt = tmech.load_gas_mechanism(str(tmp_path))
    mj = jmech.load_gas_mechanism(str(tmp_path))
    assert mt.species == mj.species and mt.fixed == mj.fixed
    assert [(r.label, r.rate_expr) for r in mt.reactions] == \
        [(r.label, r.rate_expr) for r in mj.reactions]
    for name in ("stoich", "ridx", "species_bin"):
        assert np.array_equal(getattr(mt, name), getattr(mj, name)), name
    binned = {s for s, b in zip(mt.species, mt.species_bin) if b}
    assert binned == BINNED
    assert mt.nvar == n_gas + 7
    kt = tgk.GasKernel(mt, device="cpu")
    assert kt.solver == jgk.GasKernel(mj).solver == "block"
    assert (kt.block.nbin, kt.block.ma, kt.block.mg) == (2, 4, n_gas)
    if n_gas == 95:
        assert (mt.nvar, mt.nrxn) == (102, 331)
    # a share of the reactions are photolysis, with rates from photol_j
    assert sum("ph_rat(" in r.rate_expr for r in mt.reactions) \
        > 0.15 * mt.nrxn


# --------------------------------------------------------------------------
# the driver, on a two-column batch
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """(JAX model, port model with its drivers installed, JAX init state):
    chem=T, nkc_l=0, neula=0, radiation and photolysis on."""
    inp = tmp_path_factory.mktemp("inp")
    mech = tmp_path_factory.mktemp("mech")
    jm, tm, js = make_models(inp, radiation=True, mechdir=mech, neula=0)
    tm.init_state(1)
    return jm, tm, js


@pytest.fixture(scope="module")
def columns(models):
    """A foggy noon column with its noon J-rates and concentrations
    scattered by up to x10 either way, and the midnight initial column:
    the JAX states and the port batch."""
    jm, _, js = models
    rng = np.random.default_rng(7)
    tim = js.tim.replace(lst=jnp.int32(12))
    u0 = solar_zenith(tim.lst, tim.lmin, jm.astro.alat, jm.astro.declin)
    noon = foggy(js, jm.cfg.grid.nf, seed=5)
    noon = noon.replace(tim=tim, rad=noon.rad.replace(u0=u0))
    sgas = np.asarray(js.chem.sgas) \
        * 10.0 ** rng.uniform(-1.0, 1.0, js.chem.sgas.shape)
    pj = jax.jit(jm._photolysis)(noon)
    noon = noon.replace(chem=noon.chem.replace(sgas=jnp.asarray(sgas),
                                               photol_j=pj))
    states = [noon, js]
    return states, to_port_columns(states)


def by_column(want_cols, got, tol, what):
    for c, w in enumerate(want_cols):
        assert_close(w, column(got, c), tol, f"{what}[{c}]")


def test_init_chem_state_matches_jax(models):
    """initc's profiles (the halogens cut at the inversion), the air
    densities kept for the run, and the initial J-rates."""
    jm, tm, js = models
    got = tm.init_state(2)
    jd, td = jm._chemistry, tm._chemistry
    for name in ("sgas", "vg", "photol_j"):
        assert_close(getattr(js.chem, name), getattr(got.chem, name), TOL,
                     name)
    assert_equal_int(js.chem.nonconv, got.chem.nonconv, "nonconv")
    assert_close(jd.am3, td.am3[None], TOL, "am3")
    assert_close(jd.cm3, td.cm3[None], TOL, "cm3")
    kinv = int(js.tim.kinv)
    cl2 = td.name2i["Cl2"]
    assert (got.chem.sgas[:, cl2, kinv:] == 0.0).all()
    assert (got.chem.sgas[:, cl2, 1:kinv] > 0.0).all()


def test_gasdrydep_matches_jax(models, columns):
    jm, tm, _ = models
    states, ts = columns
    got = tm._chemistry.gasdrydep(ts)
    by_column([jm._chemistry.gasdrydep(s) for s in states], got, TOL, "vg")
    n2i = tm._chemistry.name2i
    # the fixed values and copies of the sedc preamble
    assert (got[:, n2i["NH3"]] == 0.27e-2).all()
    assert (got[:, n2i["DMS"]] == 0.0).all()
    assert (got[:, n2i["N2O5"]] == got[:, n2i["HCl"]]).all()


def test_sedc_matches_jax(models, columns):
    jm, tm, _ = models
    states, ts = columns
    td, jd = tm._chemistry, jm._chemistry
    chem = ts.chem.replace(vg=td.gasdrydep(ts))
    got = td.sedc(chem, 10.0, tm.atm.deta[1], tm.atm.detw[1])
    want = [jd.sedc(s.chem.replace(vg=jd.gasdrydep(s)), 10.0,
                    jm.atm.deta[1], jm.atm.detw[1]) for s in states]
    by_column([w.sgas for w in want], got.sgas, TOL, "sgas")
    # the emitted species gain at level 1
    nh3 = td.name2i["NH3"]
    assert (got.sgas[:, nh3, 1] != chem.sgas[:, nh3, 1]).all()


def test_eulerian_advection_matches_jax(models, columns):
    """neula=0: euler_in.dat's sources below each column's inversion."""
    jm, tm, _ = models
    states, ts = columns
    td, jd = tm._chemistry, jm._chemistry
    assert td.advect == jd.advect and len(td.advect) > 0
    kinv = ts.tim.kinv.clone()
    kinv[MIDNIGHT] = kinv[NOON] + 3           # per-column inversions
    got = td.eulerian_advection(ts.chem, kinv, td.am3, 10.0)
    for c, s in enumerate(states):
        want = jd.eulerian_advection(s.chem, int(kinv[c]), jd.am3, 10.0)
        assert_close(want.sgas, column(got.sgas, c), TOL, f"sgas[{c}]")
    i = td.name2i[td.advect[0][0]]
    changed = (got.sgas[:, i] != ts.chem.sgas[:, i]).sum(1)
    assert changed.tolist() == [int(k) for k in kinv]


def interior(state):
    """(levels 1..n-2, the clamped concentrations of those cells)."""
    sgas = np.maximum(np.asarray(state.chem.sgas), 0.0)
    lev = np.arange(1, sgas.shape[1] - 1)
    return lev, sgas[:, lev].T


def port_cells(ts, n):
    lev = torch.arange(1, n - 1)
    y0 = torch.clamp(ts.chem.sgas, min=0.0)[:, :, 1:n - 1]
    return lev, y0.transpose(1, 2).reshape(-1, ts.chem.sgas.shape[1])


@pytest.mark.parametrize("nb", [1, 2, 3, 4])
def test_het_extras_match_jax(models, columns, nb):
    """fdhetg(na, nb) of both aerosol bins, flattened as the cells are
    (the HNO3 uptake, nb = 1, reads the cells' concentrations)."""
    jm, tm, _ = models
    states, ts = columns
    n = jm.cfg.grid.n
    lev_t, y0_t = port_cells(ts, n)
    got = tm._chemistry._het_extras(ts, lev_t, y0_t)
    assert got["xhet1"] == got["xhet2"] == 1.0
    for na in (1, 2):
        g = got["fdhetg"](na, nb).reshape(2, n - 2)
        for c, s in enumerate(states):
            lev, y0 = interior(s)
            w = jm._chemistry._het_extras(s, lev, jnp.asarray(y0))
            assert_close(w["fdhetg"](na, nb), column(g, c), TOL,
                         f"fdhetg({na}, {nb})[{c}]")
        assert (g[NOON] > 0.0).any()


def test_difc_matches_jax(models, columns):
    jm, tm, _ = models
    states, ts = columns
    got = tdiffusion.difc({"c": ts.chem.sgas.transpose(1, 2)}, ts.met,
                          ts.turb, tm.atm, 10.0)["c"]
    for c, s in enumerate(states):
        want = jdiffusion.difc({"c": s.chem.sgas.T}, s.met, s.turb, jm.atm,
                               10.0)["c"]
        assert_close(want, column(got, c), TOL, f"difc[{c}]")


def test_rate_constants_match_jax(models, columns):
    """The rate environment of every interior cell (temperature, air,
    water, layer-mean J-rates cut at u0min, the het rates) through the
    mechanism's rate expressions; and reaction_rates_at."""
    jm, tm, _ = models
    states, ts = columns
    td, jd = tm._chemistry, jm._chemistry
    n = jm.cfg.grid.n
    lev_t, y0_t = port_cells(ts, n)
    env, fix = td._gas_env(ts, lev_t, y0_t)
    got = td.kernel.rate_constants(env, fix=fix).reshape(2, n - 2, -1)
    for c, s in enumerate(states):
        lev, y0 = interior(s)
        jenv, jfix = jd._gas_env(s, lev, y0=jnp.asarray(y0))
        assert_close(jd.kernel.rate_constants(jenv, fix=jfix),
                     column(got, c), TOL, f"k[{c}]")
        assert_close(jfix, column(fix.reshape(2, n - 2, -1), c), TOL, "fix")
    ph = [i for i, r in enumerate(td.mech.reactions) if "ph_rat(" in
          r.rate_expr]
    assert (got[NOON][:, ph] > 0.0).any() and (got[MIDNIGHT][:, ph] == 0.0
                                                ).all()
    levels = [1, 3, n - 2]
    rr = td.reaction_rates_at(ts, levels).reshape(2, len(levels), -1)
    for c, s in enumerate(states):
        assert_close(jd.reaction_rates_at(s, levels), column(rr, c), TOL,
                     f"rates[{c}]")


def test_integrate_column_matches_jax(models, columns):
    """One 10-s substep of every interior cell of both columns as one Ros3
    batch: the concentrations within 1e-10 of each species' scale, the
    same steps in every cell, and the same nonconv per column."""
    jm, tm, _ = models
    states, ts = columns
    td, jd = tm._chemistry, jm._chemistry
    n = jm.cfg.grid.n
    got = td.integrate_column(ts, 10.0)
    steps = td.last_info["nsteps"].reshape(2, n - 2)

    def jax_steps(s):
        lev = np.arange(1, n - 1)
        y0 = jnp.maximum(s.chem.sgas, 0.0)[:, lev].T
        env, fix = jd._gas_env(s, lev, y0=y0)
        k = jd.kernel.rate_constants(env, fix=fix)
        return jd.kernel.integrate(y0, k, fix, 10.0)[1]["nsteps"]

    jstep = jax.jit(jax_steps)
    jint = jax.jit(lambda s: jd.integrate_column(s, 10.0))
    for c, s in enumerate(states):
        want = jint(s)
        sg = np.asarray(want.sgas)
        scale = np.maximum(np.abs(sg).max(axis=1, keepdims=True), 1e-300)
        err = (np.abs(got.sgas[c].numpy() - sg) / scale).max()
        assert err <= TOL, f"sgas[{c}]: {err:.3e} of the species' scale"
        assert_equal_int(want.nonconv, column(got.nonconv, c), "nonconv")
        assert np.array_equal(np.asarray(jstep(s)), steps[c].numpy())
    assert (steps.float().mean() > 3.0) and (got.nonconv == 0).all()
    assert (got.sgas[:, :, 1:n - 1] != ts.chem.sgas[:, :, 1:n - 1]).any()
