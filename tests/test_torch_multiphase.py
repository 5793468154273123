"""Parity of the PyTorch port's multiphase chemistry driver with the JAX
package: the synthetic tot mechanism (``write_synthetic_tot_mechanism``,
read by both packages), ``liq_parm``, the tot rate constants with every
hook of the rate namespace live and ``reaction_rates_at``, the tot and
gas-above Ros3 solves of ``integrate_column``, and the couplers ``konc``,
``sedl`` and ``aerosol_mass_feedback``.  Tiny grid, float64, the small
tot stand-in (``_torch_parity.N_GAS_TOT`` gas species, ``N_AQ_TOT``
aqueous stems); a foggy noon column with aerosol dried out on some levels
and the midnight initial column in one batch."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (N_AQ_TOT, N_GAS_TOT, assert_close,
                           assert_equal_int, assert_rows_close, column,
                           foggy, make_models, to_port_columns)

from mistra_tpu.chemistry import mech as jmech
from mistra_tpu.model import solar_zenith
from mistra_tpu_torch.chemistry import mech as tmech
from mistra_tpu_torch.chemistry.block_solver import BlockArrowSolver

# float64, the same formulas on the same inputs: the drivers' algebra
# differs from JAX's only in the last bits of exp/sqrt/pow and in
# summation order (far below 1e-10 of each field's scale; a wrong term or
# index shows at 1e-3 or more)
TOL = 1e-10
# the Ros3 solves take the same steps in both packages; their ~1e-16
# differences pass through ~100 steps of stiff stage solves
ROS3_RTOL = 1e-8
NOON, MIDNIGHT = 0, 1
# every hook of the driver's rate namespace, as the rate strings spell
# them after the bin cloning (xliqz -> xliq1.., cvvz -> cvv1..)
HOOKS = ("xliq", "cvv", "xhet1", "xhet2", "yxkmt", "yhenry", "ykef",
         "ykeb", "ycw", "fdhetg", "fdheta", "fdhett", "fhet_da", "fhet_dt",
         "fhet_t", "c(ind_")
# the aqueous stems the drivers look up by name
NAMED_STEMS = ("Hp", "NH4p", "HSO4m", "SO42m", "NO3m", "Clm", "HCO3m", "Brm",
               "Im", "IO3m", "DOM", "CH3SO3m", "HNO3")


@pytest.mark.parametrize("n_gas,n_aq", [(N_GAS_TOT, N_AQ_TOT), (95, 80),
                                         (None, None)])
def test_tot_stand_in_loads_like_jax(tmp_path, n_gas, n_aq):
    """The same Mechanism in both packages, with the names the drivers
    look up and every hook; no reaction couples two aqueous bins; at the
    defaults (None) the reference's shape: a gas core of 95, bins of at
    most 80 (the reference's ~80, which sets the inverse's tile), ~1,600
    reactions."""
    if n_gas is None:
        tmech.write_synthetic_tot_mechanism(tmp_path)
        n_gas, n_aq = 95, 78
    else:
        tmech.write_synthetic_tot_mechanism(tmp_path, n_gas, n_aq)
    mt = tmech.load_multiphase_mechanism(str(tmp_path))
    mj = jmech.load_multiphase_mechanism(str(tmp_path))
    assert mt.species == mj.species and mt.fixed == mj.fixed
    assert [(r.label, r.rate_expr) for r in mt.reactions] == \
        [(r.label, r.rate_expr) for r in mj.reactions]
    for name in ("stoich", "ridx", "species_bin"):
        assert np.array_equal(getattr(mt, name), getattr(mj, name)), name
    for b in range(1, 5):
        for stem in NAMED_STEMS:
            assert f"{stem}l{b}" in mt.species
    gas = tmech.load_gas_mechanism(str(tmp_path))
    assert set(gas.species) <= set(mt.species)
    for hook in HOOKS:
        assert any(hook in r.rate_expr for r in mt.reactions), hook
    # the block-arrow layout refuses a cross-bin Jacobian entry
    blk = BlockArrowSolver(mt, device="cpu")
    sizes = np.bincount(mt.species_bin, minlength=5)
    assert (blk.nbin, blk.mg) == (4, n_gas)
    assert tuple(sizes[1:]) == (n_aq + 2, n_aq + 1, n_aq, n_aq)
    if (n_gas, n_aq) == (95, 80):
        assert mt.nvar == 418 and blk.ma == 82
        assert abs(mt.nrxn - 1627) <= 10
    if (n_gas, n_aq) == (95, 78):
        assert mt.nvar == 410 and blk.ma == 80
        assert abs(mt.nrxn - 1593) <= 10


@pytest.mark.parametrize("n_gas,n_aq", [(11, 40), (12, 20)])
def test_tot_stand_in_refuses_too_small(tmp_path, n_gas, n_aq):
    with pytest.raises(ValueError, match="must be at least"):
        tmech.write_synthetic_tot_mechanism(tmp_path, n_gas, n_aq)


# --------------------------------------------------------------------------
# the driver, on a two-column batch
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """(JAX model, port model with its drivers installed, JAX init state):
    chem=T, nkc_l=4, radiation off."""
    inp = tmp_path_factory.mktemp("inp")
    mech = tmp_path_factory.mktemp("mech")
    jm, tm, js = make_models(inp, mechdir=mech, multiphase=True)
    tm.init_state(1)
    return jm, tm, js


@pytest.fixture(scope="module")
def columns(models):
    """A foggy noon column with random J-rates, its aerosol dried out
    (relative humidity 0.35) on five levels, random hysteresis flags, the
    gas species scattered by up to x10 either way and every aqueous
    species at random concentrations; and the midnight initial column:
    the JAX states and the port batch."""
    jm, tm, js = models
    nf = jm.cfg.grid.nf
    drv = tm._chemistry
    rng = np.random.default_rng(7)
    tim = js.tim.replace(lst=jnp.int32(12))
    u0 = solar_zenith(tim.lst, tim.lmin, jm.astro.alat, jm.astro.declin)
    noon = foggy(js, nf, seed=5)
    feu = np.array(noon.met.feu)
    feu[nf - 7:nf - 2] = 0.35
    conc = np.array(js.chem.conc)
    gas = drv.gas_in_tot
    conc[gas] *= 10.0 ** rng.uniform(-1.0, 1.0, conc[gas].shape)
    aq = np.nonzero(np.asarray(drv.tot.species_bin) > 0)[0]
    conc[aq] = conc[aq] + 1e-9 * rng.random(conc[aq].shape)
    conc[:, 0] = np.asarray(js.chem.conc)[:, 0]
    pj = 1e-5 * rng.random(np.shape(js.chem.photol_j))
    cloud = rng.random(np.shape(js.chem.cloud)) < 0.5
    noon = noon.replace(
        tim=tim, met=noon.met.replace(feu=jnp.asarray(feu)),
        rad=noon.rad.replace(u0=u0),
        chem=noon.chem.replace(conc=jnp.asarray(conc),
                               photol_j=jnp.asarray(pj),
                               cloud=jnp.asarray(cloud)))
    states = [noon, js]
    return states, to_port_columns(states)


def by_column(want_cols, got, tol, what):
    for c, w in enumerate(want_cols):
        assert_close(w, column(got, c), tol, f"{what}[{c}]")


def test_liq_parm_matches_jax(models, columns):
    """The aqueous stack of both columns: cw_rc with its hysteresis,
    fast_k_mt, the Pitzer activities inside equil_constants, and the
    het-on-dry-aerosol rates."""
    jm, tm, _ = models
    states, ts = columns
    got = tm._chemistry.liq_parm(ts)
    want = [jm._chemistry.liq_parm(s) for s in states]
    for key in ("cw", "cm", "rc", "conv2", "xkmt", "vt"):
        by_column([w[key] for w in want], got[key], TOL, key)
    for c, w in enumerate(want):
        assert_equal_int(w["cloud"], column(got["cloud"], c), "cloud")
        for table in ("kef", "keb"):
            for k, v in w[table].items():
                assert_close(v, column(got[table][k], c), TOL,
                             f"{table}[{k}][{c}]")
        dry = got["dry"]
        for k in ("xkmtd", "henry_dry"):
            for name, v in w["dry"][k].items():
                assert_close(v, column(dry[k][name], c), TOL,
                             f"{k}[{name}][{c}]")
        for k in ("xeq_hno3", "cwd", "rcd"):
            assert_close(w["dry"][k], column(dry[k], c), TOL, f"{k}[{c}]")
    # the noon column has all four bins active somewhere, and dry
    # aerosol (bins 1-2 inactive) on the dried levels
    active = got["cm"][NOON] > 0.0
    assert active.any(dim=1).all()
    assert not active[:2, 14:17].any()


def test_tot_rate_constants_match_jax_every_hook_live(models, columns):
    """The tot mechanism's rate constants and fixed species of every
    layer below nf, every reaction to 1e-10 of its largest value; each
    hook of the namespace gives a nonzero rate somewhere; and the
    instantaneous reaction rates (reaction_rates_at) of a few levels."""
    jm, tm, _ = models
    states, ts = columns
    td, jd = tm._chemistry, jm._chemistry
    nf = jm.cfg.grid.nf
    lev = np.arange(1, nf)
    lev_t = torch.arange(1, nf)
    lp = td.liq_parm(ts)
    y0 = torch.clamp(ts.chem.conc, min=0.0)[..., lev_t].transpose(1, 2) \
        .reshape(-1, td.tot.nvar)
    k, fix = td._tot_env(ts, lp, lev_t, y0)
    k, fix = k.reshape(2, nf - 1, -1), fix.reshape(2, nf - 1, -1)
    for c, s in enumerate(states):
        jlp = jd.liq_parm(s)
        jy0 = jnp.maximum(s.chem.conc, 0.0)[:, lev].T
        jk, jfix = jd._tot_env(s, jlp, lev, jy0)
        assert_rows_close(np.asarray(jk).T, column(k, c).transpose(1, 2),
                          TOL, f"k[{c}]")
        assert_close(jfix, column(fix, c), TOL, f"fix[{c}]")
    rx = td.tot.reactions
    for hook in HOOKS:
        use = [i for i, r in enumerate(rx) if hook in r.rate_expr]
        assert (k[NOON][:, use] != 0.0).any(), hook
    # the budget diagnostics' instantaneous rates at a few levels
    levels = [1, 5, nf - 1]
    rr = td.reaction_rates_at(ts, levels).reshape(2, len(levels), -1)
    for c, s in enumerate(states):
        assert_rows_close(np.asarray(jd.reaction_rates_at(s, levels)).T,
                          column(rr, c).transpose(1, 2), TOL, f"rates[{c}]")


def test_ros3_solves_match_jax(models, columns):
    """One 10-s substep of integrate_column: the tot solve of every layer
    below nf and the gas-above solve, each in one Ros3 batch for both
    columns, give the concentrations within rtol 1e-8 and the same steps
    in every cell as the JAX package's per-column solves; nonconv and
    the hysteresis flags equal."""
    jm, tm, _ = models
    states, ts = columns
    td, jd = tm._chemistry, jm._chemistry
    nf, n = jm.cfg.grid.nf, jm.cfg.grid.n
    got = td.integrate_column(ts, 10.0)
    tot_steps = td.last_info["nsteps"].reshape(2, nf - 1)
    gas_steps = td.last_gas_info["nsteps"].reshape(2, n - 1 - nf)

    def jax_run(s):
        infos = {}
        spied = {}
        for name in ("kernel", "tot_kernel"):
            kern = getattr(jd, name)
            spied[name] = kern.integrate

            def spy(*a, _name=name, _f=kern.integrate, **kw):
                y, info = _f(*a, **kw)
                infos[_name] = info["nsteps"]
                return y, info
            kern.integrate = spy
        try:
            out = jd.integrate_column(s, 10.0)
        finally:
            for name, f in spied.items():
                getattr(jd, name).integrate = f
        return out, infos["tot_kernel"], infos["kernel"]

    run = jax.jit(jax_run)
    for c, s in enumerate(states):
        want, jtot, jgas = run(s)
        wc = np.asarray(want.conc)
        scale = np.abs(wc).max(axis=1, keepdims=True)
        np.testing.assert_allclose(got.conc[c].numpy(), wc, rtol=ROS3_RTOL,
                                   atol=1e-22, err_msg=f"conc[{c}]")
        assert (np.abs(got.conc[c].numpy() - wc) <= TOL * scale).all()
        assert np.array_equal(np.asarray(jtot), tot_steps[c].numpy())
        assert np.array_equal(np.asarray(jgas), gas_steps[c].numpy())
        assert_equal_int(want.nonconv, column(got.nonconv, c), "nonconv")
        assert_equal_int(want.cloud, column(got.cloud, c), "cloud")
    assert tot_steps.float().mean() > 5.0 and (got.nonconv == 0).all()


def test_konc_matches_jax(models, columns):
    """konc with the spectrum changed around it, so that particles cross
    the aerosol/droplet threshold in both directions."""
    jm, tm, _ = models
    states, ts = columns
    rng = np.random.default_rng(3)
    fac = rng.uniform(0.2, 2.0, np.shape(states[0].micro.ff))
    got = tm._chemistry.konc(ts.chem, ts.micro.ff,
                             ts.micro.ff * torch.tensor(fac))
    for c, s in enumerate(states):
        want = jm._chemistry.konc(s.chem, s.micro.ff, s.micro.ff * fac)
        assert_rows_close(want.conc, column(got.conc, c), TOL, f"conc[{c}]")
    assert not torch.equal(got.conc, ts.chem.conc)


def test_sedl_matches_jax(models, columns):
    """Wet deposition of every bin's species into the ground reservoir,
    the fixed 8 Courant sub-iterations included."""
    jm, tm, _ = models
    states, ts = columns
    got = tm._chemistry.sedl(ts, 10.0)
    for c, s in enumerate(states):
        want = jm._chemistry.sedl(s, 10.0)
        assert_rows_close(want.conc, column(got.conc, c), TOL, f"conc[{c}]")
    aq = np.nonzero(np.asarray(tm._chemistry.tot.species_bin) > 0)[0]
    assert (got.conc[NOON, aq, 0] > ts.chem.conc[NOON, aq, 0]).any()


def test_aerosol_mass_feedback_matches_jax(models, columns):
    """The particle shift along the dry-mass grid and the dissolved
    species carried across the chemistry bins, after a chemistry step
    that changed the ions' mass by up to 50 % either way."""
    jm, tm, _ = models
    states, ts = columns
    rng = np.random.default_rng(4)
    fac = rng.uniform(0.5, 1.5, np.shape(states[0].chem.conc))
    got = tm._chemistry.aerosol_mass_feedback(
        ts, ts.chem.conc * torch.tensor(fac))
    for c, s in enumerate(states):
        want = jm._chemistry.aerosol_mass_feedback(s, s.chem.conc * fac)
        assert_close(want.micro.ff, column(got.micro.ff, c), TOL,
                     f"ff[{c}]")
        assert_close(want.micro.fsum, column(got.micro.fsum, c), TOL,
                     f"fsum[{c}]")
        assert_rows_close(want.chem.conc, column(got.chem.conc, c), TOL,
                          f"conc[{c}]")
    assert not torch.equal(got.micro.ff, ts.micro.ff)
