"""The multiphase chem=T column minute of the PyTorch port (mic=T, nkc_l=4,
water surface, PIFM2 radiation and photolysis on, neula=0) against the
JAX package's jitted ``minute_step``, tiny grid, the synthetic tables and
the small synthetic tot mechanism; and the port's own conservation checks
of the three couplers (konc, the aerosol mass feedback, sedl), whose JAX
counterparts in tests/test_conservation.py need the reference's data."""

from __future__ import annotations

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (B, BTZ96, N_AQ_TOT, N_GAS_TOT, TINY_GRID,
                           assert_state_close, make_models, to_numpy,
                           to_port_columns)

import mistra_tpu_torch as pt
from mistra_tpu.model import solar_zenith
from mistra_tpu_torch.chemistry.mech import write_synthetic_tot_mechanism
from mistra_tpu_torch.physics.surface import write_synthetic_clarke_table

# float64, as the chem=T minute test (test_torch_chem_slice.py): each
# module matches JAX to 1e-10, and over whole minutes subkon's Newton exit
# test can flip within rounding and move the fields by up to ~1e-6 of
# their scale; the concentrations and J-rates follow those fields, so each
# species and J slot is held to 1e-6 of its largest value
TOL = 1e-6
NOON, MIDNIGHT = 0, 1


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    inp = tmp_path_factory.mktemp("inp")
    mech = tmp_path_factory.mktemp("mech")
    return make_models(inp, radiation=True, mechdir=mech, multiphase=True,
                       neula=0)


def at_noon(jm, js):
    """js at 12:00 local solar time with its u0 and, as the init would
    make them, its J-rates."""
    tim = js.tim.replace(lst=jnp.int32(12))
    u0 = solar_zenith(tim.lst, tim.lmin, jm.astro.alat, jm.astro.declin)
    s = js.replace(tim=tim, rad=js.rad.replace(u0=u0))
    pj = jnp.where(u0 > jm._chemistry.u0min, jax.jit(jm._photolysis)(s),
                   0.0)
    return s.replace(chem=s.chem.replace(photol_j=pj))


def test_multiphase_init_matches_jax(models):
    """The port's init (initc, the initial ion loading, the radiation
    call, the J-rates) matches the JAX init's, every field; the port
    builds the multiphase driver with its float64 tot kernel."""
    jm, tm, js = models
    ts = tm.init_state(B)
    assert_state_close(to_numpy(js), ts, TOL)
    drv = tm._chemistry
    assert type(drv).__name__ == "MultiphaseDriver"
    assert drv.tot_kernel.solver == "block"
    assert drv.tot_kernel.dtype == torch.float64
    assert drv.tot.nvar == ts.chem.conc.shape[1] == jm._chemistry.tot.nvar
    # the sea-salt ions are loaded into bin 2
    assert ts.chem.conc[:, drv.tot_n2i["Clml2"], 1:-1].min() > 0.0


def test_two_multiphase_minutes_match_jax(models):
    """A noon and a midnight column stepped in one batch: each matches its
    own two jitted JAX minutes (the whole multiphase substep: difc, konc,
    the sea-salt source, sedc, sedl, the tot and gas-above solves and the
    mass feedback), nonconv (0) and the hysteresis flags included."""
    jm, tm, js = models
    jax_step = jax.jit(jm.minute_step)
    tm.init_state(1)
    states = [at_noon(jm, js), js]
    ts = to_port_columns(states)
    for _ in range(2):
        states = [jax_step(s) for s in states]
        ts = tm.minute_step(ts)
        for c, s in enumerate(states):
            assert_state_close(to_numpy(s), ts.map(lambda x: x[c:c + 1]),
                               TOL)
    assert (ts.tim.time.numpy() == 120.0).all()
    assert ts.chem.photol_j[NOON].amax() > 0.0
    assert (ts.chem.photol_j[MIDNIGHT] == 0.0).all()
    assert (ts.chem.nonconv == 0).all()
    assert (ts.chem.conc[NOON] != ts.chem.conc[MIDNIGHT]).any()


def test_float32_multiphase_minute_stays_float32(tmp_path):
    """The multiphase minute in float32 (the state's dtype in production):
    no float64 leaks into the state, every field stays finite, the clock
    advances exactly; the tot solve, and the activities and equilibrium
    rates it is given, run in float64 (chem_f64)."""
    write_synthetic_clarke_table(tmp_path)
    write_synthetic_tot_mechanism(tmp_path, N_GAS_TOT, N_AQ_TOT)
    cfg = pt.MistraConfig(grid=pt.GridParams(**TINY_GRID), dtype="float32",
                          inpdir=str(tmp_path), mechdir=str(tmp_path),
                          **dict(BTZ96, chem=True, nkc_l=4))
    model = pt.Model(cfg, device="cpu")
    model.radiation_enabled = False
    state = model.minute_step(model.init_state(2))
    for sub in ("met", "turb", "surf", "micro", "rad", "tim", "chem"):
        for name, x in vars(getattr(state, sub)).items():
            if x.is_floating_point():
                assert x.dtype == torch.float32, f"{sub}.{name}"
                assert torch.isfinite(x).all(), f"{sub}.{name}"
    assert state.chem.cloud.dtype == torch.bool
    assert (state.tim.time.numpy() == 60.0).all()
    assert (state.chem.nonconv == 0).all()
    drv = model._chemistry
    assert drv.last_info["nsteps"].dtype == torch.int32
    lp = drv.liq_parm(state)
    assert lp["cw"].dtype == lp["xkmt"].dtype == torch.float32
    for table in ("kef", "keb"):
        for key, v in lp[table].items():
            assert v.dtype == torch.float64 and torch.isfinite(v).all(), key


# --------------------------------------------------------------------------
# conservation of the couplers (the port's versions of the three
# tests/test_conservation.py tests)
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_model(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("aq")
    write_synthetic_clarke_table(tmp)
    write_synthetic_tot_mechanism(tmp, N_GAS_TOT, N_AQ_TOT)
    cfg = pt.MistraConfig(grid=pt.GridParams(**TINY_GRID), dtype="float64",
                          inpdir=str(tmp), mechdir=str(tmp),
                          **dict(BTZ96, chem=True, nkc_l=4))
    model = pt.Model(cfg, device="cpu")
    model.radiation_enabled = False
    return model, model.init_state(B)


def aqueous_idx(drv, kc):
    return np.nonzero(np.asarray(drv.tot.species_bin) == kc)[0]


def seeded(drv, state, seed, top=None):
    """state with every aqueous species of every bin at random
    concentrations in [0, 1e-9) (zero from level top up, if given)."""
    rng = np.random.default_rng(seed)
    conc = state.chem.conc.clone()
    for kc in range(1, 5):
        idx = aqueous_idx(drv, kc)
        vals = rng.random((conc.shape[0], idx.size, conc.shape[2])) * 1e-9
        if top is not None:
            vals[..., top:] = 0.0
        conc[:, idx] = torch.tensor(vals)
    return state.replace(chem=state.chem.replace(conc=conc))


def species_totals(drv, conc):
    """{base name: the sum over the 4 bins of that species} [B, n]."""
    groups = {}
    for kc in range(1, 5):
        for i in aqueous_idx(drv, kc):
            base = re.sub(r"l[1-4]$", "", drv.tot.species[i])
            groups.setdefault(base, []).append(int(i))
    return {base: conc[:, idx].sum(1) for base, idx in groups.items()}


def test_konc_conserves_species(port_model):
    """konc moves dissolved species between the 4 bins with the particles
    that crossed the ka/kw thresholds in both directions; the 4-bin total
    of every species stays."""
    model, state = port_model
    drv = model._chemistry
    state = seeded(drv, state, 0)
    rng = np.random.default_rng(0)
    ff_before = state.micro.ff
    ff_after = ff_before * torch.tensor(
        rng.uniform(0.2, 2.0, tuple(ff_before.shape)))
    out = drv.konc(state.chem, ff_before, ff_after)
    assert not torch.equal(out.conc, state.chem.conc)
    before = species_totals(drv, state.chem.conc)
    after = species_totals(drv, out.conc)
    for base, tot in before.items():
        np.testing.assert_allclose(after[base].numpy(), tot.numpy(),
                                   rtol=1e-12, atol=1e-22, err_msg=base)


def test_mass_feedback_conserves(port_model):
    """aerosol_mass_feedback shifts particles along the dry-mass grid and
    carries dissolved species with the displaced volume: the particle
    number per level and the 4-bin species totals stay."""
    model, state = port_model
    drv = model._chemistry
    state = seeded(drv, state, 1)
    rng = np.random.default_rng(1)
    conc = state.chem.conc
    conc_before = conc * torch.tensor(rng.uniform(0.5, 1.5,
                                                  tuple(conc.shape)))
    out = drv.aerosol_mass_feedback(state, conc_before)
    assert not torch.equal(out.micro.ff, state.micro.ff)
    np.testing.assert_allclose(out.micro.ff.sum((1, 2)).numpy(),
                               state.micro.ff.sum((1, 2)).numpy(),
                               rtol=1e-10)
    np.testing.assert_allclose(out.micro.fsum.numpy(),
                               out.micro.ff.sum((1, 2)).numpy(), rtol=1e-14)
    before = species_totals(drv, conc)
    after = species_totals(drv, out.chem.conc)
    for base, tot in before.items():
        np.testing.assert_allclose(after[base].numpy(), tot.numpy(),
                                   rtol=1e-10, atol=1e-22, err_msg=base)


def test_sedl_closes_column_budget(port_model):
    """sedl only moves dissolved mass downward; whatever leaves the column
    shows up in the ground reservoir (level 0, mol/m2), closing each
    species' column budget."""
    model, state = port_model
    drv = model._chemistry
    nf = model.cfg.grid.nf
    detw = model.atm.detw.numpy()
    # the top level is an open feeding boundary (ff(nf)=ff(nf-1),
    # str.f90:2389): zero it so the closure is exact
    state = seeded(drv, state, 2, top=nf - 2)
    out = drv.sedl(state, 10.0)
    conc_b, conc_a = state.chem.conc.numpy(), out.conc.numpy()
    moved = False
    for kc in range(1, 5):
        idx = aqueous_idx(drv, kc)
        col_b = conc_b[:, idx, 1:nf - 1] @ detw[1:nf - 1]
        col_a = conc_a[:, idx, 1:nf - 1] @ detw[1:nf - 1]
        gnd_b, gnd_a = conc_b[:, idx, 0], conc_a[:, idx, 0]
        resid = (col_b - col_a) - (gnd_a - gnd_b)
        scale = np.abs(col_b).max() + 1e-30
        assert np.abs(resid).max() / scale < 1e-12, (kc, resid.max())
        moved |= bool((gnd_a > gnd_b).any())
    assert moved
