"""The chem=T column minute of the PyTorch port (mic=T, nkc_l=0, water
surface, PIFM2 radiation and photolysis on, neula=0) against the JAX
package's jitted ``minute_step``, tiny grid, the synthetic tables and the
small synthetic gas mechanism; and the configurations the port refused
until its modes slice."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (B, BTZ96, N_AQ_TOT, N_GAS, N_GAS_TOT, TINY_GRID,
                           assert_state_close, make_models, to_numpy,
                           to_port_columns)

import mistra_tpu_torch as pt
from mistra_tpu.model import solar_zenith
from mistra_tpu_torch.boxmodel import write_synthetic_chamber_dat
from mistra_tpu_torch.chemistry.mech import (write_synthetic_gas_mechanism,
                                             write_synthetic_tot_mechanism)
from mistra_tpu_torch.photolysis.tables import \
    write_synthetic_photolysis_tables
from mistra_tpu_torch.physics.surface import write_synthetic_clarke_table
from mistra_tpu_torch.radiation.tables import \
    write_synthetic_radiation_tables

# float64, as the chem=F minute test (test_torch_slice.py): each module
# matches JAX to 1e-10, and over whole minutes subkon's Newton exit test
# can flip within rounding and move the fields by up to ~1e-6 of their
# scale; the concentrations and J-rates follow those fields, so each
# species and J slot is held to 1e-6 of its largest value
TOL = 1e-6
NOON, MIDNIGHT = 0, 1


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    inp = tmp_path_factory.mktemp("inp")
    mech = tmp_path_factory.mktemp("mech")
    return make_models(inp, radiation=True, mechdir=mech, neula=0)


@pytest.fixture(scope="module")
def jax_step(models):
    return jax.jit(models[0].minute_step)


def at_noon(jm, js):
    """js at 12:00 local solar time with its u0 and, as the init would
    make them, its J-rates."""
    tim = js.tim.replace(lst=jnp.int32(12))
    u0 = solar_zenith(tim.lst, tim.lmin, jm.astro.alat, jm.astro.declin)
    s = js.replace(tim=tim, rad=js.rad.replace(u0=u0))
    pj = jnp.where(u0 > jm._chemistry.u0min, jax.jit(jm._photolysis)(s),
                   0.0)
    return s.replace(chem=s.chem.replace(photol_j=pj))


def test_chem_init_matches_jax(models):
    """The port's init (initc, the radiation call, the J-rates) matches the
    JAX init's, every field; the port builds both drivers."""
    jm, tm, js = models
    ts = tm.init_state(B)
    assert_state_close(to_numpy(js), ts, TOL)
    assert type(tm._chemistry).__name__ == "ChemistryDriver"
    assert tm._chemistry.kernel.solver == "block"
    assert tm._photolysis is not None


def test_two_chem_minutes_match_jax(models, jax_step):
    """A noon and a midnight column stepped in one batch: each matches its
    own two jitted JAX minutes (the J-rates held on the odd minute and
    recomputed on the even one), nonconv included."""
    jm, tm, js = models
    tm.init_state(1)
    states = [at_noon(jm, js), js]
    ts = to_port_columns(states)
    pj0 = ts.chem.photol_j.clone()
    for minute in range(2):
        states = [jax_step(s) for s in states]
        ts = tm.minute_step(ts)
        for c, s in enumerate(states):
            assert_state_close(to_numpy(s), ts.map(lambda x: x[c:c + 1]),
                               TOL)
        if minute == 0:
            # odd minute: the noon column holds its J-rates
            assert torch.equal(ts.chem.photol_j, pj0)
    assert (ts.tim.time.numpy() == 120.0).all()
    assert (ts.chem.photol_j[NOON] != pj0[NOON]).any()
    assert ts.chem.photol_j[NOON].amax() > 0.0
    assert (ts.chem.photol_j[MIDNIGHT] == 0.0).all()
    assert (ts.chem.nonconv == 0).all()
    assert (ts.chem.sgas[NOON] != ts.chem.sgas[MIDNIGHT]).any()


def test_float32_chem_minute_stays_float32(tmp_path):
    """chem=T in float32 (the entry point's dtype): no float64 leaks into
    the state, every field stays finite, the clock advances exactly."""
    for write in (write_synthetic_clarke_table,
                  write_synthetic_radiation_tables,
                  write_synthetic_photolysis_tables):
        write(tmp_path)
    write_synthetic_gas_mechanism(tmp_path, N_GAS)
    cfg = pt.MistraConfig(grid=pt.GridParams(**TINY_GRID), dtype="float32",
                          inpdir=str(tmp_path), mechdir=str(tmp_path),
                          **dict(BTZ96, chem=True, nkc_l=0))
    model = pt.Model(cfg, device="cpu")
    state = model.minute_step(model.init_state(2))
    for sub in ("met", "turb", "surf", "micro", "rad", "tim", "chem"):
        for name, x in vars(getattr(state, sub)).items():
            if x.is_floating_point():
                assert x.dtype == torch.float32, f"{sub}.{name}"
                assert torch.isfinite(x).all(), f"{sub}.{name}"
            else:
                assert x.dtype == torch.int32, f"{sub}.{name}"
    assert (state.tim.time.numpy() == 60.0).all()
    assert state.chem.sgas.shape == (2, N_GAS + 7, cfg.grid.n)
    assert np.ptp(state.met.t.numpy(), axis=0).max() == 0.0
    # the two identical columns' concentrations agree to the solve's
    # tolerance (rtol 1e-3): the CPU's batched products may sum a cell's
    # terms in another order at another batch position, and the stiff
    # solve carries those float32 roundings at its own tolerance
    sgas = state.chem.sgas.numpy()
    scale = np.abs(sgas).max(axis=(0, 2))[:, None]
    assert (np.ptp(sgas, axis=0) <= 1e-3 * scale).all()


@pytest.mark.parametrize("refused", [
    dict(chem=True, nkc_l=4, nuc=True), dict(chem=True, nkc_l=0, nuc=True),
    dict(mic=False), dict(isurf=1), dict(box=True), dict(chamber=True)])
def test_model_refuses_the_unported_configurations(tmp_path, refused):
    """The configurations the port refused until its modes slice, nucleation
    (with the multiphase or the gas-phase driver), mic=F, the soil surface,
    box and chamber modes, are refused no more: each builds, and its
    ``init_state`` installs the drivers that JAX's would (the whole minutes
    of each are held against JAX in test_torch_modes_slice.py,
    test_torch_nucleation.py, test_torch_boxmodel.py and
    test_torch_chamber.py)."""
    write_synthetic_clarke_table(tmp_path)
    write_synthetic_radiation_tables(tmp_path)
    write_synthetic_photolysis_tables(tmp_path)
    if refused.get("nkc_l"):
        write_synthetic_tot_mechanism(tmp_path, N_GAS_TOT, N_AQ_TOT)
    else:
        write_synthetic_gas_mechanism(tmp_path, N_GAS)
    (tmp_path / "photolys").mkdir(exist_ok=True)
    write_synthetic_chamber_dat(tmp_path / "photolys")
    cfg = pt.MistraConfig(grid=pt.GridParams(**TINY_GRID),
                          inpdir=str(tmp_path), mechdir=str(tmp_path),
                          **dict(BTZ96, **refused))
    if cfg.box or cfg.chamber:
        box = pt.BoxModel(cfg, device="cpu")
        model, state = box.model, box.init_state(1)
    else:
        model = pt.Model(cfg, device="cpu")
        state = model.init_state(1)
    assert model.cfg is cfg and model.device == torch.device("cpu")
    assert (model._nucleation is not None) == cfg.nuc
    if cfg.chem:
        driver = {0: "ChemistryDriver", 4: "MultiphaseDriver"}[cfg.nkc_l]
        assert type(model._chemistry).__name__ == driver
    else:
        assert model._chemistry is None
    assert torch.isfinite(state.met.t).all()
