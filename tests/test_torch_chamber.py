"""Parity of the PyTorch port's chamber mode (``boxmodel.py`` with
chamber=True) with the JAX package's ``BoxModel``: the initial state
(chamber.dat's temperature and humidity, read from <inpdir>/photolys by
default; the clock at 12:00, the declination of 18 degrees), the J
schedule (dark before 15 min and from 2 h on, chamber.dat's measured
J-rates in between), and two whole chamber minutes across the lights'
edges against the jitted JAX ``minute_step``, with equal Ros3 steps in
every substep.  The Buxmann15_alpha settings (mic=F, the gas-phase
driver, halo, no iodine) on the tiny grid, the synthetic tables, gas
stand-in and chamber.dat, float64; two chambers in one batch."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import pytest
import torch

from _torch_parity import (assert_rows_close, assert_state_close,
                           make_box_models, step_minutes, to_numpy,
                           to_port_columns)

from mistra_tpu import boxmodel as jbox
from mistra_tpu_torch import boxmodel as tbox

TOL = 1e-10
# the Buxmann15_alpha chamber settings of tests/test_buxmann.py:65-71 on
# the stand-ins (mic=F, nkc_l=0, halo, no iodine)
CHAMBER = dict(chamber=True, mic=False, nkc_l=0, halo=True, iod=False,
               z_box=50.0, lp_buxmann15alph=True)


@pytest.fixture(scope="module")
def chamber(tmp_path_factory):
    return make_box_models(tmp_path_factory.mktemp("inp"),
                           tmp_path_factory.mktemp("mech"), **CHAMBER)


def test_chamber_init_state_matches_jax(chamber):
    jbm, tbm, jbs = chamber
    ts = tbm.init_state(2)
    assert_state_close(to_numpy(jbs), ts, TOL)
    assert tbm.chamber_dat == jbm.chamber_dat
    assert (ts.met.t[:, tbox.N_BL] == 288.23).all()
    assert (ts.tim.lst == 12).all() and tbm.model.astro.declin == 18.0


def test_chamber_j_schedule_matches_jax(chamber):
    """The chamber's J-rates: zero before 15 min and from 2 h on, the
    measured values of chamber.dat in their slots and the model's
    J-rates scaled by the jNO2 ratio in the others while the lights are
    on; the same on every level."""
    jbm, tbm, jbs = chamber
    ts = tbm.init_state(1)
    _, _, jmeas = tbm.chamber_dat
    photolysis = jax.jit(jbm._chamber_photolysis)
    for minutes in (14.0, 15.0, 60.0, 119.5, 120.0):
        s = jbs.replace(tim=jbs.tim.replace(time=jnp.float64(60.0
                                                             * minutes)))
        want = photolysis(s)
        t = ts.replace(tim=ts.tim.replace(
            time=torch.full_like(ts.tim.time, 60.0 * minutes)))
        got = tbm._chamber_photolysis(t)
        assert_rows_close(want, got, TOL, f"photol_j at {minutes} min")
        lit = 15.0 <= minutes < 120.0
        assert bool((got != 0.0).any()) == lit
        if lit:
            for slot, val in jmeas.items():
                assert (got[:, slot - 1] == val).all()


def test_two_chamber_minutes_match_jax(chamber):
    """Two chamber minutes (mic=F, the gas-phase driver over the whole
    column) of two chambers, one turning its lights on (13 -> 15 min) and
    one off (119 -> 121 min): every field against the jitted JAX minute,
    and the Ros3 steps of every substep equal."""
    jbm, tbm, jbs = chamber
    tbm.init_state(1)
    states = [jbs.replace(tim=jbs.tim.replace(time=jnp.float64(60.0 * m)))
              for m in (13.0, 119.0)]
    ts = to_port_columns(states)
    jd, td = jbm.model._chemistry, tbm.model._chemistry
    ts = step_minutes(jbm, tbm, states, ts, jd.kernel, td.kernel)
    pj = ts.chem.photol_j
    assert (pj[0] != 0.0).any() and (pj[1] == 0.0).all()


def test_chamber_dat_and_box_top_match_jax(chamber):
    jbm, tbm, _ = chamber
    path = tbox.chamber_dat_path(tbm.cfg)
    assert jbox.read_chamber_dat(path) == tbox.read_chamber_dat(path)
    for z in (10.0, 50.0, 333.0, 700.0):
        assert jbox.get_n_box(jbm.model.grids.atm, z) \
            == tbox.get_n_box(tbm.model.grids.atm, z)
