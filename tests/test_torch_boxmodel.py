"""Parity of the PyTorch port's box mode (``boxmodel.py``) with the JAX
package's ``BoxModel``: the initial states of a box (nlevbox) and a
boundary-layer box (bl_box); the box's surface exchange and particle
deposition with the gas-phase and the multiphase driver;
``integrate_box``; and two whole minutes of each box (the multiphase
driver's tot solve at the box level; the gas-phase driver with the
boundary-layer mean J-rates) against the jitted JAX ``minute_step``,
with equal Ros3 steps in every substep.  Tiny grid, synthetic tables and
mechanisms, float64; two boxes in one batch (one at noon).  The chamber
mode is in test_torch_chamber.py."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (assert_chem_close, assert_close,
                           assert_rows_close, assert_state_close, foggy,
                           make_box_models, ros3_steps, step_minutes,
                           to_numpy, to_port_columns)

from mistra_tpu import boxmodel as jbox
from mistra_tpu.model import solar_zenith
from mistra_tpu_torch import boxmodel as tbox

# one call of a module: 1e-10 of each field's scale; whole minutes: 1e-6
# of each species' scale (test_torch_chem_slice.py)
TOL = 1e-10
TOL_MINUTES = 1e-6
BOX = dict(box=True, nlevbox=5, z_box=50.0)


@pytest.fixture(scope="module")
def box_mp(tmp_path_factory):
    """A box (nlevbox=5) with the multiphase driver: integrate_box."""
    return make_box_models(tmp_path_factory.mktemp("inp"),
                           tmp_path_factory.mktemp("mech"), multiphase=True,
                           **BOX)


@pytest.fixture(scope="module")
def box_gas(tmp_path_factory):
    """A boundary-layer box (bl_box) with the gas-phase driver."""
    return make_box_models(tmp_path_factory.mktemp("inp"),
                           tmp_path_factory.mktemp("mech"), bl_box=True,
                           **BOX)


def box_columns(jbm, jbs, seed):
    """Two different boxes: foggy particle spectra of two seeds, the
    second at noon."""
    nf = jbm.cfg.grid.nf
    a = foggy(jbs, nf, seed=seed)
    b = foggy(jbs, nf, seed=seed + 1)
    m = jbm.model
    tim = b.tim.replace(lst=jnp.int32(12))
    u0 = solar_zenith(tim.lst, tim.lmin, m.astro.alat, m.astro.declin)
    b = b.replace(tim=tim, rad=b.rad.replace(u0=u0))
    states = [a, b]
    return states, to_port_columns(states)


@pytest.mark.parametrize("which", ["box_mp", "box_gas"])
def test_init_state_matches_jax(request, which):
    """box: level nlevbox's temperature and humidity at the box level;
    bl_box: the boundary-layer means; the particles re-equilibrated there
    and the frozen deposition velocities, every field."""
    jbm, tbm, jbs = request.getfixturevalue(which)
    assert (tbm.nz_box, tbm.z_box) == (jbm.nz_box, jbm.z_box)
    ts = tbm.init_state(2)
    assert_state_close(to_numpy(jbs), ts, TOL)
    assert (ts.tim.kinv == jbm.cfg.grid.nf).all()


@pytest.mark.parametrize("which", ["box_mp", "box_gas"])
def test_sedc_box_and_partdep_match_jax(request, which):
    """Surface exchange over the box depth (with the box's deposition
    overrides and emissions) and the particle deposition, with the
    dissolved species' deposition of the multiphase driver: every field
    each touches."""
    jbm, tbm, jbs = request.getfixturevalue(which)
    tbm.init_state(1)
    states, ts = box_columns(jbm, jbs, seed=3)
    got = tbm._sedc_box(ts, 10.0)
    got_p = tbm._box_partdep(ts, 10.0)
    for c, s in enumerate(states):
        want = to_numpy(jbm._sedc_box(s, 10.0))
        assert_rows_close(want.chem.sgas, got.chem.sgas[c:c + 1], TOL,
                          f"sedc_box[{c}]")
        want = to_numpy(jbm._box_partdep(s, 10.0))
        assert_close(want.micro.ff, got_p.micro.ff[c:c + 1], TOL, "ff")
        assert_close(want.micro.fsum, got_p.micro.fsum[c:c + 1], TOL, "fsum")
        assert_rows_close(want.chem.sgas, got_p.chem.sgas[c:c + 1], TOL,
                          f"box_partdep[{c}]")
    n_bl = tbox.N_BL
    # deposition moved mass into the ground bucket (level 0)
    assert (got.chem.sgas[:, :, 0] >= ts.chem.sgas[:, :, 0]).all()
    assert (got_p.micro.ff[..., 0] > ts.micro.ff[..., 0]).any()
    if which == "box_mp":
        aq = torch.as_tensor(np.asarray(tbm.model._chemistry.tot.species_bin)
                             > 0)
        moved = got_p.chem.conc[:, aq, n_bl] < ts.chem.conc[:, aq, n_bl]
        assert moved.any(), "no dissolved species deposited"


def test_integrate_box_matches_jax(box_mp):
    """One 10-s tot solve at the box level of two boxes: concentrations,
    hysteresis flags, nonconv and the Ros3 steps of each box equal."""
    jbm, tbm, jbs = box_mp
    tbm.init_state(1)
    states, ts = box_columns(jbm, jbs, seed=5)
    jd, td = jbm.model._chemistry, tbm.model._chemistry
    with ros3_steps(td.tot_kernel) as tsteps:
        got = td.integrate_box(ts, 10.0, tbox.N_BL)
    for c, s in enumerate(states):
        with ros3_steps(jd.tot_kernel) as jsteps:
            want = jd.integrate_box(s, 10.0, jbox.N_BL)
        assert_chem_close(to_numpy(want), got.map(lambda x: x[c:c + 1]),
                          TOL_MINUTES)
        assert np.array_equal(jsteps[0], tsteps[0][c:c + 1])
    assert tsteps[0].min() > 1


def test_two_box_minutes_match_jax(box_mp):
    """Two minutes of two boxes (one at noon) with the multiphase driver:
    every field against the jitted JAX minute, and the Ros3 steps of every
    substep's tot solve equal."""
    jbm, tbm, jbs = box_mp
    tbm.init_state(1)
    states, ts = box_columns(jbm, jbs, seed=7)
    jd, td = jbm.model._chemistry, tbm.model._chemistry
    step_minutes(jbm, tbm, states, ts, jd.tot_kernel, td.tot_kernel)


def test_two_bl_box_minutes_match_jax(box_gas):
    """Two minutes of two boundary-layer boxes (one at noon) with the
    gas-phase driver over the whole column and the J-rates averaged over
    the boundary layer at the box level (ave_j): every field against the
    jitted JAX minute, the Ros3 steps of every substep equal."""
    jbm, tbm, jbs = box_gas
    tbm.init_state(1)
    states, ts = box_columns(jbm, jbs, seed=9)
    jd, td = jbm.model._chemistry, tbm.model._chemistry
    ts = step_minutes(jbm, tbm, states, ts, jd.kernel, td.kernel)
    assert tbm.nz_box > 1 and (ts.chem.photol_j[1, :, tbox.N_BL] > 0.0).any()
