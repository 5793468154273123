"""Parity of the PyTorch port's Buys13_0D polar box with the JAX
package's ``BoxModel``: box mode with every dry bin sea salt
(``lp_buys13_0d``: the Koehler fcs 0, the polar u0min) at Halley
(75.6 S) in January, when the sun never sets, with the multiphase
driver's tot solve at the box level.  The initial state, then two whole
minutes of a box at 00:00 and one at 12:00 against the jitted JAX
``minute_step``, with equal Ros3 steps in every substep.  Tiny grid,
synthetic tables and the small tot stand-in, float64."""

from __future__ import annotations

import jax.numpy as jnp
import pytest

from _torch_parity import (assert_state_close, foggy, make_box_models,
                           step_minutes, to_numpy, to_port_columns)

from mistra_tpu.model import solar_zenith
from mistra_tpu_torch import boxmodel as tbox

TOL = 1e-10
# the buys13_0d benchmark configuration's settings (halo, no iodine, the
# sea-salt branch of iaertyp=3), the box level at its default nlevbox=2
BUYS = dict(box=True, lp_buys13_0d=True, halo=True, iod=False, iaertyp=3,
            alat=-75.6, nday=15, nmonth=1)


@pytest.fixture(scope="module")
def buys(tmp_path_factory):
    return make_box_models(tmp_path_factory.mktemp("inp"),
                           tmp_path_factory.mktemp("mech"), multiphase=True,
                           **BUYS)


def test_buys_init_state_matches_jax(buys):
    jbm, tbm, jbs = buys
    assert (tbm.nz_box, tbm.z_box) == (jbm.nz_box, jbm.z_box)
    ts = tbm.init_state(2)
    assert_state_close(to_numpy(jbs), ts, TOL)
    # the polar summer: the sun is up at local midnight
    assert (ts.rad.u0 > tbm.model._chemistry.u0min).all()
    assert tbm.model._chemistry.u0min == 1.75e-2


def test_two_buys_minutes_match_jax(buys):
    """Two minutes of two polar boxes (00:00 and 12:00, both sunlit):
    every field against the jitted JAX minute to 1e-6 of its scale, the
    Ros3 steps of every substep's tot solve equal, and the second
    minute's J-rates recomputed at the box level in both boxes."""
    jbm, tbm, jbs = buys
    tbm.init_state(1)
    nf = jbm.cfg.grid.nf
    a = foggy(jbs, nf, seed=11)
    b = foggy(jbs, nf, seed=12)
    m = jbm.model
    tim = b.tim.replace(lst=jnp.int32(12))
    u0 = solar_zenith(tim.lst, tim.lmin, m.astro.alat, m.astro.declin)
    b = b.replace(tim=tim, rad=b.rad.replace(u0=u0))
    states = [a, b]
    ts = to_port_columns(states)
    jd, td = jbm.model._chemistry, tbm.model._chemistry
    ts = step_minutes(jbm, tbm, states, ts, jd.tot_kernel, td.tot_kernel)
    assert (ts.chem.photol_j[:, :, tbox.N_BL] > 0.0).any(dim=1).all()
