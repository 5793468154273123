"""Parity of the PyTorch port's bare-soil surface (isurf=1) with the JAX
package: ``soil`` (implicit heat and moisture diffusion in the soil) and
``surf1`` (the surface energy and moisture balance, a 20-step Newton
iteration) on seeded day, night, frost and dew columns in one batch.
Tiny grid, float64, the same inputs."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (assert_substate_close, make_models, to_jax,
                           to_numpy, to_port_columns)

from mistra_tpu.physics import surface as jsurf
from mistra_tpu_torch.physics import surface as tsurf

# float64, the same formulas on the same inputs: one call of each
# function keeps the two packages within the last bits of exp/log/pow,
# far below 1e-10 of each field's scale
TOL = 1e-10

# (surface temperature [K], soil temperature [K], top soil moisture,
# solar and thermal net radiation [W/m2], dew [kg/m2], rime [kg/m2])
COLUMNS = {
    "day": (291.0, 287.0, 0.21, 520.0, -85.0, 0.0, 0.0),
    "night": (281.5, 285.0, 0.18, 0.0, -70.0, 0.0, 0.0),
    "frost": (268.5, 271.0, 0.30, 0.0, -60.0, 0.0, 0.05),
    "dew": (283.0, 284.0, 0.435, 0.0, -40.0, 1.0, 0.0),
}


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    return make_models(tmp_path_factory.mktemp("inp"), isurf=1)


def soil_column(js, spec, seed):
    """js with a seeded soil profile and the surface values of spec."""
    ts0, tb0, eb0, sk, sl, tau, reif = spec
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.array, js)
    surf, met, rad = tree.surf, tree.met, tree.rad
    nb = surf.tb.shape[0]
    depth = np.linspace(0.0, 1.0, nb)
    tb = tb0 + (ts0 - tb0) * np.exp(-5.0 * depth) \
        + rng.uniform(-0.3, 0.3, nb)
    eb = np.clip(eb0 + 0.04 * depth + rng.uniform(-0.01, 0.01, nb),
                 0.05, jsurf.EBS)
    eb[0] = eb0
    tb[0] = ts0
    t = met.t.copy()
    t[0] = ts0
    t[1] = ts0 + rng.uniform(-1.0, 1.0)
    surf = surf.replace(tb=tb, eb=eb, tau=np.float64(tau),
                        reif=np.float64(reif),
                        ajm=np.float64(rng.uniform(-1e-5, 1e-5)),
                        ajs=np.float64(0.0))
    met = met.replace(t=t, theta=met.theta + (t - met.t))
    rad = rad.replace(sk=np.float64(sk), sl=np.float64(sl))
    return to_jax(tree.replace(surf=surf, met=met, rad=rad))


@pytest.fixture(scope="module")
def columns(models):
    jm, tm, js = models
    states = [soil_column(js, spec, seed)
              for seed, spec in enumerate(COLUMNS.values())]
    return states, to_port_columns(states)


def assert_columns_close(wants, got, tol, what):
    """Column c of the port's batch got matches the JAX sub-state
    wants[c], every field."""
    for c, want in enumerate(wants):
        assert_substate_close(to_numpy(want),
                              got.map(lambda x: x[c:c + 1]), tol,
                              f"{what}[{list(COLUMNS)[c]}]")


@pytest.mark.parametrize("dt", [10.0, 60.0])
def test_soil_matches_jax(models, columns, dt):
    """Heat and moisture sweeps of four different soil columns: tb, eb."""
    jm, tm, _ = models
    states, ts = columns
    wants = [jsurf.soil(s.surf, jm.grids.soil, dt) for s in states]
    got = tsurf.soil(ts.surf, tm.grids.soil, dt)
    assert_columns_close(wants, got, TOL, "soil")
    # the moisture sweep moved the profile
    assert not torch.equal(got.eb, ts.surf.eb)


def test_surf1_matches_jax(models, columns):
    """The surface balance after soil, as the model's substep orders
    them: every met and surface field of each column, Newton iterate,
    fluxes and the dew/rime reservoirs included."""
    jm, tm, _ = models
    states, ts = columns
    wants_met, wants_surf = [], []
    for s in states:
        surf = jsurf.soil(s.surf, jm.grids.soil, 10.0)
        met, surf = jsurf.surf1(jm.clarke, s.met, surf, s.rad, jm.atm,
                                jm.grids.soil, 10.0)
        wants_met.append(met)
        wants_surf.append(surf)
    surf = tsurf.soil(ts.surf, tm.grids.soil, 10.0)
    met, surf = tsurf.surf1(tm.clarke_dev, ts.met, surf, ts.rad, tm.atm,
                            tm.grids.soil, 10.0)
    assert_columns_close(wants_met, met, TOL, "met")
    assert_columns_close(wants_surf, surf, TOL, "surf")
    # the columns took different branches: a warm sunny surface, a
    # cooling one, the ice branch of the frost column; the dew column
    # starts saturated (its first fluxes take the dew branch)
    ts_new = met.t[:, 0]
    assert ts_new[0] > ts_new[1] and ts_new[2] < tsurf.T0C
    assert float(ts.surf.eb[3, 0]) == tsurf.EBS
    assert torch.isfinite(surf.ajl).all() and torch.isfinite(surf.ajd).all()


def test_p31_matches_jax():
    t = np.linspace(220.0, 273.16, 17)
    want = np.asarray(jsurf.p31(jnp.asarray(t)))
    got = tsurf.p31(torch.as_tensor(t)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-13)
