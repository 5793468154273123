"""The whole BTZ96 column minute step of the PyTorch port (mic=T, chem=F,
radiation off, and on with the synthetic PIFM2 tables) against the JAX
package's ``minute_step``, tiny grid."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (B, BTZ96, TINY_GRID, assert_state_close,
                           assert_substate_close, foggy, make_models,
                           to_numpy, to_port, to_port_columns)

import mistra_tpu_torch as pt
from mistra_tpu.model import solar_zenith
from mistra_tpu_torch.physics.surface import write_synthetic_clarke_table
from mistra_tpu_torch.radiation.tables import (
    MIE_FILES, PIFM2_FILE, write_synthetic_radiation_tables)

# float64.  Each module matches its JAX counterpart to 1e-10 (see the
# module tests); over whole minutes the one place where last-bit
# differences can grow is subkon's Newton exit test |res| < 1e-6: a level
# whose residual lands within rounding of 1e-6 stops one iteration earlier
# or later in one package, moving its mean saturation by up to ~1e-6 and
# the fields that follow from it by as much relative to their scale
TOL = 1e-6


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    return make_models(tmp_path_factory.mktemp("inp"))


@pytest.fixture(scope="module")
def jax_step(models):
    return jax.jit(models[0].minute_step)


def test_two_minutes_match_jax(models, jax_step):
    jm, tm, js = models
    ts = tm.init_state(B)
    for minute in range(2):
        js = jax_step(js)
        ts = tm.minute_step(ts)
        assert_state_close(to_numpy(js), ts, TOL)
    assert (ts.tim.time.numpy() == 120.0).all()
    assert (ts.tim.lmin.numpy() == 2).all()


def test_distinct_columns_match_jax(models, jax_step):
    """A foggy column and the initial one stepped in one batch: each
    matches its own JAX minute."""
    jm, tm, js = models
    states = [foggy(js, jm.cfg.grid.nf, seed=6), js]
    ts = tm.minute_step(to_port_columns(states))
    for c, s in enumerate(states):
        want = to_numpy(jax_step(s))
        got = ts.map(lambda x: x[c:c + 1])
        for sub in ("met", "turb", "surf", "micro", "tim"):
            assert_substate_close(getattr(want, sub), getattr(got, sub), TOL,
                                  sub)


def test_clock_rolls_over_like_jax(models):
    jm, tm, js = models
    tim = js.tim.replace(lmin=jnp.int32(59), lst=jnp.int32(23),
                         lday=jnp.int32(4))
    js = js.replace(tim=tim)
    want = jm.pre_minute(js)
    got = tm.pre_minute(to_port(js))
    assert_substate_close(to_numpy(want).tim, got.tim, 0.0, "tim")
    assert int(got.tim.lday[0]) == 5 and int(got.tim.lst[0]) == 0


def test_float32_minute_stays_float32(tmp_path):
    """The float32 configuration of the entry point: no float64 leaks into
    the state, every field stays finite, the clock advances exactly."""
    write_synthetic_clarke_table(tmp_path)
    write_synthetic_radiation_tables(tmp_path)
    cfg = pt.MistraConfig(grid=pt.GridParams(**TINY_GRID), dtype="float32",
                          inpdir=str(tmp_path), **BTZ96)
    model = pt.Model(cfg, device="cpu")
    assert model.radiation_enabled
    state = model.minute_step(model.init_state(3))
    for sub in ("met", "turb", "surf", "micro", "rad", "tim"):
        for name, x in vars(getattr(state, sub)).items():
            if x.is_floating_point():
                assert x.dtype == torch.float32, f"{sub}.{name}"
                assert torch.isfinite(x).all(), f"{sub}.{name}"
            else:
                assert x.dtype == torch.int32, f"{sub}.{name}"
    assert (state.tim.time.numpy() == 60.0).all()
    assert np.ptp(state.met.t.numpy(), axis=0).max() == 0.0


# --------------------------------------------------------------------------
# radiation on, as the entry point runs the minute step
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def rad_models(tmp_path_factory):
    return make_models(tmp_path_factory.mktemp("inp_rad"), radiation=True)


def at_noon(jm, js):
    """js with the clock at 12:00 local solar time and its solar zenith
    angle."""
    tim = js.tim.replace(lst=jnp.int32(12))
    u0 = solar_zenith(tim.lst, tim.lmin, jm.astro.alat, jm.astro.declin)
    return js.replace(tim=tim, rad=js.rad.replace(u0=u0))


def test_two_minutes_with_radiation_match_jax(rad_models):
    """The port's init (its radiation call included) matches JAX's; then a
    noon column and a midnight column, stepped in one batch, each match
    their own two JAX minutes."""
    jm, tm, js = rad_models
    assert_state_close(to_numpy(js), tm.init_state(B), TOL)
    step = jax.jit(jm.minute_step)
    states = [at_noon(jm, js), js]
    ts = to_port_columns(states)
    for minute in range(2):
        states = [step(s) for s in states]
        ts = tm.minute_step(ts)
        for c, s in enumerate(states):
            assert_state_close(to_numpy(s), ts.map(lambda x: x[c:c + 1]),
                               TOL)
    # the noon column absorbs sunlight at the surface, the midnight one none
    assert ts.rad.sk[0] > 0.0 and ts.rad.sk[1] == 0.0
    assert (ts.rad.dtrad[0] != ts.rad.dtrad[1]).any()


@pytest.mark.parametrize("missing", [PIFM2_FILE, MIE_FILES[-1]])
def test_init_state_raises_without_radiation_tables(tmp_path, missing):
    """With radiation enabled, a missing table raises; it never switches
    radiation off."""
    write_synthetic_clarke_table(tmp_path)
    write_synthetic_radiation_tables(tmp_path)
    (tmp_path / missing).unlink()
    cfg = pt.MistraConfig(grid=pt.GridParams(**TINY_GRID),
                          inpdir=str(tmp_path), **BTZ96)
    model = pt.Model(cfg, device="cpu")
    with pytest.raises(FileNotFoundError, match=missing):
        model.init_state(1)
    assert model.radiation_enabled
