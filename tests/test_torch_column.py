"""Parity of the PyTorch port's column modules with the JAX package: grids,
initial state, Clarke functions and surf0, turbulence closure, Thomas
sweeps and vertical diffusion.  Tiny grid, float64, same inputs."""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (B, TINY_GRID, assert_close,
                           assert_equal_int, assert_state_close,
                           assert_substate_close, column, foggy, make_models,
                           to_numpy, to_port, to_port_columns)

from mistra_tpu import config as jconfig
from mistra_tpu import grids as jgrids
from mistra_tpu.physics import diffusion as jdiff
from mistra_tpu.physics import surface as jsurf
from mistra_tpu.physics import turbulence as jturb
from mistra_tpu.utils import tridiag as jtri
import mistra_tpu_torch as pt
from mistra_tpu_torch import config as tconfig
from mistra_tpu_torch import grids as tgrids
from mistra_tpu_torch.physics import diffusion as tdiff
from mistra_tpu_torch.physics import surface as tsurf
from mistra_tpu_torch.physics import turbulence as tturb
from mistra_tpu_torch.utils import tridiag as ttri

# float64, the same formulas on the same inputs: XLA and torch differ only
# in summation order and in the last bits of exp/log/pow, which stay far
# below 1e-10 of each field's scale through one module; a wrong term or
# index would show at 1e-3 or more
TOL = 1e-10


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    return make_models(tmp_path_factory.mktemp("inp"))


@pytest.fixture(scope="module")
def two_columns(models):
    """Two different foggy columns: the JAX states and the port batch."""
    jm, tm, js = models
    states = [foggy(js, jm.cfg.grid.nf, seed=s) for s in (1, 2)]
    return states, to_port_columns(states)


@pytest.mark.parametrize("grid", [TINY_GRID, {}], ids=["tiny", "production"])
def test_make_grids_bitwise(grid):
    jg = jgrids.make_grids(jconfig.MistraConfig(
        grid=jconfig.GridParams(**grid), inpdir="."))
    tg = tgrids.make_grids(tconfig.MistraConfig(
        grid=tconfig.GridParams(**grid), inpdir="."))
    for part in ("atm", "soil", "micro"):
        a, b = getattr(jg, part), getattr(tg, part)
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if isinstance(x, np.ndarray):
                assert x.dtype == y.dtype and np.array_equal(x, y), f.name
            else:
                assert x == y, f.name


def test_init_state_matches_jax(models):
    jm, tm, js = models
    ts = tm.init_state(B)
    assert ts.met.t.shape == (B, jm.cfg.grid.n)
    assert ts.micro.ff.dtype == torch.float64
    assert_state_close(to_numpy(js), ts, TOL)
    assert tm.consts["a0m"] == jm.consts["a0m"]
    assert np.array_equal(tm.consts["b0m"], jm.consts["b0m"])
    assert np.array_equal(tm.consts["nar"], jm.consts["nar"])


def test_state_numpy_round_trip(models):
    """state_from_numpy repeats a per-column JAX state over B columns, and
    state_to_numpy gives it back as [B, ...] arrays, values and integer
    dtypes kept."""
    _, _, js = models
    want = to_numpy(js)
    back = pt.state_to_numpy(pt.state_from_numpy(want, B))
    for sub in ("met", "turb", "surf", "micro", "rad", "tim"):
        for name in getattr(back, sub).__dataclass_fields__:
            w = np.asarray(getattr(getattr(want, sub), name))
            g = getattr(getattr(back, sub), name)
            assert g.shape == (B,) + w.shape, f"{sub}.{name}"
            assert np.array_equal(g, np.broadcast_to(w, g.shape)), \
                f"{sub}.{name}"
            if not np.issubdtype(w.dtype, np.floating):
                assert g.dtype == np.int32, f"{sub}.{name}"


def test_claf_matches_jax(models):
    jm, tm, _ = models
    rng = np.random.default_rng(0)
    # both stability branches, beyond both table ends, and zpdz0 below
    # the first roughness node (nz == 0 branch)
    zpdl = rng.uniform(-8.0, 5.0, 200)
    zpdz0 = rng.uniform(0.2, 20.0, 200)
    want = jsurf.claf(jm.clarke, jnp.asarray(zpdl), jnp.asarray(zpdz0))
    got = tsurf.claf(tm.clarke, torch.tensor(zpdl), torch.tensor(zpdz0))
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL)


def test_surf0_matches_jax(models, two_columns):
    jm, tm, _ = models
    states, ts = two_columns
    met, surf = tsurf.surf0(tm.clarke_dev, ts.met, ts.surf, tm.atm.eta, 10.0)
    for c, js in enumerate(states):
        jmet, jsrf = jsurf.surf0(jm.clarke, js.met, js.surf, jm.atm.eta,
                                 10.0)
        for name in ("t", "xm1"):
            assert_close(getattr(jmet, name), column(getattr(met, name), c),
                         TOL, name)
        for name in ("ustern", "z0", "gclu", "gclt"):
            assert_close(getattr(jsrf, name), column(getattr(surf, name), c),
                         TOL, name)


def test_atk0_matches_jax(models):
    jm, tm, js = models
    ts = to_port(js)
    cfg = jm.cfg
    want = jturb.atk0(js.met, js.turb, js.surf, jm.atm, cfg.ug, cfg.vg,
                      cfg.z0)
    got = tturb.atk0(ts.met, ts.turb, ts.surf, tm.atm, cfg.ug, cfg.vg,
                     cfg.z0)
    assert_substate_close(want, got, TOL, "turb")


def test_atk1_cloud_free_and_cloudy_columns(models, two_columns):
    """Column 0 takes the cloud-free branch, column 1 the cloudy one."""
    jm, tm, _ = models
    states, _ = two_columns
    states = [states[0],
              states[1].replace(micro=states[1].micro.replace(
                  lcl=jnp.int32(2), lct=jnp.int32(8)))]
    ts = to_port_columns(states)
    met, turb, kinv = tturb.atk1(ts.met, ts.turb, ts.surf, ts.micro, tm.atm)
    for c, js in enumerate(states):
        jmet, jturb_, jkinv = jturb.atk1(js.met, js.turb, js.surf, js.micro,
                                         jm.atm, None)
        for name in ("buoy", "thetl", "tkep"):
            assert_close(getattr(jmet, name), column(getattr(met, name), c),
                         TOL, name)
        for name in jturb_.__dataclass_fields__:
            assert_close(getattr(jturb_, name),
                         column(getattr(turb, name), c), TOL, name)
        assert_equal_int(jkinv, column(kinv, c), "kinv")


@pytest.mark.parametrize("with_rhs", [False, True])
def test_implicit_sweep_and_subsidence_match_jax(with_rhs):
    rng = np.random.default_rng(3)
    n, F, cols = 40, 5, 3
    atk = rng.uniform(0.5, 5.0, (cols, n))
    detw = rng.uniform(5.0, 20.0, n)
    deta = rng.uniform(5.0, 20.0, n)
    f = rng.uniform(280.0, 300.0, (cols, n, F))
    rhs = f + rng.normal(0.0, 1.0, f.shape) if with_rhs else None
    bottom = rng.uniform(280.0, 300.0, (cols, F))
    c = rng.uniform(-0.3, 0.0, (cols, n))
    t = torch.tensor
    xa, xc = ttri.diffusion_coefficients(t(atk), t(detw), t(deta), 10.0)
    got = ttri.implicit_sweep(xa, xc, t(f),
                              rhs=None if rhs is None else t(rhs),
                              bottom=t(bottom))
    got_s = ttri.subsidence(t(f), t(c))
    for k in range(cols):
        jxa, jxc = jtri.diffusion_coefficients(
            jnp.asarray(atk[k]), jnp.asarray(detw), jnp.asarray(deta), 10.0)
        want = jtri.implicit_sweep(
            jxa, jxc, jnp.asarray(f[k]),
            rhs=None if rhs is None else jnp.asarray(rhs[k]),
            bottom=jnp.asarray(bottom[k]))
        assert_close(want, got[k:k + 1], TOL, "sweep")
        assert_close(jtri.subsidence(jnp.asarray(f[k]), jnp.asarray(c[k])),
                     got_s[k:k + 1], TOL, "subsidence")


def test_difm_matches_jax(models, two_columns):
    jm, tm, _ = models
    states, ts = two_columns
    cfg = jm.cfg
    met, turb, kinv = tdiff.difm(ts.met, ts.turb, ts.surf, ts.micro, tm.atm,
                                 10.0, cfg.ug, cfg.vg)
    for c, js in enumerate(states):
        jmet, jturb_, jkinv = jdiff.difm(js.met, js.turb, js.surf, js.micro,
                                         jm.atm, 10.0, cfg.ug, cfg.vg)
        for name in jmet.__dataclass_fields__:
            assert_close(getattr(jmet, name), column(getattr(met, name), c),
                         TOL, name)
        for name in jturb_.__dataclass_fields__:
            assert_close(getattr(jturb_, name),
                         column(getattr(turb, name), c), TOL, name)
        assert_equal_int(jkinv, column(kinv, c), "kinv")


def test_difp_matches_jax(models, two_columns):
    jm, tm, _ = models
    states, ts = two_columns
    micro = tdiff.difp(ts.micro, ts.met, ts.turb, tm.atm, 10.0)
    for c, js in enumerate(states):
        jmic = jdiff.difp(js.micro, js.met, js.turb, jm.atm, 10.0)
        assert_close(jmic.ff, column(micro.ff, c), TOL, "ff")
        assert_close(jmic.fsum, column(micro.fsum, c), TOL, "fsum")

