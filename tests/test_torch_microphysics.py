"""Parity of the PyTorch port's microphysics with the JAX package: Koehler
equilibrium, condensational growth (subkon/kon), sedimentation and dry
deposition.  Tiny grid, float64, the same foggy inputs; two different
columns in one batch check the per-column loops and reductions."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (assert_close, assert_equal_int, column, foggy,
                           make_models, to_port_columns)

from mistra_tpu.physics import growth as jgrowth
from mistra_tpu.physics import microphysics as jmic
from mistra_tpu.physics import sedimentation as jsed
from mistra_tpu_torch.physics import growth as tgrowth
from mistra_tpu_torch.physics import microphysics as tmic
from mistra_tpu_torch.physics import sedimentation as tsed

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
    """A foggy column (its Newton solve takes 6 iterations) beside the
    initial one (1 iteration): the JAX states and the port batch."""
    jm, _, js = models
    states = [foggy(js, jm.cfg.grid.nf, seed=3), js]
    return states, to_port_columns(states)


def test_rgl_matches_jax():
    rng = np.random.default_rng(5)
    shape = (6, 40)
    r_dry = rng.uniform(0.005, 15.0, shape)
    a = rng.uniform(1e-4, 1e-3, shape)
    b = rng.uniform(0.0, 1.2, shape)
    feu = rng.uniform(0.5, 1.02, shape)
    want = jmic.rgl(*(jnp.asarray(x) for x in (r_dry, a, b, feu)))
    got = tmic.rgl(*(torch.tensor(x) for x in (r_dry, a, b, feu)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL)


@pytest.mark.parametrize("ncase", [0, 1, 2])
def test_equil_matches_jax(models, two_columns, ncase):
    jm, tm, _ = models
    states, ts = two_columns
    nf = jm.cfg.grid.nf
    a0m, b0m = jm.consts["a0m"], jm.consts["b0m"]
    met, micro = tmic.equil(ts.met, ts.micro, tm.micro, a0m, tm.b0m,
                            ncase=ncase, nf=nf, level=nf - 1)
    for c, js in enumerate(states):
        jmet, jmicro = jmic.equil(js.met, js.micro, jm.grids.micro, a0m,
                                  jnp.asarray(b0m), ncase=ncase, nf=nf,
                                  level=nf - 1)
        for name in ("xm2", "feu"):
            assert_close(getattr(jmet, name), column(getattr(met, name), c),
                         TOL, name)
        assert_close(jmicro.ff, column(micro.ff, c), TOL, "ff")
        assert_close(jmicro.fsum, column(micro.fsum, c), TOL, "fsum")


def test_subkon_matches_jax(models, two_columns):
    """Newton solve on all prognostic levels of two columns that converge
    in different iteration counts."""
    jm, tm, _ = models
    states, ts = two_columns
    nf = jm.cfg.grid.nf
    lo, hi = 1, nf + 1
    mg = jm.grids.micro
    a0m, b0m = jm.consts["a0m"], jnp.asarray(jm.consts["b0m"])
    qabs = np.zeros((jm.cfg.grid.mb, mg.e.shape[0], mg.rn.shape[0]))

    def args_of(met):
        return (met.dfddt[..., lo:hi], met.feu[..., lo:hi],
                met.p[..., lo:hi], met.talt[..., lo:hi], met.t[..., lo:hi],
                met.xm1a[..., lo:hi], met.xm1[..., lo:hi])

    psi, to, xm1o, done = tgrowth.subkon(
        10.0, ts.micro.ff[..., lo:hi].permute(0, 3, 1, 2),
        ts.rad.totrad.transpose(1, 2)[:, lo:hi], *args_of(ts.met),
        torch.tensor(qabs), (a0m, tm.b0m), tm.micro)
    for c, js in enumerate(states):
        jpsi, jto, jxm1o, jdone = jgrowth.subkon(
            10.0, jnp.moveaxis(js.micro.ff, 2, 0)[lo:hi],
            js.rad.totrad.T[lo:hi], *args_of(js.met), jnp.asarray(qabs),
            (a0m, b0m), mg)
        assert_close(jpsi, column(psi, c), TOL, "spectrum")
        assert_close(jto, column(to, c), TOL, "t")
        assert_close(jxm1o, column(xm1o, c), TOL, "xm1")
        assert_equal_int(jdone, column(done, c), "converged")


def test_kon_matches_jax(models, two_columns):
    jm, tm, _ = models
    states, ts = two_columns
    out = tgrowth.kon(tm, ts, 10.0)
    for c, js in enumerate(states):
        want = jgrowth.kon(jm, js, 10.0)
        for name in ("t", "talt", "xm1", "xm1a", "feu", "dfddt", "xm2"):
            assert_close(getattr(want.met, name),
                         column(getattr(out.met, name), c), TOL, name)
        assert_close(want.micro.ff, column(out.micro.ff, c), TOL, "ff")
        assert_close(want.micro.fsum, column(out.micro.fsum, c), TOL, "fsum")
        assert_equal_int(want.micro.lcl, column(out.micro.lcl, c), "lcl")
        assert_equal_int(want.micro.lct, column(out.micro.lct, c), "lct")


def test_advsed_match_jax():
    rng = np.random.default_rng(9)
    nf = 20
    y = rng.uniform(0.0, 1.0, (7, 5, nf)) * 10.0 ** rng.uniform(-3, 0,
                                                               (7, 5, nf))
    c = -rng.uniform(0.0, 0.9, (7, 5, nf))
    for jf, tf in ((jsed.advsed0, tsed.advsed0), (jsed.advsed1, tsed.advsed1)):
        want = jf(jnp.asarray(c), jnp.asarray(y))
        got = tf(torch.tensor(c), torch.tensor(y))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                                   atol=TOL * np.abs(y).max())


def test_sedp_matches_jax(models, two_columns):
    jm, tm, _ = models
    states, ts = two_columns
    out = tsed.sedp(tm, ts, 10.0)
    for c, js in enumerate(states):
        want = jsed.sedp(jm, js, 10.0)
        assert_close(want.micro.ff, column(out.micro.ff, c), TOL, "ff")
        assert_close(want.micro.fsum, column(out.micro.fsum, c), TOL, "fsum")
        for name in ("ajs", "trdep", "ds1", "ds2"):
            assert_close(getattr(want.surf, name),
                         column(getattr(out.surf, name), c), TOL, name)


def test_partdep_matches_jax(models, two_columns):
    jm, tm, _ = models
    states, ts = two_columns
    vd, ra = tsed.partdep(tm, ts)
    for c, js in enumerate(states):
        jvd, jra = jsed.partdep(jm, js)
        assert_close(jvd, column(vd, c), TOL, "vd")
        assert_close(jra, column(ra, c), TOL, "ra")
