"""Parity of the PyTorch port's Pitzer activities
(``chemistry/activity.py``: calpar, pitzer, xgamma_field) with the JAX
package's.  float64, inputs drawn with numpy from a seed: temperatures of
the marine boundary layer, molalities from 0 to tens of mol/kg (ionic
strengths beyond the model's validity bound of 80), bins without liquid
(cm = 0)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close

from mistra_tpu.chemistry import activity as jact
from mistra_tpu_torch.chemistry import activity as tact

# float64, the same formulas on the same inputs: the two differ in the
# last bits of exp/log/pow
TOL = 1e-10


def tt(x):
    return torch.tensor(np.asarray(x))


def test_calpar_matches_jax():
    tk = np.random.default_rng(0).uniform(250.0, 310.0, (3, 7))
    got = tact.calpar(tt(tk))
    want = jact.calpar(jnp.asarray(tk))
    for name, w, g in zip(("b0", "b1", "c0", "c1", "omega", "xs"), want,
                          got):
        assert g.shape == w.shape
        assert_close(w, g[None], TOL, name)


def test_pitzer_matches_jax():
    """Activity coefficients of the 3 cations and 4 anions and the water
    activity, over molalities from 0 (single salts, pure water) to an
    ionic strength of several hundred."""
    rng = np.random.default_rng(1)
    shape = (5, 40)
    tk = rng.uniform(260.0, 300.0, shape)
    mc = 10.0 ** rng.uniform(-4.0, 2.0, (3,) + shape)
    ma = 10.0 ** rng.uniform(-4.0, 2.0, (4,) + shape)
    mc[rng.random(mc.shape) < 0.25] = 0.0
    ma[rng.random(ma.shape) < 0.25] = 0.0
    mc[:, 0, 0] = ma[:, 0, 0] = 0.0              # pure water
    ionic = 0.5 * (mc.sum(0) + (ma * np.array([1, 4, 1, 1])[:, None, None]
                                ).sum(0))
    assert ionic.max() > 80.0 and (ionic < 1.0).any()
    got = tact.pitzer(tt(tk), tt(mc), tt(ma))
    want = jact.pitzer(jnp.asarray(tk), jnp.asarray(mc), jnp.asarray(ma))
    for name, w, g in zip(("gam_c", "gam_a", "wact"), want, got):
        w = np.asarray(w)
        finite = np.isfinite(w)
        assert np.array_equal(finite, torch.isfinite(g).numpy()), name
        assert_close(np.where(finite, w, 0.0),
                     torch.where(torch.isfinite(g), g, 0.0)[None], TOL,
                     name)


@pytest.mark.parametrize("nkc", [4, 2])
def test_xgamma_field_matches_jax(nkc):
    """The sion1-numbered plane with its aliases, the water activity, and
    the masks: cm = 0 cells, ionic strength above 80 and the levels
    outside 1..nf-1 keep gamma = 1."""
    rng = np.random.default_rng(2 + nkc)
    Bc, n, nf = 2, 12, 9
    names = ("Hp", "NH4p", "HSO4m", "SO42m", "NO3m", "Clm")
    n2i = {f"{s}l{b}": i * nkc + b - 1 for i, s in enumerate(names)
           for b in range(1, nkc + 1)}
    te = rng.uniform(270.0, 295.0, (Bc, n))
    conc = 1e-5 * rng.random((Bc, len(n2i) + 3, n))
    cm = 10.0 ** rng.uniform(-11.0, -6.0, (Bc, 4, n))
    cm[rng.random(cm.shape) < 0.3] = 0.0
    cw = cm * rng.uniform(0.5, 2.0, cm.shape)
    xg, wact = tact.xgamma_field(tt(te), tt(conc), tt(cm), tt(cw), n2i, nf)
    assert xg.shape == (Bc, tact.NGAM, 4, n)
    for c in range(Bc):
        jxg, jw = jact.xgamma_field(jnp.asarray(te[c]), jnp.asarray(conc[c]),
                                    jnp.asarray(cm[c]), jnp.asarray(cw[c]),
                                    n2i, nkc, nf, jnp.float64)
        assert_close(jxg, xg[c:c + 1], TOL, f"xgamma[{c}]")
        assert_close(jw, wact[c:c + 1], TOL, f"wact[{c}]")
    # the masks: every slot 1 where cm = 0, outside 1..nf-1, or where the
    # ionic strength passes 80; filled where valid
    fixed = (cm == 0.0) | (np.arange(n) < 1) | (np.arange(n) >= nf)
    for c in range(Bc):
        assert (xg[c][:, torch.tensor(fixed[c])] == 1.0).all()
    ions = conc[:, [n2i[f"{s}l1"] for s in names]] * 1e-3 \
        / np.maximum(cm[:, None, 0], 1e-30)
    strong = (ions.sum(1) > 160.0) & (cm[:, 0] > 0.0) \
        & (np.arange(n) >= 1) & (np.arange(n) < nf)
    assert strong.any() and (xg[:, 0, 0][torch.tensor(strong)] == 1.0).all()
    valid = ~fixed & (xg.numpy()[:, 0] != 1.0)
    assert valid.any()
    # aliases: gamma(Br-) is gamma(Cl-), slot 5 is slot 19
    assert torch.equal(xg[:, 23], xg[:, 13]) and torch.equal(xg[:, 4],
                                                             xg[:, 18])


def test_xgamma_near_the_validity_bound_matches_jax():
    """Just under the ionic-strength bound of 80 the Pitzer coefficients
    are extreme: a sea-salt bin with little water (Cl- ~65, SO4-- ~3.3
    mol/kg, Na+ from the charge balance) has gamma(SO4--) ~1e56.  Each
    entry matches JAX's within TOL of itself, and levels on either side
    of the bound are masked alike."""
    rng = np.random.default_rng(9)
    n = nf = 12
    names = ("Hp", "NH4p", "HSO4m", "SO42m", "NO3m", "Clm")
    n2i = {f"{s}l{b}": i * 4 + b - 1 for i, s in enumerate(names)
           for b in range(1, 5)}
    te = rng.uniform(275.0, 285.0, (1, n))
    cm = np.full((1, 4, n), 6.55e-12)
    cw = 3.0 * cm
    # molality x cm x 1e3 = mol/m3; ionic strength 74.85 x scale
    scale = np.linspace(0.9, 1.2, n)
    conc = np.zeros((1, len(n2i), n))
    for s, m in (("SO42m", 3.33), ("NO3m", 6.86e-6), ("Clm", 64.9)):
        for b in range(1, 5):
            conc[0, n2i[f"{s}l{b}"]] = m * scale * cm[0, b - 1] * 1e3
    xg, _ = tact.xgamma_field(tt(te), tt(conc), tt(cm), tt(cw), n2i, nf)
    jxg, _ = jact.xgamma_field(jnp.asarray(te[0]), jnp.asarray(conc[0]),
                               jnp.asarray(cm[0]), jnp.asarray(cw[0]), n2i,
                               4, nf, jnp.float64)
    want, got = np.asarray(jxg), xg[0].numpy()
    assert (np.abs(got - want) <= TOL * np.abs(want)).all()
    ionic = 74.85 * scale
    assert want[7, 1][(ionic < 80.0) & (np.arange(n) >= 1)].min() > 1e40
    assert (got[:, :, ionic > 80.0] == 1.0).all()
