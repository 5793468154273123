"""Parity of the PyTorch port's aqueous support stack
(``chemistry/aqueous.py``: cw_rc, sticking coefficients, mean speeds,
inverse Henry constants, fast_k_mt, equil_constants) with the JAX
package's, column by column.  Tiny grid, float64, inputs drawn with numpy
from a seed: spectra whose bins straddle the activity thresholds,
relative humidities across the deliquescence/crystallisation hysteresis
and random hysteresis flags."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import TINY_GRID, assert_close

from mistra_tpu.chemistry import aqueous as jaq
from mistra_tpu.config import GridParams, MistraConfig
from mistra_tpu.grids import make_grids as jax_grids
from mistra_tpu_torch import GridParams as TGridParams
from mistra_tpu_torch import MistraConfig as TMistraConfig
from mistra_tpu_torch.chemistry import aqueous as taq
from mistra_tpu_torch.grids import make_grids as port_grids
from mistra_tpu_torch.model import micro_tensors

# float64, the same formulas on the same inputs: the two differ in the
# last bits of exp/sqrt/pow and in the order of the spectrum's sums
TOL = 1e-10
B = 3
T64 = torch.float64


@pytest.fixture(scope="module")
def grids():
    """(JAX micro grid, port micro grid as tensors, masks)."""
    jg = jax_grids(MistraConfig(grid=GridParams(**TINY_GRID))).micro
    tg = micro_tensors(port_grids(TMistraConfig(
        grid=TGridParams(**TINY_GRID))).micro, T64, "cpu")
    return jg, tg, jaq.bin_masks(jg)


@pytest.fixture(scope="module")
def inputs(grids):
    """ff [B, nkt, nka, n] with each (column, level) scaled by 1e-6..1e3,
    t 270-295 K, p 0.9-1.02e5 Pa, feu 0.3-1.02, random cloud flags."""
    jg, _, masks = grids
    nkt, nka, _ = masks.shape
    n = TINY_GRID["nf"] + TINY_GRID["n_extra"]
    rng = np.random.default_rng(11)
    ff = rng.lognormal(0.0, 1.5, (B, nkt, nka, n)) \
        * 10.0 ** rng.uniform(-6.0, 3.0, (B, 1, 1, n))
    ff[rng.random(ff.shape) < 0.2] = 0.0
    return dict(ff=ff, t=rng.uniform(270.0, 295.0, (B, n)),
                p=rng.uniform(9.0e4, 1.02e5, (B, n)),
                feu=rng.uniform(0.3, 1.02, (B, n)),
                cloud=rng.random((B, 4, n)) < 0.5)


def tt(x):
    return torch.tensor(np.asarray(x))


def by_column(want_cols, got, tol, what):
    for c, w in enumerate(want_cols):
        assert_close(w, got[c:c + 1], tol, f"{what}[{c}]")


def port_cw_rc(grids, x):
    _, tg, masks = grids
    return taq.cw_rc(tt(x["ff"]), tt(x["feu"]), tt(x["cloud"]),
                     tt(masks), tg.rq, tg.e)


def test_cw_rc_matches_jax_both_hysteresis_branches(grids, inputs):
    """cw, cm, rc, conv2 and the new hysteresis flags; the inputs hit
    both branches of the aerosol bins' hysteresis: between the
    crystallisation and deliquescence humidities a bin above its LWC
    threshold stays active with its flag set and inactive without it."""
    jg, tg, masks = grids
    x = inputs
    got = port_cw_rc(grids, x)
    for c in range(B):
        want = jaq.cw_rc(jnp.asarray(x["ff"][c]), jnp.asarray(x["feu"][c]),
                         jnp.asarray(x["cloud"][c]), jg, masks, jnp.float64)
        for name, w, g in zip(("cw", "cm", "rc", "conv2"), want, got):
            assert_close(w, g[c:c + 1], TOL, f"{name}[{c}]")
        assert np.array_equal(np.asarray(want[4]), got[4][c].numpy())
    active = got[4].numpy()
    big = (got[0].numpy() * 1e12) >= np.array(
        [taq.CWM, taq.CWM, taq.CWMD, taq.CWMD])[None, :, None]
    feu = x["feu"][:, None, :]
    band = (feu >= taq.XCRYSSS) & (feu < taq.XDELISULF)
    for b in (0, 1):
        kept = big[:, b] & band[:, 0] & x["cloud"][:, b]
        lost = big[:, b] & band[:, 0] & ~x["cloud"][:, b]
        assert kept.any() and active[:, b][kept].all()
        assert lost.any() and not active[:, b][lost].any()
    assert active[:, 2:].any() and (~active[:, 2:] & big[:, 2:]).sum() == 0


@pytest.mark.parametrize("buxmann", [False, True])
def test_species_tables_match_jax(inputs, buxmann):
    """Sticking coefficients (both ICl/IBr forms), mean speeds and inverse
    Henry constants of every exchange species."""
    species = taq.EXCHANGE_SPECIES
    masses = {"HNO3": 63.0e-3, "NH3": 17.0e-3}
    t = inputs["t"]
    got = (taq.sticking_coefficients(species, tt(t), buxmann),
           taq.mean_speeds(species, masses, tt(t)),
           taq.inverse_henry(species, tt(t)))
    for c in range(B):
        tj = jnp.asarray(t[c])
        want = (jaq.sticking_coefficients(species, tj, buxmann),
                jaq.mean_speeds(species, masses, tj),
                jaq.inverse_henry(species, tj))
        for name, w, g in zip(("alpha", "vmean", "hinv"), want, got):
            for s, row in enumerate(species):
                assert_close(w[s], g[c:c + 1, s], TOL, f"{name}[{row}]")


def test_fast_k_mt_matches_jax(grids, inputs):
    """The Schwartz mass-transfer coefficients of every exchange species
    in every active bin, and the bins' fall velocities."""
    jg, tg, masks = grids
    x = inputs
    species = taq.EXCHANGE_SPECIES
    t, p = x["t"], x["p"]
    freep = 2.28e-5 * t / p
    cw, cm = port_cw_rc(grids, x)[:2]
    alpha = taq.sticking_coefficients(species, tt(t))
    vmean = taq.mean_speeds(species, {}, tt(t))
    xkmt, vt = taq.fast_k_mt(tt(x["ff"]), tt(t), tt(p), alpha, vmean, cw,
                             cm, tt(masks), tg.rq, tt(freep))
    assert xkmt.shape == (B, len(species), 4, t.shape[1])
    for c in range(B):
        jw, jv = jaq.fast_k_mt(
            jnp.asarray(x["ff"][c]), jnp.asarray(t[c]), jnp.asarray(p[c]),
            jnp.asarray(alpha[c].numpy()), jnp.asarray(vmean[c].numpy()),
            jnp.asarray(cw[c].numpy()), jnp.asarray(cm[c].numpy()), masks,
            jg, jnp.asarray(freep[c]), jnp.float64)
        for s, name in enumerate(species):
            assert_close(jw[s], xkmt[c:c + 1, s], TOL, f"xkmt[{name}][{c}]")
        assert_close(jv, vt[c:c + 1], TOL, f"vt[{c}]")
    assert (xkmt > 0.0).any() and (vt > 0.0).any()


@pytest.mark.parametrize("with_gamma", [True, False])
def test_equil_constants_match_jax(grids, inputs, with_gamma):
    """Every equilibrium's forward and backward rates, with random
    activity coefficients and without (all 1)."""
    x = inputs
    conv2 = port_cw_rc(grids, x)[3]
    rng = np.random.default_rng(12)
    xg = rng.uniform(0.3, 3.0, (B, 40) + tuple(conv2.shape[1:]))
    kef, keb = taq.equil_constants(tt(x["t"]), conv2,
                                   tt(xg) if with_gamma else None)
    assert set(kef) == set(keb) == set(taq.EQUILIBRIA)
    for c in range(B):
        jf, jb = jaq.equil_constants(
            jnp.asarray(x["t"][c]), jnp.asarray(conv2[c].numpy()),
            jnp.asarray(xg[c]) if with_gamma else None, jnp.float64)
        for key in taq.EQUILIBRIA:
            assert_close(jf[key], kef[key][c:c + 1], TOL, f"kef[{key}]")
            assert_close(jb[key], keb[key][c:c + 1], TOL, f"keb[{key}]")
    assert (kef["HNO3"] > 0.0).any() and (kef["HNO3"] == 0.0).any()
