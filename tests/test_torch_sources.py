"""Parity of the PyTorch port's aerosol sources (``chemistry/sources.py``:
the ion loading table in every branch, the initial ion loading and the
sea-salt source with the Monahan and the Smith source functions) with the
JAX package's.  Tiny grid, float64, inputs drawn with numpy from a seed."""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (assert_close, assert_rows_close, foggy,
                           make_models, to_port_columns)

from mistra_tpu.chemistry import sources as jsrc
from mistra_tpu.config import GridParams, MistraConfig
from mistra_tpu.grids import make_grids as jax_grids
from mistra_tpu.init import koehler_coefficients as jax_koehler
from mistra_tpu_torch import GridParams as TGridParams
from mistra_tpu_torch import MistraConfig as TMistraConfig
from mistra_tpu_torch.chemistry import sources as tsrc
from mistra_tpu_torch.grids import make_grids as port_grids
from mistra_tpu_torch.init import koehler_coefficients as port_koehler

# float64, the same formulas on the same inputs
TOL = 1e-10
GRID = dict(nf=12, n_extra=6, nka=24, nkt=24, nb=8)
BRANCHES = {
    "sea salt + sulfate": dict(iaertyp=3),
    "sea salt, no iodine": dict(iaertyp=3, iod=False),
    "Buxmann15 chamber salt": dict(iaertyp=3, lp_buxmann15alph=True),
    "Buys13 polar": dict(iaertyp=3, lp_buys13_0d=True),
    "Joyce14 urban": dict(iaertyp=1, lp_joyce14bc=True),
    "urban, no loading": dict(iaertyp=1),
}


def tables(kw):
    """The ion loading table of both packages for the configuration kw,
    from its Koehler molar masses and a soluble fraction of 1 (the polar
    case's own fraction is 0, which would load nothing)."""
    jc = MistraConfig(grid=GridParams(**GRID), zinv=100.0, **kw)
    tc = TMistraConfig(grid=TGridParams(**GRID), zinv=100.0, **kw)
    jg, tg = jax_grids(jc), port_grids(tc)
    jx = jax_koehler(jc, jg.micro.rn)[3]
    tx = port_koehler(tc, tg.micro.rn)[3]
    ones = np.ones_like(jx)
    return (jsrc.ion_loading_table(jc, jg, ones, jx),
            tsrc.ion_loading_table(tc, tg, ones, tx))


@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_ion_loading_table_matches_jax(branch):
    """Every branch of sa1: the same numbers, bin for bin."""
    want, got = tables(BRANCHES[branch])
    assert set(want) == set(got) == set(tsrc.ION_NAMES.values()) | {"DOM"}
    for name, w in want.items():
        np.testing.assert_array_equal(got[name], w, err_msg=name)
    loaded = sum(a.sum() for a in got.values())
    assert (loaded > 0.0) == (branch != "urban, no loading")


def test_apply_initial_ions_matches_jax():
    """init_konc: the sea-salt table times each column's particle counts
    into bins 1 and 2 of the interior levels."""
    sa1, _ = tables(BRANCHES["sea salt + sulfate"])
    rng = np.random.default_rng(0)
    nka, nkt, n = GRID["nka"], GRID["nkt"], 20
    ka = 9
    names = sorted(sa1)
    n2i = {f"{s}l{b}": 2 * i + b - 1 for i, s in enumerate(names)
           for b in (1, 2)}
    ff = rng.random((2, nkt, nka, n)) * 10.0 ** rng.uniform(-2, 2, (2, 1, 1,
                                                                      n))
    conc = 1e-9 * rng.random((2, len(n2i) + 2, n))
    got = tsrc.apply_initial_ions(torch.tensor(conc), sa1, torch.tensor(ff),
                                  n2i, ka, 2)
    for c in range(2):
        want = jsrc.apply_initial_ions(jnp.asarray(conc[c]), sa1,
                                       jnp.asarray(ff[c]), n2i, ka, 2,
                                       jnp.float64)
        assert_rows_close(want, got[c:c + 1], TOL, f"conc[{c}]")
    assert (got[:, :, 0] == torch.tensor(conc[:, :, 0])).all()
    assert (got[:, n2i["Clml2"], 1:-1] > torch.tensor(conc[:, n2i["Clml2"],
                                                           1:-1])).all()


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """(JAX model, port model, JAX states, port batch): the multiphase
    driver on the tiny grid; a foggy column in light wind and the initial
    column in a 14 m/s wind."""
    inp = tmp_path_factory.mktemp("inp")
    mech = tmp_path_factory.mktemp("mech")
    jm, tm, js = make_models(inp, mechdir=mech, multiphase=True)
    tm.init_state(1)
    windy = js.replace(met=js.met.replace(u=js.met.u * 14.0 / 8.5))
    states = [foggy(js, jm.cfg.grid.nf, seed=2), windy]
    return jm, tm, states, to_port_columns(states)


@pytest.mark.parametrize("lpsmith", [False, True])
def test_aer_source_matches_jax(models, lpsmith):
    """One 10-s sea-salt source step (Monahan 1986, or Smith 1993): the
    particles added at their equilibrium water class of level 1 and the
    ions into bin 2."""
    jm, tm, states, ts = models
    jcfg, tcfg = jm.cfg, tm.cfg
    try:
        jm.cfg = dataclasses.replace(jcfg, lpsmith=lpsmith)
        tm.cfg = dataclasses.replace(tcfg, lpsmith=lpsmith)
        got = tsrc.aer_source(tm, ts, 10.0)
        want = [jsrc.aer_source(jm, s, 10.0) for s in states]
    finally:
        jm.cfg, tm.cfg = jcfg, tcfg
    for c, w in enumerate(want):
        assert_close(w.micro.ff, got.micro.ff[c:c + 1], TOL, f"ff[{c}]")
        assert_close(w.micro.fsum, got.micro.fsum[c:c + 1], TOL,
                     f"fsum[{c}]")
        assert_rows_close(w.chem.conc, got.chem.conc[c:c + 1], TOL,
                          f"conc[{c}]")
    added = got.micro.ff - ts.micro.ff
    assert (added[..., 1] > 0.0).any() and (added[..., 2:] == 0.0).all()
    assert (added[1].sum() > added[0].sum())     # the windier column
    cl = tm._chemistry.tot_n2i["Clml2"]
    assert (got.chem.conc[:, cl, 1] > ts.chem.conc[:, cl, 1]).all()
