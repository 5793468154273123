"""``io.profiles`` (profm, profr, profc) against the JAX package's: the
text written from the same states, identical character for character.
The port's batched state holds two different columns (a foggy noon
column and the initial midnight one) and each ``column`` is held against
JAX's profile of that state."""

from __future__ import annotations

import io

import pytest

from _torch_parity import foggy, make_models, to_port_columns
from mistra_tpu.io import profiles as jprof
from mistra_tpu_torch.io import profiles as tprof


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    inp = tmp_path_factory.mktemp("inp")
    mech = tmp_path_factory.mktemp("mech")
    jm, tm, js = make_models(inp, radiation=True, mechdir=mech)
    tm.init_state(1)
    states = [js, foggy(js, jm.cfg.grid.nf, seed=2)]
    return jm, tm, states, to_port_columns(states)


def text(fn, *args, **kw):
    fh = io.StringIO()
    fn(fh, *args, **kw)
    return fh.getvalue()


@pytest.mark.parametrize("column", [0, 1])
def test_profiles_match_jax_text(models, column):
    jm, tm, states, ts = models
    js = states[column]
    nf = jm.cfg.grid.nf
    species = jm._chemistry.mech.species
    assert tm._chemistry.mech.species == species
    pairs = [
        (text(jprof.profm, js, jm.atm, nf),
         text(tprof.profm, ts, tm.atm, nf, column=column)),
        (text(jprof.profr, js, jm.atm, nf),
         text(tprof.profr, ts, tm.atm, nf, column=column)),
        (text(jprof.profc, js, jm.atm, species, nf),
         text(tprof.profc, ts, tm.atm, species, nf, column=column))]
    for want, got in pairs:
        assert want.count("\n") > nf and got == want
