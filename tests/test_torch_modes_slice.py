"""Whole minutes of the configurations the port runs since its modes slice,
against the JAX package's jitted ``minute_step``: mic=F with chemistry
off and on (the gas-phase driver, even at nkc_l=4) and the bare-soil
surface (isurf=1); nucleation's minutes are in test_torch_nucleation.py.
A noon and a midnight column in one batch, two minutes, radiation and
(with chem) photolysis on; tiny grid, the synthetic tables, float64."""

from __future__ import annotations

import pytest
import torch

from _torch_parity import make_models, step_both

MODES = {
    "mic=F": dict(mic=False),
    "mic=F chem=T": dict(mic=False, chem=True, nkc_l=4),
    "isurf=1": dict(isurf=1),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_two_minutes_match_jax(tmp_path, mode):
    kw = dict(MODES[mode])
    chem = kw.pop("chem", False)
    mech = tmp_path / "mech" if chem else None
    if mech is not None:
        mech.mkdir()
    jm, tm, js = make_models(tmp_path, radiation=True, mechdir=mech, **kw)
    tm.init_state(1)
    if chem:
        # the gas-phase driver whenever mic=F, as in the JAX package
        assert type(tm._chemistry).__name__ == "ChemistryDriver" \
            == type(jm._chemistry).__name__
    _, ts0, ts = step_both(jm, tm, js)
    if not jm.cfg.mic:
        # the particles stay where the init put them but for the level
        # nf-1 kept on the Koehler curve
        nf = jm.cfg.grid.nf
        keep = [k for k in range(ts.micro.ff.shape[-1]) if k != nf - 1]
        assert torch.equal(ts.micro.ff[..., keep], ts0.micro.ff[..., keep])
    if jm.cfg.isurf == 1:
        assert not torch.equal(ts.surf.tb, ts0.surf.tb)
        assert not torch.equal(ts.surf.eb, ts0.surf.eb)
