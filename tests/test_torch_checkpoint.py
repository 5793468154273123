"""``io.checkpoint``: restart equivalence in the port (3 minutes against
2 minutes, a save, a restore into a freshly initialised model and 1
minute, bit for bit), for chem=F mic=T and for the multiphase chemistry
(chem=T, nkc_l=4, ``MultiphaseChemState``), both with radiation (and
photolysis) on; every field bit-equal after a round trip with its dtype
kept (the bool cloud flags, the int32 clock); restores into mismatched
templates raise."""

from __future__ import annotations

import dataclasses

import pytest
import torch

import mistra_tpu_torch as pt
from _torch_parity import TINY_GRID, configs
from mistra_tpu_torch.io.checkpoint import (flatten_state,
                                            restore_checkpoint,
                                            save_checkpoint)


def port_model(inp, mech=None, **cfg):
    if mech is not None:
        mech.mkdir(exist_ok=True)
    _, tcfg = configs(inp, radiation=True, mechdir=mech,
                      multiphase=mech is not None, **cfg)
    return pt.Model(tcfg, device="cpu")


def assert_states_equal(a, b):
    fa, fb = flatten_state(a), flatten_state(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        assert fa[k].dtype == fb[k].dtype, k
        assert torch.equal(fa[k], fb[k]), k


@pytest.mark.parametrize("multiphase", [False, True],
                         ids=["chem=F mic=T", "chem=T nkc_l=4"])
def test_restart_equivalence(tmp_path, multiphase):
    mech = tmp_path / "mech" if multiphase else None
    m = port_model(tmp_path, mech)
    s = m.init_state(1)
    for _ in range(2):
        s = m.minute_step(s)
    path = save_checkpoint(str(tmp_path / "ckpt.pt"), s)
    direct = m.minute_step(s)

    fresh = port_model(tmp_path, mech)
    restored = restore_checkpoint(path, fresh.init_state(1))
    assert_states_equal(s, restored)
    assert_states_equal(direct, fresh.minute_step(restored))
    if multiphase:
        assert type(restored.chem).__name__ == "MultiphaseChemState"


def test_round_trip_keeps_every_field_and_dtype(tmp_path):
    m = port_model(tmp_path, tmp_path / "mech")
    s = m.init_state(2)
    s = s.replace(chem=s.chem.replace(
        cloud=torch.rand(s.chem.cloud.shape) > 0.5))
    got = restore_checkpoint(save_checkpoint(str(tmp_path / "c.pt"), s), s)
    assert_states_equal(s, got)
    assert got.chem.cloud.dtype == torch.bool
    assert got.tim.lmin.dtype == got.micro.lcl.dtype == torch.int32
    assert got.met.t.dtype == torch.float64


def test_restore_refuses_a_mismatched_template(tmp_path):
    m = port_model(tmp_path)
    s = m.init_state(1)
    path = save_checkpoint(str(tmp_path / "c.pt"), s)
    # another column count (shapes), another dtype
    with pytest.raises(ValueError, match=r"\(1, 30\), the model's state "
                       r"has torch.float64 \(2, 30\)"):
        restore_checkpoint(path, m.init_state(2))
    with pytest.raises(ValueError, match="torch.float32"):
        restore_checkpoint(path, s.map(
            lambda x: x.float() if x.is_floating_point() else x))
    # a template with chemistry (another class, more fields)
    chem = port_model(tmp_path, tmp_path / "mech").init_state(1)
    with pytest.raises(ValueError, match="chemistry state"):
        restore_checkpoint(path, chem)
    # a template with a field less: the same class, another field set
    met = dataclasses.make_dataclass(
        "MetState", [(f.name, torch.Tensor) for f in
                     dataclasses.fields(s.met) if f.name != "buoy"],
        bases=(type(s.met).__mro__[1],))
    short = s.replace(met=met(**{f.name: getattr(s.met, f.name)
                                 for f in dataclasses.fields(met)}))
    with pytest.raises(ValueError, match="unexpected \\['met.buoy'\\]"):
        restore_checkpoint(path, short)
    with pytest.raises(ValueError, match="not a mistra_tpu_torch"):
        torch.save({"a": torch.zeros(1)}, tmp_path / "other.pt")
        restore_checkpoint(str(tmp_path / "other.pt"), s)


def test_restore_moves_to_the_templates_device(tmp_path):
    s = port_model(tmp_path).init_state(1)
    got = restore_checkpoint(save_checkpoint(str(tmp_path / "c.pt"), s), s)
    assert got.met.t.device == s.met.t.device
    assert TINY_GRID["nf"] + TINY_GRID["n_extra"] == got.met.t.shape[1]
