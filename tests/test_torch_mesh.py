"""``parallel.mesh``: an ensemble of four columns split over two devices
(here ``["cpu", "cpu"]``, one ``Model`` replica each) equals the batched
run of one model bit for bit over two minutes; tp > 1 raises, naming the
ROADMAP item; a single process needs no distributed set-up, and more
than one raises, naming the same item."""

from __future__ import annotations

import pytest
import torch

import mistra_tpu_torch as pt
from _torch_parity import configs, foggy, make_models, to_port_columns
from mistra_tpu_torch.io.checkpoint import flatten_state
from mistra_tpu_torch.parallel import mesh


def test_ensemble_over_two_devices_equals_one_batched_run(tmp_path):
    jm, tm, js = make_models(tmp_path, radiation=True)
    nf = jm.cfg.grid.nf
    state = to_port_columns([js] + [foggy(js, nf, seed=s)
                                    for s in (1, 2, 3)])
    tm.init_state(1)
    _, tcfg = configs(tmp_path, radiation=True)

    def factory(device):
        m = pt.Model(tcfg, device=device)
        m.init_state(1)
        return m

    step = mesh.make_ensemble_step(factory, mesh.make_mesh(
        devices=["cpu", "cpu"]))
    assert [m.device.type for m in step.models] == ["cpu", "cpu"]
    a = b = state
    for _ in range(2):
        a = tm.minute_step(a)
        b = step(b)
    fa, fb = flatten_state(a), flatten_state(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        assert fa[k].shape[0] == 4 and torch.equal(fa[k], fb[k]), k


def test_split_and_join_columns(tmp_path):
    _, tm, js = make_models(tmp_path)
    s = mesh.replicate_state(to_port_columns([js]), 5)
    parts = mesh.split_columns(s, 3)
    assert [p.met.t.shape[0] for p in parts] == [1, 2, 2]
    back = mesh.join_columns(parts, torch.device("cpu"))
    for k, v in flatten_state(s).items():
        assert torch.equal(v, flatten_state(back)[k])


def test_tp_above_one_raises():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        mesh.make_mesh(devices=["cpu", "cpu"], tp=2)
    with pytest.raises(NotImplementedError, match="tp > 1"):
        mesh.make_ensemble_step(lambda d: None, ["cpu", "cpu"], tp=2)


def test_init_distributed_single_process_noop():
    assert mesh.init_distributed() is False
    assert mesh.init_distributed(num_processes=1) is False


def test_init_distributed_several_processes_raises():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        mesh.init_distributed("tcp://localhost:29500", 2, 0)
