"""``parallel.mesh``: an ensemble of four columns split over two devices
(here ``["cpu", "cpu"]``, one ``Model`` replica each) equals the batched
run of one model bit for bit over two minutes; tp > 1 in one process
raises, and a Model that holds the bins of a tp rank without its process
group raises at its first sum over the bins (the rest of the tp > 1
tests: ``test_torch_mesh_tp.py`` and ``test_torch_mesh_tp_chem.py``); a
single process needs no distributed
set-up, and two spawned processes join one gloo group, while a request
that names no backend raises."""

from __future__ import annotations

import dataclasses

import pytest
import torch

import mistra_tpu_torch as pt
from _torch_parity import configs, foggy, make_models, to_port_columns
from _torch_ranks import rank_join, spawn
from mistra_tpu_torch.io.checkpoint import flatten_state
from mistra_tpu_torch.parallel import mesh
from mistra_tpu_torch.parallel.bins import BinShard


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


def test_tp_above_one_raises(tmp_path):
    with pytest.raises(ValueError, match="init_distributed"):
        mesh.make_mesh(devices=["cpu", "cpu"], tp=2)
    # a tp rank's bins are taken on every path (the multiphase driver's
    # too); without the process group the first sum over the bins raises
    _, tcfg = configs(tmp_path, radiation=False)
    tcfg = dataclasses.replace(tcfg, chem=True, nkc_l=4)
    model = pt.Model(tcfg, device="cpu", bins=BinShard.split(16, 2, 1))
    assert (model.bins.lo, model.bins.hi, model.bins.group) == (8, 16, None)
    with pytest.raises(RuntimeError, match="no tp group"):
        model.bins.sum_bins(torch.ones(2))
    with pytest.raises(ValueError, match="must divide nka"):
        BinShard.split(16, 3, 0)


def test_init_distributed_single_process_noop():
    assert mesh.init_distributed() is False
    assert mesh.init_distributed(num_processes=1) is False


def test_init_distributed_several_processes_raises(tmp_path):
    # no backend named: raises before it joins anything
    with pytest.raises(ValueError, match="name the backend"):
        mesh.init_distributed("tcp://localhost:29500", 2, 0)
    # two spawned processes join one gloo group; joining again is a no-op
    ranks = spawn(rank_join, 2, tmp_path, str(tmp_path), timeout=60.0)
    assert [(r["rank"], r["world"], r["backend"], r["again"])
            for r in ranks] == [(0, 2, "gloo", True), (1, 2, "gloo", True)]
    assert not any(r["jax_imported"] for r in ranks)
