"""The ensemble mesh's tp > 1 split: ff's dry-aerosol axis over ranks.

Ranks are spawned processes on the CPU, joined to a gloo group through a
``file://`` init under ``tmp_path`` (``_torch_ranks``), each joined with
a deadline.  On ``GridParams(nf=20, n_extra=10, nka=16, nkt=16, nb=8)``
in float64, two columns (one at noon, both fogged):
- ``shard_state`` then ``join_shards`` is the identity for 1x2, 2x1 and
  2x2 meshes, and ``shard_state_hosts`` (the same share) for 2x2; the
  sharding rules are the JAX package's;
- ``make_host_mesh`` in a 4-rank world of two ranks per host: its shape,
  its indices and its tp groups (inside a host), at tp=2 and tp=1;
- BTZ96 with radiation (synthetic tables), one minute at tp=2, gathered
  from the shares, against the port's tp=1: every field within 1e-6 of
  its scale (the whole-minute tolerance of ``_torch_parity.step_both``),
  equal Newton iterations per column and substep, the replicated fields
  bit-equal across the ranks;
- chem=T nkc_l=0 (synthetic gas mechanism and photolysis tables), one
  minute at tp=2 against tp=1: equal Ros3 steps per cell and nonconv,
  the concentrations within 1e-6 of each species' largest value;
- a 2x2 world (4 ranks), BTZ96 without radiation, one minute, against
  the port's tp=1 and against the JAX package's own sharded step
  (``make_ensemble_step`` on a dp=2, tp=2 mesh of conftest's 8 virtual
  CPU devices), both within 1e-6;
- subkon's Newton loop at tp=2 with the ranks' replicated temperature
  0.01 K apart (where a rank-local stop leaves one rank waiting in an
  all_reduce the other never makes): the ranks agree on every stop and
  make the same all_reduce calls;
- the refusals: tp that does not divide nka, and tp > 1 in one process.
The multiphase driver, nucleation and ``BoxModel`` at tp=2 are in
``test_torch_mesh_tp_chem.py``.
The largest difference of each comparison is recorded as a test property
(``max_rel_err``) and printed.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_ranks as R
from _torch_parity import configs, foggy, make_models, to_port_columns
from mistra_tpu_torch.io.checkpoint import flatten_state
from mistra_tpu_torch.parallel import mesh
from mistra_tpu_torch.parallel.bins import BinShard
from mistra_tpu_torch.state import BIN_FIELDS


def check_replicated(ranks, tp):
    """Each replicated field bit-equal on the tp ranks of a column
    shard; each split field their own bins."""
    for r in ranks:
        first = ranks[r["dp_index"] * tp]
        for path, x in r["local"].items():
            if path in BIN_FIELDS:
                assert x.shape[BIN_FIELDS[path]] == 16 // tp, path
            else:
                assert torch.equal(x, first["local"][path]), \
                    f"{path}: rank {r['rank']} differs from rank " \
                    f"{first['rank']}"


def run_split(tmp, cfg, radiation, world, tp, seed, minutes=1, start=None,
              ref_model=None, consts=None):
    """(tp=1 end state, its counts, the ranks' results) of ``minutes``
    from the same start: the port's fogged start, or ``start``."""
    if start is None:
        ref_model, start = R.start_state(cfg, radiation, 2, seed)
    ref, counts = R.step_recording(ref_model, ref_model.minute_step, start,
                                   minutes)
    job = {"cfg": cfg, "tp": tp, "radiation": radiation, "minutes": minutes,
           "state": flatten_state(start), "consts": consts}
    ranks = R.spawn(R.rank_minutes, world, tmp, job, timeout=150.0)
    return ref, counts, ranks


@pytest.fixture(scope="module")
def btz96(tmp_path_factory):
    inp = tmp_path_factory.mktemp("inp")
    _, cfg = configs(inp, radiation=True)
    return run_split(tmp_path_factory.mktemp("ranks"), cfg, True, 2, 2, 7)


@pytest.fixture(scope="module")
def chem_t(tmp_path_factory):
    inp = tmp_path_factory.mktemp("inp")
    _, cfg = configs(inp, radiation=True,
                     mechdir=tmp_path_factory.mktemp("mech"))
    return run_split(tmp_path_factory.mktemp("ranks"), cfg, True, 2, 2, 11)


@pytest.fixture(scope="module")
def world_2x2(tmp_path_factory):
    """BTZ96 without radiation from two fogged JAX columns: the JAX
    model's sharded minute, the port's tp=1 minute and a 2x2 world's."""
    jm, tm, js = make_models(tmp_path_factory.mktemp("inp"))
    nf = jm.cfg.grid.nf
    jstates = [foggy(js, nf, seed=1), foggy(js, nf, seed=2)]
    from mistra_tpu.parallel import mesh as jmesh
    m = jmesh.make_mesh(n_devices=4, tp=2)
    stacked = jax.tree.map(lambda *x: jnp.stack(x), *jstates)
    step = jmesh.make_ensemble_step(jm, m, donate=False)
    jout = step(jmesh.shard_state(stacked, m))
    want = flatten_state(to_port_columns(
        [jax.tree.map(lambda x, c=c: x[c], jout) for c in range(2)]))
    consts = {k: np.asarray(jm.consts[k]) for k in ("a0m", "b0m")}
    ref, counts, ranks = run_split(
        tmp_path_factory.mktemp("ranks"), tm.cfg, False, 4, 2, None,
        start=to_port_columns(jstates), ref_model=tm, consts=consts)
    return ref, counts, ranks, want


@pytest.mark.parametrize("dp,tp,shard", [
    (1, 2, mesh.shard_state), (2, 1, mesh.shard_state),
    (2, 2, mesh.shard_state), (2, 2, mesh.shard_state_hosts)])
def test_shard_then_join_is_the_identity(tmp_path, dp, tp, shard):
    _, cfg = configs(tmp_path, radiation=False)
    model, state = R.start_state(cfg, False, 4, 3)
    meshes = [mesh.Mesh(dp=dp, tp=tp, rank=r) for r in range(dp * tp)]
    shards = [shard(state, m) for m in meshes]
    for m, s in zip(meshes, shards):
        assert s.micro.ff.shape == (4 // dp, 16, 16 // tp, cfg.grid.n)
        assert s.micro.vd.shape == (4 // dp, 16, 16 // tp)
        assert s.met.t.shape == (4 // dp, cfg.grid.n)
        # a mesh without a device leaves each share where it was
        assert s.micro.ff.device == state.micro.ff.device
    if shard is mesh.shard_state_hosts:
        for m, s in zip(meshes, shards):
            want = flatten_state(mesh.shard_state(state, m))
            for k, v in flatten_state(s).items():
                assert torch.equal(v, want[k]), k
    back = flatten_state(mesh.join_shards(shards, meshes[0]))
    for k, v in flatten_state(state).items():
        assert torch.equal(back[k], v), k


def test_host_mesh_of_two_hosts(tmp_path):
    ranks = R.spawn(R.rank_host_mesh, 4, tmp_path, {"ranks_per_host": 2},
                    timeout=90.0)
    # tp=2: one column shard per host, each host's two ranks a tp group
    assert [r[2]["shape"] for r in ranks] == [{"dp": 2, "tp": 2}] * 4
    assert [r[2]["index"] for r in ranks] == [(0, 0), (0, 1), (1, 0),
                                              (1, 1)]
    assert [r[2]["tp_sum"] for r in ranks] == [1.0, 1.0, 5.0, 5.0]
    # tp=1: a column shard per rank over both hosts, no reduction
    assert [r[1]["shape"] for r in ranks] == [{"dp": 4, "tp": 1}] * 4
    assert [r[1]["index"] for r in ranks] == [(d, 0) for d in range(4)]
    assert [r[1]["tp_sum"] for r in ranks] == [0.0, 1.0, 2.0, 3.0]
    assert all("not divisible into hosts of 3" in r["bad_host_size"]
               for r in ranks)
    assert not any(r["jax_imported"] for r in ranks)


def test_btz96_tp2_matches_tp1(btz96, record_property):
    ref, counts, ranks = btz96
    R.check_close(flatten_state(ref), ranks[0]["gathered"], record_property,
                  "btz96_tp2_vs_tp1")
    for r in ranks:
        assert torch.equal(r["newton"], counts["newton"]), r["rank"]
        assert r["allreduce_calls"] == ranks[0]["allreduce_calls"] > 0


def test_btz96_tp2_replicated_fields_bit_equal(btz96):
    _, _, ranks = btz96
    assert [r["bins"] for r in ranks] == [(0, 8), (8, 16)]
    check_replicated(ranks, 2)
    assert not any(r["jax_imported"] for r in ranks)


def test_chem_t_tp2_matches_tp1(chem_t, record_property):
    ref, counts, ranks = chem_t
    R.check_close(flatten_state(ref), ranks[0]["gathered"], record_property,
                  "chem_t_tp2_vs_tp1")
    assert ref.chem.photol_j[0].amax() > 0.0 == ref.chem.photol_j[1].amax()
    for r in ranks:
        assert torch.equal(r["ros3"], counts["ros3"]), r["rank"]
        assert torch.equal(r["newton"], counts["newton"]), r["rank"]
    assert torch.equal(ranks[0]["gathered"]["chem.nonconv"],
                       ref.chem.nonconv)


def test_chem_t_tp2_replicated_fields_bit_equal(chem_t):
    _, _, ranks = chem_t
    check_replicated(ranks, 2)
    assert not any(r["jax_imported"] for r in ranks)


def test_world_2x2_matches_tp1(world_2x2, record_property):
    ref, counts, ranks, _ = world_2x2
    assert [(r["dp_index"], r["tp_index"]) for r in ranks] == \
        [(0, 0), (0, 1), (1, 0), (1, 1)]
    R.check_close(flatten_state(ref), ranks[0]["gathered"], record_property,
                  "world_2x2_vs_tp1")
    for r in ranks:
        col = r["dp_index"]
        assert torch.equal(r["newton"], counts["newton"][:, col:col + 1])
    check_replicated(ranks, 2)
    assert not any(r["jax_imported"] for r in ranks)


def test_world_2x2_matches_jax_sharded_step(world_2x2, record_property):
    _, _, ranks, want = world_2x2
    R.check_close(want, ranks[0]["gathered"], record_property,
                  "world_2x2_vs_jax_sharded")


def test_newton_stop_agreed_across_ranks(tmp_path):
    (tmp_path / "inp").mkdir()
    _, cfg = configs(tmp_path / "inp", radiation=False)
    _, state = R.start_state(cfg, False, 2, 7)
    ranks = R.spawn(R.rank_subkon_skewed, 2, tmp_path,
                    {"cfg": cfg, "state": flatten_state(state),
                     "t_skew": 0.01}, timeout=90.0)
    assert torch.equal(ranks[0]["iterations"], ranks[1]["iterations"])
    assert ranks[0]["allreduce_calls"] == ranks[1]["allreduce_calls"]
    # one all_reduce for the sum and one for the stop flags per iteration,
    # then the sum after the loop, still paired
    assert ranks[0]["allreduce_calls"] == \
        2 * int(ranks[0]["iterations"].max()) + 1
    for r in ranks:
        assert torch.equal(r["after"], torch.full((3,), 2.0,
                                                  dtype=torch.float64))


def test_sharding_rules_are_the_jax_packages():
    from mistra_tpu.parallel import mesh as jmesh
    B, nkt, nka, n = 4, 16, 16, 30
    ff = torch.zeros(B, nkt, nka, n)
    assert mesh.spec_for("micro.ff", ff) == tuple(
        jmesh._spec_for(".micro.ff", np.zeros((B, nkt, nka, n)), None))
    assert mesh.spec_for("met.t", torch.zeros(B, n)) == ("dp", None)
    assert mesh.spec_for("micro.vd", torch.zeros(B, nkt, nka)) == \
        ("dp", None, "tp")
    assert mesh.host_spec_for("micro.ff", ff) == tuple(
        jmesh.host_spec_for(".micro.ff", np.zeros((B, nkt, nka, n)), None))
    # one process is a host mesh of one rank; tp > 1 needs ranks
    assert mesh.make_host_mesh(devices=["cpu"]).shape == {"dp": 1, "tp": 1}
    with pytest.raises(ValueError, match="tp=2"):
        mesh.make_host_mesh(tp=2, devices=["cpu"])


def test_tp_must_divide_nka(tmp_path):
    with pytest.raises(ValueError, match="must divide nka"):
        BinShard.split(16, 3, 0)
    with pytest.raises(ValueError, match="must divide nka"):
        mesh.Mesh(dp=1, tp=3).bins(16)
    _, cfg = configs(tmp_path, radiation=False)
    _, state = R.start_state(cfg, False, 2, 0)
    with pytest.raises(ValueError, match="must divide nka"):
        mesh.shard_state(state, mesh.Mesh(dp=1, tp=5))
