"""The ensemble mesh's tp > 1 split on the chemistry paths: the multiphase
driver, nucleation and ``BoxModel`` with ff's dry-aerosol axis over ranks.

Ranks are spawned processes on the CPU in gloo groups (``_torch_ranks``):
one world of two ranks (tp=2) runs every case, one of four (dp=2, tp=2)
the multiphase minute, while this process runs the same cases at tp=1
(``_torch_ranks.run_group``).  On ``GridParams(nf=20, n_extra=10,
nka=16, nkt=16, nb=8)`` in float64, with radiation and photolysis on the
synthetic tables, two fogged columns (boxes), the first at noon:
- the multiphase minute (nkc_l=4, the small tot stand-in): every field
  within 1e-6 of its scale (``chem.conc`` per species row), equal Ros3
  steps per cell in both solves, equal nonconv and Newton iterations;
- the mass feedback alone, on a state whose chemistry grew the small
  aerosol's dry mass 5-fold, so that rank 0's bins send particles into
  rank 1's: the particles crossed, the result is tp=1's within 1e-12,
  and the particle number and the dry mass (the old one plus what the
  chemistry added) are conserved;
- konc alone, with particles crossing the kw threshold on both ranks'
  bins: conc bit-equal to tp=1;
- nucleation with the gas-phase driver (nkc_l=0, both mechanisms,
  ifeed=1): one step adds particles on rank 0 only (the rank that holds
  dry bin 0), and one minute as the multiphase case; nucleation with the
  multiphase driver (ifeed=1), one minute;
- ``BoxModel``: a box with the multiphase driver and a chamber (mic=F,
  the gas-phase driver), each two boxes one minute, through
  ``make_ensemble_step`` on the mesh;
- a 2x2 world (4 ranks), the multiphase minute, against tp=1.
In every case the replicated fields are bit-equal across the tp ranks and
every rank makes the same all_reduce calls.  The largest difference of
each comparison is recorded as a test property (``max_rel_err``).  The
port's tp=1 is held against the JAX package in
``test_torch_multiphase*.py``, ``test_torch_nucleation*.py``,
``test_torch_boxmodel.py`` and ``test_torch_chamber.py``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import _torch_ranks as R
from _torch_parity import configs
from mistra_tpu_torch.boxmodel import (LIGHTS_ON_S,
                                       write_synthetic_chamber_dat)
from mistra_tpu_torch.state import BIN_FIELDS

# the mass feedback alone: tp=2 against tp=1 in one call
FEEDBACK_TOL = 1e-12
NKA, TP = 16, 2
# the small aerosol's dry-mass growth factor of the feedback case: a
# bin's particles move ~1.1 bins up the grid (en grows 4.49-fold per bin)
GROWTH = 5.0
# vapor concentrations [mol/m3] of the nucleation cases (as
# test_torch_nucleation.py)
VAPORS_GAS = {"H2SO4": 5e-9, "NH3": 1e-9, "OIO": 5e-10}
VAPORS_TOT = {"H2SO4": 5e-9, "NH3": 1e-9}
# the box of test_torch_boxmodel.py and the chamber of
# test_torch_chamber.py
BOX = dict(box=True, nlevbox=5, z_box=50.0)
CHAMBER = dict(chamber=True, mic=False, nkc_l=0, halo=True, iod=False,
               z_box=50.0, lp_buxmann15alph=True)


def check_ranks(ranks, group, run, tp=TP):
    """Each replicated field of the run's end state bit-equal on the tp
    ranks of a column shard, each split field their own bins; the same
    all_reduce calls and bytes on those ranks (more than none)."""
    for r in ranks:
        first = ranks[r["dp_index"] * tp]
        mine, theirs = r["groups"][group][run], first["groups"][group][run]
        for path, x in mine["local"].items():
            if path in BIN_FIELDS:
                assert x.shape[BIN_FIELDS[path]] == NKA // tp, path
            else:
                assert torch.equal(x, theirs["local"][path]), \
                    f"{group} {run} {path}: rank {r['rank']} differs " \
                    f"from rank {first['rank']}"
        for k in ("allreduce_calls", "allreduce_bytes"):
            assert mine[k] == theirs[k] > 0, k
    assert not any(r["jax_imported"] for r in ranks)


def check_minute(ref, ranks, group, record, tp=TP, what=None):
    """The gathered minute against tp=1; equal Ros3 steps per cell and
    call, nonconv and Newton iterations (each rank's columns)."""
    want = ref[group]["minute"]
    R.check_close(want["state"], ranks[0]["groups"][group]["minute"]["state"],
                  record, what or f"{group}_tp{tp}_vs_tp1")
    B = want["nonconv"].shape[0]
    for r in ranks:
        got = r["groups"][group]["minute"]
        dp = len(ranks) // tp
        cols = slice(r["dp_index"] * B // dp, (r["dp_index"] + 1) * B // dp)
        assert torch.equal(got["nonconv"], want["nonconv"][cols])
        for k in ("ros3", "ros3_tot", "newton"):
            if want[k] is None:
                assert got[k] is None, k
                continue
            w = want[k]
            if k != "newton":
                # cells are column-major: this rank's columns' cells
                w = w.reshape(w.shape[0], B, -1)[:, cols].reshape(
                    w.shape[0], -1)
            else:
                w = w[:, cols]
            assert torch.equal(got[k], w), f"{group} rank {r['rank']}: {k}"
    check_ranks(ranks, group, "minute", tp)


def feedback_input(model, state):
    """conc before the chemistry for the feedback case: the small
    aerosol's (chemistry bin 1) SO4-- grown so that its dry mass grows
    GROWTH-fold where the bin is active; no other ion changed."""
    drv = model._chemistry
    ff = state.micro.ff
    mkc = drv._masks[:, :, 0]
    smp = torch.einsum("tk,btkn->bn", mkc * drv._en, ff)
    i = drv.tot_n2i["SO42ml1"]
    conc_before = state.chem.conc.clone()
    conc_before[:, i] -= (GROWTH - 1.0) * smp * 1.0e3 / 96.0
    return conc_before


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case at tp=1 in this process and at tp=2 in a world of two
    ranks, and the multiphase minute in a world of four (the ranks run
    while this process runs tp=1)."""
    inp = tmp_path_factory.mktemp("inp")
    mp = configs(inp, radiation=True, mechdir=tmp_path_factory.mktemp("mp"),
                 multiphase=True)[1]
    nuc_gas = configs(inp, radiation=True,
                      mechdir=tmp_path_factory.mktemp("gas"), n_gas=45,
                      nuc=True, napari=True, lovejoy=True, ifeed=1)[1]
    nuc_mp = configs(inp, radiation=True,
                     mechdir=tmp_path_factory.mktemp("nmp"), multiphase=True,
                     nuc=True, ifeed=1)[1]
    box = configs(inp, radiation=True, mechdir=tmp_path_factory.mktemp("bx"),
                  multiphase=True, **BOX)[1]
    write_synthetic_chamber_dat(inp / "photolys")
    chamber = configs(inp, radiation=True,
                      mechdir=tmp_path_factory.mktemp("ch"), **CHAMBER)[1]

    built = {
        "multiphase": R.start_group(mp, True, 2, 7),
        "nuc_gas": R.start_group(nuc_gas, True, 2, 11, VAPORS_GAS),
        "nuc_mp": R.start_group(nuc_mp, True, 2, 13, VAPORS_TOT),
        "box": R.start_group(box, True, 2, 17),
        # the lights come on during the minute
        "chamber": R.start_group(chamber, True, 2, 19,
                                 time_s=LIGHTS_ON_S - 30.0)}
    model, _, start = built["multiphase"]
    rng = np.random.default_rng(3)
    ff_after = start.micro.ff * torch.from_numpy(
        rng.uniform(0.2, 2.0, tuple(start.micro.ff.shape)))
    extras = {
        "multiphase": {"feedback": feedback_input(model, start),
                       "konc": ff_after, "minute": 1},
        "nuc_gas": {"nucleation": None, "minute": 1},
        "nuc_mp": {"minute": 1}, "box": {"minute": 1},
        "chamber": {"minute": 1}}
    groups = {k: {"cfg": b[0].cfg, "radiation": True,
                  "state": R.flatten_state(b[2]), "runs": extras[k]}
              for k, b in built.items()}
    two = R.start(R.rank_groups, 2, tmp_path_factory.mktemp("two"),
                  {"tp": TP, "groups": groups}, timeout=600.0)
    four = R.start(R.rank_groups, 4, tmp_path_factory.mktemp("four"),
                   {"tp": TP, "groups": {"multiphase": dict(
                       groups["multiphase"], runs={"minute": 1})}},
                   timeout=600.0)
    ref = {k: R.run_group(groups[k], built=b) for k, b in built.items()}
    return ref, R.join(two), R.join(four), built, ff_after


def test_multiphase_tp2_matches_tp1(runs, record_property):
    ref, ranks, _, _, _ = runs
    assert [r["bins"] for r in ranks] == [(0, 8), (8, 16)]
    check_minute(ref, ranks, "multiphase", record_property)
    conc = ref["multiphase"]["minute"]["state"]["chem.conc"]
    assert ref["multiphase"]["minute"]["ros3_tot"].float().mean() > 5.0
    assert torch.isfinite(conc).all()


def test_multiphase_liq_parm_makes_two_all_reduce_calls(runs):
    """liq_parm: cw_rc's sums, then fast_k_mt's (fall speeds included;
    the dry-aerosol rates take cw_rc's)."""
    _, _, _, built, _ = runs
    model, _, start = built["multiphase"]
    calls = []
    sum_bins = model.bins.sum_bins

    def spy(*partial):
        calls.append(len(partial))
        return sum_bins(*partial)
    model.bins.sum_bins = spy
    try:
        model._chemistry.liq_parm(start)
    finally:
        model.bins.sum_bins = sum_bins
    assert calls == [3, 2]


def test_mass_feedback_crosses_ranks_and_conserves(runs, record_property):
    ref, ranks, _, built, _ = runs
    want = ref["multiphase"]["feedback"]
    got = ranks[0]["groups"]["multiphase"]["feedback"]
    R.check_close(want["state"], got["state"], record_property,
                  "feedback_tp2_vs_tp1", FEEDBACK_TOL)
    check_ranks(ranks, "multiphase", "feedback")
    # rank 0's sources sent particles into rank 1's bins (chemistry bin
    # 1, the first call); at tp=1 there is no other rank
    sent = [r["groups"]["multiphase"]["feedback"]["sent"] for r in ranks]
    assert sent[0][0] > 0.0 and want["sent"] == [0.0] * len(want["sent"])
    ff0 = R.flatten_state(built["multiphase"][2])["micro.ff"]
    ff1 = got["state"]["micro.ff"]
    assert not torch.equal(ff1[:, :, 8:], ff0[:, :, 8:])
    # number conserved; dry mass: the old one plus the chemistry's
    model, _, start = built["multiphase"]
    drv = model._chemistry
    n0, n1 = ff0.sum(dim=(1, 2)), ff1.sum(dim=(1, 2))
    assert float((n1 - n0).abs().max()) <= 1e-12 * float(n0.abs().max())
    en = drv._en[None, None, :, None]
    m0, m1 = (ff0 * en).sum(dim=(1, 2)), (ff1 * en).sum(dim=(1, 2))
    mkc = drv._masks[:, :, 0]
    sap = torch.einsum("tk,btkn->bn", mkc, ff0)
    smp = torch.einsum("tk,btkn->bn", mkc * drv._en, ff0)
    cm = drv._cw_rc(start)[1][:, 0]
    lev = torch.arange(ff0.shape[-1])
    active = (sap > 1e-6) & (cm > 0.0) & (lev >= 1) & (lev < 20)
    assert active.any()
    added = torch.where(active, (GROWTH - 1.0) * smp, 0.0)
    assert float((m1 - m0 - added).abs().max()) <= 1e-12 * float(m1.max())
    assert float(added.max()) > 0.0


def test_konc_bit_equal_to_tp1(runs, record_property):
    ref, ranks, _, built, ff_after = runs
    want = ref["multiphase"]["konc"]["state"]["chem.conc"]
    got = ranks[0]["groups"]["multiphase"]["konc"]["state"]["chem.conc"]
    record_property("max_rel_err_konc_tp2_vs_tp1",
                    f"{R.rel_errs({'c': want}, {'c': got})['c']:.3e}")
    assert torch.equal(got, want)
    start = built["multiphase"][2]
    assert not torch.equal(want, start.chem.conc)
    check_ranks(ranks, "multiphase", "konc")
    # particles crossed the kw threshold in bins of both ranks
    kw = built["multiphase"][0].micro.kw
    jt = torch.arange(ff_after.shape[1])[:, None]
    aero = (jt < kw[None, :]).to(ff_after.dtype)[None, :, :, None]
    dp_a = ((start.micro.ff - ff_after) * aero).sum(dim=1).abs()
    crossed = (dp_a >= 1e-10).any(dim=-1).any(dim=0)          # [nka]
    assert crossed[:NKA // TP].any() and crossed[NKA // TP:].any()


def test_nucleation_adds_particles_on_rank_zero_only(runs, record_property):
    ref, ranks, _, _, _ = runs
    changes = [r["groups"]["nuc_gas"]["nucleation"]["ff_change"]
               for r in ranks]
    assert changes[0] > 0.0 == changes[1]
    assert ref["nuc_gas"]["nucleation"]["ff_change"] > 0.0
    R.check_close(ref["nuc_gas"]["nucleation"]["state"],
                  ranks[0]["groups"]["nuc_gas"]["nucleation"]["state"],
                  record_property, "nucleation_step_tp2_vs_tp1")
    check_ranks(ranks, "nuc_gas", "nucleation")


def test_nucleation_gas_minute_tp2_matches_tp1(runs, record_property):
    ref, ranks, _, _, _ = runs
    check_minute(ref, ranks, "nuc_gas", record_property)


def test_nucleation_multiphase_minute_tp2_matches_tp1(runs,
                                                      record_property):
    ref, ranks, _, _, _ = runs
    check_minute(ref, ranks, "nuc_mp", record_property)


@pytest.mark.parametrize("group", ["box", "chamber"])
def test_boxmodel_tp2_matches_tp1(runs, record_property, group):
    ref, ranks, _, _, _ = runs
    check_minute(ref, ranks, group, record_property)


def test_world_2x2_multiphase_matches_tp1(runs, record_property):
    ref, _, ranks, _, _ = runs
    assert [(r["dp_index"], r["tp_index"]) for r in ranks] == \
        [(0, 0), (0, 1), (1, 0), (1, 1)]
    check_minute(ref, ranks, "multiphase", record_property,
                 what="multiphase_2x2_vs_tp1")
