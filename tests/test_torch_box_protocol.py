"""The port's ``BoxModel`` steps as ``Model`` does: ``minute_step`` is
``pre_minute``, six ``substep`` calls and ``post_minute``, bit for bit,
in box, bl_box and chamber mode (and with the tracer on);
``photolysis_step`` recomputes only the boxes it is told to; ``astro``,
``dtype``, ``grids`` and ``_photolysis`` are the owned ``Model``'s; and
the boxes of a batch are independent: each box of a batch of three that
differ agrees with the same box run alone.  The port alone, on the CPU:
the tiny grid, the synthetic tables and mechanisms, float64."""

from __future__ import annotations

import dataclasses

import pytest
import torch

import mistra_tpu_torch as pt
from mistra_tpu_torch import boxmodel as tbox
from mistra_tpu_torch.chemistry.mech import (write_synthetic_gas_mechanism,
                                             write_synthetic_tot_mechanism)
from mistra_tpu_torch.photolysis.tables import \
    write_synthetic_photolysis_tables
from mistra_tpu_torch.physics.surface import write_synthetic_clarke_table
from mistra_tpu_torch.radiation.tables import \
    write_synthetic_radiation_tables
from mistra_tpu_torch.utils import profiling

torch.set_num_threads(1)

TINY_GRID = dict(nf=20, n_extra=10, nka=16, nkt=16, nb=8)
BTZ96 = dict(mic=True, tw=288.15, zinv=100.0, dtinv=7.0, ug=8.5, vg=0.0,
             nw_prof_opt=1, wmax=-0.005, z0=0.0001, alat=55.0)
# the Buys13_0D polar box (the benchmark's buys13_0d settings): every dry
# bin sea salt, Halley in January, when the sun never sets
BUYS = dict(box=True, chem=True, nkc_l=4, halo=True, iod=False,
            iaertyp=3, lp_buys13_0d=True, alat=-75.6, nday=15, nmonth=1)
MODES = {
    "box": dict(chem=True, nkc_l=4, box=True, nlevbox=5, z_box=50.0),
    "bl_box": dict(chem=True, nkc_l=0, box=True, bl_box=True, nlevbox=5,
                   z_box=50.0),
    "chamber": dict(chem=True, mic=False, nkc_l=0, halo=True, iod=False,
                    z_box=50.0, chamber=True, lp_buxmann15alph=True),
    "buys": BUYS,
}
TOL = 1e-10


def make_box(tmp, **kw):
    inp, mech = tmp / "inp", tmp / "mech"
    inp.mkdir()
    mech.mkdir()
    write_synthetic_clarke_table(inp)
    write_synthetic_radiation_tables(inp)
    write_synthetic_photolysis_tables(inp)
    if kw.get("nkc_l"):
        write_synthetic_tot_mechanism(str(mech), 12, 25)
    else:
        write_synthetic_gas_mechanism(str(mech), 20)
    if kw.get("chamber"):
        tbox.write_synthetic_chamber_dat(inp / "photolys")
    cfg = pt.MistraConfig(grid=pt.GridParams(**TINY_GRID), dtype="float64",
                          inpdir=str(inp), mechdir=str(mech),
                          **dict(BTZ96, **kw))
    return tbox.BoxModel(cfg, device="cpu")


def three_boxes(bm):
    """Three boxes that differ: at 00:00, 06:00 and 12:00 (a chamber at
    13, 60 and 119 minutes, across the lights' edges), each box-level
    concentration scaled by its own factor."""
    s = bm.init_state(3)
    tim = s.tim.replace(lst=torch.tensor([0, 6, 12], dtype=torch.int32))
    if bm.cfg.chamber:
        tim = s.tim.replace(time=torch.tensor([13.0, 60.0, 119.0],
                                              dtype=s.tim.time.dtype) * 60.0)
    field = bm.model._chemistry.conc_name
    conc = getattr(s.chem, field).clone()
    conc[:, :, tbox.N_BL] *= torch.tensor([1.0, 1.3, 0.7],
                                          dtype=conc.dtype)[:, None]
    return s.replace(tim=tim, chem=s.chem.replace(**{field: conc}))


@pytest.fixture(scope="module", params=list(MODES))
def mode(request, tmp_path_factory):
    bm = make_box(tmp_path_factory.mktemp(request.param),
                  **MODES[request.param])
    return request.param, bm, three_boxes(bm)


def leaves(state, prefix=""):
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if v is None:
            continue
        if dataclasses.is_dataclass(v):
            yield from leaves(v, prefix + f.name + ".")
        else:
            yield prefix + f.name, v


def assert_bit_equal(a, b):
    bad = [p for (p, x), (_, y) in zip(leaves(a), leaves(b))
           if not torch.equal(x, y)]
    assert not bad, bad


def test_minute_step_is_the_step_protocol(mode):
    """minute_step (traced and not) against pre_minute, 6 substeps and
    post_minute called one by one, over two minutes (one of them even:
    the J-rates recomputed), bit for bit."""
    _, bm, s = mode
    by_steps = s
    for _ in range(2):
        by_steps = bm.pre_minute(by_steps)
        for _ in range(6):
            by_steps = bm.substep(by_steps, 10.0)
        by_steps = bm.post_minute(by_steps)
    whole = bm.minute_step(bm.minute_step(s))
    assert_bit_equal(whole, by_steps)
    profiling.reset()
    try:
        with profiling.tracing(records=True):
            traced = bm.minute_step(bm.minute_step(s))
            records = profiling.collect()
    finally:
        profiling.reset()
    assert_bit_equal(traced, by_steps)
    names = {r["name"] for r in records}
    assert {"minute", "pre_minute", "substep", "sedc_box", "box_partdep",
            "chem_solve", "post_minute"} <= names
    assert ("sea_salt" in names) == bool(bm.cfg.box)
    assert sum(r["name"] == "substep" for r in records) == 12


def test_photolysis_step_changes_only_the_due_boxes(mode):
    """The boxes where due is false keep their J-rates (where the sun is
    up; a bl_box's ave_j averages the held box's boundary layer into its
    box level anew, as the JAX package does); the due ones take what the
    whole batch's call gives them."""
    _, bm, s = mode
    s = bm.post_minute(bm.pre_minute(s))
    s = s.replace(chem=s.chem.replace(photol_j=s.chem.photol_j + 1e-3))
    due = torch.tensor([True, False, True])
    out = bm.photolysis_step(s, due)
    every = bm.photolysis_step(s, torch.ones(3, dtype=torch.bool))
    lit = s.rad.u0 > bm.model._chemistry.u0min
    pj, pj0, pj1 = out.chem.photol_j, s.chem.photol_j, every.chem.photol_j
    if not bm.cfg.chamber:
        assert lit[1], "the held box must have its sun up"
    held = pj0[1].clone()
    if bm.cfg.bl_box:
        held[:, tbox.N_BL] = held[:, 1:bm.nz_box + 1].mean(dim=1)
    assert torch.equal(pj[1], held)
    assert torch.equal(pj[due], pj1[due])
    assert not torch.equal(pj[0], pj0[0])
    for path, x in leaves(out):
        if path != "chem.photol_j":
            assert torch.equal(x, dict(leaves(s))[path]), path


def test_box_reads_its_models_attributes(mode):
    _, bm, _ = mode
    m = bm.model
    assert bm.astro is m.astro and bm.dtype is m.dtype
    assert bm.grids is m.grids and bm._photolysis is m._photolysis
    assert bm._photolysis is not None
    for attr in ("astro", "dtype", "grids", "_photolysis"):
        with pytest.raises(AttributeError):
            setattr(bm, attr, None)
    if bm.cfg.chamber:
        assert bm.astro.declin == 18.0


def test_boxes_of_a_batch_are_independent(mode):
    """Two minutes of three boxes that differ, as one batch and each box
    alone: every field of each box to 1e-10 of that field's scale in the
    box."""
    _, bm, s = mode
    batch = bm.minute_step(bm.minute_step(s))
    for i in range(3):
        alone = s.map(lambda x, i=i: x[i:i + 1].clone())
        alone = bm.minute_step(bm.minute_step(alone))
        for (path, x), (_, y) in zip(leaves(batch), leaves(alone)):
            x = x[i:i + 1]
            if not x.is_floating_point():
                assert torch.equal(x, y), (i, path)
                continue
            scale = y.abs().max().clamp(min=1e-300)
            assert float((x - y).abs().max() / scale) <= TOL, (i, path)
