"""The multiphase driver's ``liq_parm`` on a set of levels: on any levels
it gives the whole column's call on those levels, key for key (no stage
couples two levels), and so do ``reaction_rates_at`` and
``integrate_box``, which evaluate it on the levels they read; the
``liq_parm.cells`` counter counts the cells evaluated.  And the fence
that keeps the chemistry away from a chem=F run: such a run imports no
chemistry module, and neither it nor a box minute changes a process-wide
float32 matmul setting.  The port alone, on the CPU: the tiny grid, the
synthetic tables and tot mechanism, the Buys13_0D box in float32 (the
benchmark's state dtype; the tot solve in float64)."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import mistra_tpu_torch as pt
from mistra_tpu_torch import boxmodel as tbox
from mistra_tpu_torch.chemistry import driver_aq
from mistra_tpu_torch.chemistry.activity import xgamma_field
from mistra_tpu_torch.chemistry.mech import write_synthetic_tot_mechanism
from mistra_tpu_torch.photolysis.tables import \
    write_synthetic_photolysis_tables
from mistra_tpu_torch.physics.surface import write_synthetic_clarke_table
from mistra_tpu_torch.radiation.tables import \
    write_synthetic_radiation_tables
from mistra_tpu_torch.utils import profiling

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
TINY_GRID = dict(nf=20, n_extra=10, nka=16, nkt=16, nb=8)
BTZ96 = dict(mic=True, tw=288.15, zinv=100.0, dtinv=7.0, ug=8.5, vg=0.0,
             nw_prof_opt=1, wmax=-0.005, z0=0.0001, alat=55.0)
# the benchmark's buys13_0d settings (test_torch_box_protocol.py)
BUYS = dict(box=True, chem=True, nkc_l=4, halo=True, iod=False,
            iaertyp=3, lp_buys13_0d=True, alat=-75.6, nday=15, nmonth=1)
NF = TINY_GRID["nf"]
B = 3
# the sums over the dry bins may be reordered in float32 on a smaller
# batch of levels; every entry that sums nothing is bit-equal
RTOL = 1e-6
LEVELS = {"box": [tbox.N_BL], "top": [NF - 1], "above": [NF + 2],
          "two": [tbox.N_BL, NF - 1]}


def write_inputs(tmp):
    inp, mech = tmp / "inp", tmp / "mech"
    inp.mkdir()
    mech.mkdir()
    write_synthetic_clarke_table(inp)
    write_synthetic_radiation_tables(inp)
    write_synthetic_photolysis_tables(inp)
    write_synthetic_tot_mechanism(str(mech), 12, 25)
    return inp, mech


@pytest.fixture(scope="module")
def box(tmp_path_factory):
    """A float32 Buys13_0D BoxModel and three boxes a minute on, with
    random hysteresis flags, relative humidity from 0.3 to 1 and every
    aqueous species at random concentrations at every level: both
    branches of cw_rc's hysteresis, flags that the next liq_parm changes
    and live Pitzer activities."""
    inp, mech = write_inputs(tmp_path_factory.mktemp("box"))
    cfg = pt.MistraConfig(grid=pt.GridParams(**TINY_GRID), dtype="float32",
                          inpdir=str(inp), mechdir=str(mech),
                          **dict(BTZ96, **BUYS))
    bm = tbox.BoxModel(cfg, device="cpu")
    s = bm.init_state(B)
    s = s.replace(tim=s.tim.replace(
        lst=torch.tensor([0, 6, 12], dtype=torch.int32)))
    s = bm.minute_step(s)
    rng = np.random.default_rng(19)
    feu = torch.tensor(rng.uniform(0.3, 1.0, tuple(s.met.feu.shape)),
                       dtype=s.met.feu.dtype)
    cloud = torch.tensor(rng.random(tuple(s.chem.cloud.shape)) < 0.5)
    aq = np.asarray(bm.model._chemistry.tot.species_bin) > 0
    conc = s.chem.conc.clone()
    # molalities of order 1 in the box level's aerosol (cm ~ 1e-16)
    conc[:, aq] = torch.tensor(1e-13 * rng.random(tuple(conc[:, aq].shape)),
                               dtype=conc.dtype)
    s = s.replace(met=s.met.replace(feu=feu),
                  chem=s.chem.replace(cloud=cloud, conc=conc))
    return bm, s


@pytest.fixture(autouse=True)
def _tracer_off():
    profiling.disable()
    profiling.reset()
    yield
    profiling.disable()
    profiling.reset()


def at_levels(lp, lev):
    """liq_parm's dict with every tensor taken on the levels lev."""
    return {k: at_levels(v, lev) if isinstance(v, dict) else v[..., lev]
            for k, v in lp.items()}


def leaves(lp, prefix=""):
    for k, v in lp.items():
        if isinstance(v, dict):
            yield from leaves(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


def sums_nothing(key):
    """Entries computed with no sum over the dry bins: the flags and the
    dry-aerosol Henry and HNO3 equilibrium constants, of t alone."""
    return key == "cloud" or key.startswith(("dry.henry_dry.",
                                             "dry.xeq_hno3"))


@pytest.mark.parametrize("rows", ["one", "GEMM_ROWS"])
@pytest.mark.parametrize("which", sorted(LEVELS))
def test_liq_parm_on_levels_is_the_whole_columns_slice(box, which, rows,
                                                       monkeypatch):
    """liq_parm(state, lev) equals liq_parm(state)[..., lev] for every key
    (cw, cm, rc, conv2, cloud, xkmt, vt, each kef/keb entry, each dry
    entry) on the box level, the last level below nf, a level above nf
    (its activity masked to zero) and two levels at once, with the levels
    taken once and repeated to GEMM_ROWS rows; and so does
    reaction_rates_at, against the rates from the whole column's
    liq_parm."""
    if rows == "one":
        monkeypatch.setattr(driver_aq, "GEMM_ROWS", 1)
    bm, s = box
    drv = bm.model._chemistry
    lev = torch.tensor(LEVELS[which])
    full = drv.liq_parm(s)
    want = dict(leaves(at_levels(full, lev)))
    got = dict(leaves(drv.liq_parm(s, lev)))
    assert got.keys() == want.keys()
    assert {"cw", "cm", "rc", "conv2", "cloud", "xkmt", "vt"} <= got.keys()
    for key, w in want.items():
        g = got[key]
        assert g.shape == w.shape and g.dtype == w.dtype, key
        if sums_nothing(key):
            assert torch.equal(g, w), key
        else:
            gap = float((g - w).abs().max())
            assert gap <= RTOL * float(w.abs().max()), (key, gap)
    if which == "above":
        assert not got["cm"].any() and not got["conv2"].any()
    else:
        assert got["cm"].any(), "no active bin on the levels"
    if tbox.N_BL in LEVELS[which]:
        # the box level's activities are not all 1
        xg, _ = xgamma_field(s.met.t.double(), s.chem.conc.double(),
                             full["cm"].double(), full["cw"].double(),
                             drv.tot_n2i, NF)
        assert (xg[..., tbox.N_BL] != 1.0).any()

    y0 = torch.clamp(s.chem.conc, min=0.0)[..., lev].transpose(1, 2) \
        .reshape(-1, drv.tot.nvar)
    k, fix = drv._tot_env(s, full, lev, y0)
    want_r = drv.tot_kernel.reaction_rates(y0, k, fix)
    got_r = drv.reaction_rates_at(s, LEVELS[which])
    assert got_r.shape == (B * len(LEVELS[which]), drv.tot.nrxn)
    scale = want_r.abs().amax(dim=0).clamp(min=1e-300)
    assert float(((got_r - want_r).abs() / scale).max()) <= RTOL


def cells_of(call):
    """liq_parm.cells counted in the liq_parm spans of call()."""
    profiling.reset()
    with profiling.tracing():
        out = call()
    return out, profiling.summary()["liq_parm"]["counts"]["liq_parm.cells"]


def test_integrate_box_evaluates_liq_parm_on_the_box_level(box,
                                                           monkeypatch):
    """integrate_box with liq_parm on the box level returns conc, cloud
    (every level) and nonconv as with liq_parm over every level; the
    liq_parm.cells counter reads B for the box call (B times the copies
    of the level that make GEMM_ROWS rows, at most n) and B * n for
    integrate_column."""
    bm, s = box
    drv = bm.model._chemistry
    n = bm.cfg.grid.n
    _, cells = cells_of(lambda: drv.integrate_box(s, 10.0, tbox.N_BL))
    assert cells == B * min(-(-driver_aq.GEMM_ROWS // B), n)
    monkeypatch.setattr(driver_aq, "GEMM_ROWS", 1)
    got, cells = cells_of(lambda: drv.integrate_box(s, 10.0, tbox.N_BL))
    assert cells == B

    full = drv.liq_parm(s)
    orig = drv.liq_parm
    monkeypatch.setattr(drv, "liq_parm",
                        lambda state, lev=None: at_levels(orig(state), lev))
    want = drv.integrate_box(s, 10.0, tbox.N_BL)
    monkeypatch.setattr(drv, "liq_parm", orig)
    assert torch.equal(got.cloud, full["cloud"])
    assert torch.equal(want.cloud, full["cloud"])
    # the flags moved off the state's at levels other than the box's
    off_box = torch.arange(n) != tbox.N_BL
    assert (got.cloud != s.chem.cloud)[..., off_box].any()
    assert torch.equal(got.nonconv, want.nonconv)
    assert (got.conc != s.chem.conc)[..., tbox.N_BL].any()
    scale = want.conc.abs().amax(dim=2, keepdim=True).clamp(min=1e-30)
    assert float(((got.conc - want.conc).abs() / scale).max()) <= RTOL

    _, cells = cells_of(lambda: drv.integrate_column(s, 10.0))
    assert cells == B * n


FENCE = textwrap.dedent("""
    import json, sys
    import torch
    import mistra_tpu_torch as pt
    from mistra_tpu_torch.physics.surface import write_synthetic_clarke_table
    from mistra_tpu_torch.radiation.tables import \\
        write_synthetic_radiation_tables

    def settings():
        return [torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32,
                torch.get_float32_matmul_precision()]

    def chemistry():
        return sorted(m for m in sys.modules
                      if m.startswith("mistra_tpu_torch.chemistry"))

    inp, grid, btz96, buys, mech = sys.argv[1:]
    grid, btz96, buys = (json.loads(x) for x in (grid, btz96, buys))
    torch.set_num_threads(1)
    out = {"start": settings(), "imported": chemistry()}
    write_synthetic_clarke_table(inp)
    write_synthetic_radiation_tables(inp)
    cfg = pt.MistraConfig(grid=pt.GridParams(**grid), dtype="float32",
                          inpdir=inp, chem=False, **btz96)
    model = pt.Model(cfg, device="cpu")
    model.minute_step(model.init_state(2))
    out["chem_f"] = settings()
    out["chem_f_imported"] = chemistry()
    from mistra_tpu_torch.chemistry.mech import \\
        write_synthetic_tot_mechanism
    from mistra_tpu_torch.photolysis.tables import \\
        write_synthetic_photolysis_tables
    write_synthetic_photolysis_tables(inp)
    write_synthetic_tot_mechanism(mech, 12, 25)
    cfg = pt.MistraConfig(grid=pt.GridParams(**grid), dtype="float32",
                          inpdir=inp, mechdir=mech, **dict(btz96, **buys))
    bm = pt.BoxModel(cfg, device="cpu")
    bm.minute_step(bm.init_state(2))
    out["box"] = settings()
    out["box_imported"] = chemistry()
    print(json.dumps(out))
""")


def test_chem_f_run_imports_no_chemistry_and_box_sets_no_matmul_mode(
        tmp_path):
    """In a fresh interpreter: a chem=F Model (btz96's settings at the
    tests' size) built and stepped a minute imports no
    mistra_tpu_torch.chemistry module; TF32 (cuda matmul, cuDNN) and the
    float32 matmul precision read as at the start after it and after a
    Buys13_0D box minute, which does import the chemistry."""
    (tmp_path / "mech").mkdir()
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-c", FENCE, str(tmp_path),
         json.dumps(TINY_GRID), json.dumps(BTZ96),
         json.dumps(BUYS),
         str(tmp_path / "mech")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout + out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["imported"] == [] and got["chem_f_imported"] == []
    assert got["chem_f"] == got["start"] and got["box"] == got["start"]
    assert "mistra_tpu_torch.chemistry.driver_aq" in got["box_imported"]
