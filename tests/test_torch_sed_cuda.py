"""Sedimentation advection of the PyTorch port through the hand-written CUDA
kernel (csrc/sed.cu, ``physics/sed_cuda.py``): the wrapper refusing what
the kernel does not take, CPU tensors on the plain path, and on a CUDA
device the kernel against the plain versions bit for bit, sedp and sedl
through it against the plain path, sedl's column budget, and the BTZ96
and multiphase minutes reaching it.

The CUDA tests run on a GPU host without JAX and without the suite's
conftest (which configures JAX):
    python -m pytest --noconftest -m gpu tests/test_torch_sed_cuda.py
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import mistra_tpu_torch as pt
from mistra_tpu_torch.chemistry.driver_aq import SEDL_SPLITS
from mistra_tpu_torch.chemistry.mech import write_synthetic_tot_mechanism
from mistra_tpu_torch.photolysis.tables import \
    write_synthetic_photolysis_tables
from mistra_tpu_torch.physics import sed_cuda
from mistra_tpu_torch.physics import sedimentation as sed
from mistra_tpu_torch.physics.surface import write_synthetic_clarke_table
from mistra_tpu_torch.radiation.tables import \
    write_synthetic_radiation_tables
from mistra_tpu_torch.utils import profiling

TINY_GRID = dict(nf=20, n_extra=10, nka=16, nkt=16, nb=8)
BTZ96 = dict(chem=False, mic=True, tw=288.15, zinv=100.0, dtinv=7.0, ug=8.5,
             vg=0.0, nw_prof_opt=1, wmax=-0.005, z0=0.0001, alat=55.0)


def advect_inputs(seed, rows, nf, dtype=torch.float64, device="cpu"):
    """(c, y, upstream) of rows [rows, nf]: y from 2^-20 to 2^20 with zeros,
    empty rows, rows of ties and of alternating ties; Courant numbers in
    [-1, 0], rows within 1e-6 of -1, rows of both signs, zeros; upstream
    on about half the rows."""
    rng = np.random.default_rng(seed)
    y = rng.uniform(0.0, 1.0, (rows, nf)) * 2.0 ** rng.integers(-20, 21,
                                                                 (rows, nf))
    y[rng.uniform(size=(rows, nf)) < 0.2] = 0.0
    kind = rng.integers(0, 5, rows)
    y[kind == 1] = 0.0
    y[kind == 2] = 1.0
    y[kind == 3, ::2] = 0.5
    c = -rng.uniform(0.0, 1.0, (rows, nf))
    near = rng.uniform(size=rows) < 0.3
    c[near] = -(1.0 - rng.uniform(0.0, 1e-6, (int(near.sum()), nf)))
    both = kind == 4
    c[both] = rng.uniform(-1.0, 1.0, (int(both.sum()), nf))
    c[rng.uniform(size=(rows, nf)) < 0.1] = 0.0
    up = rng.uniform(size=rows) < 0.5
    return (torch.tensor(c, dtype=dtype, device=device),
            torch.tensor(y, dtype=dtype, device=device),
            torch.tensor(up, device=device))


def split_inputs(seed, rows, nf, dtype=torch.float64, device="cpu"):
    """(c, psi, xxxt, dt0) of sedl's splits: Courant numbers per second
    up to a row's level-1 value, 1e-5 to 2 (1 to 8 splits of 10 s, and
    rows whose last residual is dropped), xxxt = -0.999 / c[1] as sedl
    forms it."""
    _, psi, _ = advect_inputs(seed, rows, nf, dtype, device)
    rng = np.random.default_rng(seed + 1)
    scale = 10.0 ** rng.uniform(-5.0, 0.3, (rows, 1))
    c = -rng.uniform(0.0, 1.0, (rows, nf)) * scale
    c[:, 1] = -scale[:, 0]
    c[:, -1] = 0.0
    c = torch.tensor(c, dtype=dtype, device=device)
    xxxt = -0.999 / c[..., 1]
    return c, psi, xxxt, torch.full_like(xxxt, 10.0)


# --------------------------------------------------------------------------
# on the CPU
# --------------------------------------------------------------------------

def _refused(case):
    c, y, up = advect_inputs(0, 4, 20)
    cs, psi, xxxt, dt0 = split_inputs(0, 4, 20)
    return {
        "cpu tensors": lambda: sed_cuda.advsed(c, y, up),
        "cpu tensors, splits": lambda: sed_cuda.advsed_splits(
            cs, psi, xxxt, dt0, 8),
        "float16": lambda: sed_cuda.advsed(c.half(), y.half(), up),
        "mixed dtypes": lambda: sed_cuda.advsed(c.float(), y, up),
        "not contiguous": lambda: sed_cuda.advsed(c.t(), y.t(), up),
        "shapes differ": lambda: sed_cuda.advsed(c, y[:, 1:].contiguous(),
                                                 up),
        "two levels": lambda: sed_cuda.advsed(c[:, :2].contiguous(),
                                              y[:, :2].contiguous(), up),
        "upstream not bool": lambda: sed_cuda.advsed(c, y, up.double()),
        "upstream shape": lambda: sed_cuda.advsed(c, y, up[:2]),
        "xxxt shape": lambda: sed_cuda.advsed_splits(
            cs, psi, xxxt[:2], dt0, 8),
        "dt0 dtype": lambda: sed_cuda.advsed_splits(
            cs, psi, xxxt, dt0.float(), 8),
        "dt0 not contiguous": lambda: sed_cuda.advsed_splits(
            cs, psi, xxxt, torch.full((4, 2), 10.0, dtype=psi.dtype)[:, 0],
            8),
        "no split": lambda: sed_cuda.advsed_splits(cs, psi, xxxt, dt0, 0),
    }[case]


@pytest.mark.parametrize("case,error,match", [
    ("cpu tensors", ValueError, "CUDA tensors"),
    ("cpu tensors, splits", ValueError, "CUDA tensors"),
    ("float16", TypeError, "float32 or float64"),
    ("mixed dtypes", TypeError, "one dtype"),
    ("not contiguous", ValueError, "contiguous"),
    ("shapes differ", ValueError, "one shape"),
    ("two levels", ValueError, "nf=2"),
    ("upstream not bool", TypeError, "upstream must be torch.bool"),
    ("upstream shape", ValueError, "upstream must have shape"),
    ("xxxt shape", ValueError, "xxxt must have shape"),
    ("dt0 dtype", TypeError, "dt0 must be torch.float64"),
    ("dt0 not contiguous", ValueError, "dt0 must be contiguous"),
    ("no split", ValueError, "nsplit=0"),
])
def test_wrapper_refuses_what_the_kernel_does_not_take(case, error, match):
    sed_cuda.reset_counts()
    with pytest.raises(error, match=match):
        _refused(case)()
    assert sed_cuda.advsed.launches == sed_cuda.advsed_splits.launches == 0


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cpu_tensors_take_the_plain_path(dtype):
    c, y, up = advect_inputs(1, 40, 20, dtype)
    cs, psi, xxxt, dt0 = split_inputs(1, 40, 20, dtype)
    sed_cuda.reset_counts()
    assert torch.equal(sed.advsed(c, y, up),
                       torch.where(up[:, None], sed.advsed0(c, y),
                                   sed.advsed1(c, y)))
    got = sed.advsed1_splits(cs, psi, xxxt, dt0, SEDL_SPLITS)
    want = sed.advsed1_splits_plain(cs, psi, xxxt, dt0, SEDL_SPLITS)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert sed_cuda.advsed.launches == sed_cuda.advsed_splits.launches == 0


def test_splits_close_each_rows_budget():
    """What leaves a row's level 1 in the splits is its ground deposit:
    with the top level empty, levels 1..nf-2 plus ground keep the row's
    total; rows with more than 8 splits of work stop at 8."""
    c, psi, xxxt, dt0 = split_inputs(2, 64, 20)
    psi[:, -2:] = 0.0
    psi[:, 0] = psi[:, 1]
    out, ground = sed.advsed1_splits_plain(c, psi, xxxt, dt0, SEDL_SPLITS)
    before = psi[:, 1:-1].sum(1)
    after = out[:, 1:-1].sum(1) + ground
    assert torch.allclose(after, before, rtol=1e-12, atol=0.0)
    assert (ground > 0).any()
    assert (10.0 / xxxt > SEDL_SPLITS).any()


# --------------------------------------------------------------------------
# on a CUDA device: the hand-written kernel
# --------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device for the hand-written kernel")
    return torch.device("cuda")


def bits(x):
    return x.view({torch.float32: torch.int32,
                   torch.float64: torch.int64}[x.dtype])


def assert_bit_equal(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.equal(bits(got), bits(want)), \
        f"{int((bits(got) != bits(want)).sum())} values differ"


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nf", [100, 20])
# a row, a block and a row, sedp's rows of btz96.col1 (70 x 70) and of
# btz96.ens64 (64 x 70 x 70)
@pytest.mark.parametrize("rows", [1, 33, 4_900, 313_600])
@pytest.mark.parametrize("form", ["bott", "mixed"])
def test_kernel_matches_plain_on_card(cuda, dtype, nf, rows, form):
    """Bit-equal: the kernel repeats the plain version's operations in its
    order and rounding (no ulp bound needed)."""
    c, y, up = advect_inputs(rows + nf, rows, nf, dtype, cuda)
    if form == "bott":
        up = torch.zeros_like(up)
        got, want = sed_cuda.advsed(c, y, up), sed.advsed1(c, y)
    else:
        got = sed_cuda.advsed(c, y, up)
        want = torch.where(up[:, None], sed.advsed0(c, y), sed.advsed1(c, y))
    assert_bit_equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nf", [100, 20])
@pytest.mark.parametrize("rows", [1, 33, 4_900, 313_600])
@pytest.mark.parametrize("nsplit", [1, SEDL_SPLITS])
def test_splits_match_plain_on_card(cuda, dtype, nf, rows, nsplit):
    c, psi, xxxt, dt0 = split_inputs(rows + nf, rows, nf, dtype, cuda)
    got = sed_cuda.advsed_splits(c, psi, xxxt, dt0, nsplit)
    want = sed.advsed1_splits_plain(c, psi, xxxt, dt0, nsplit)
    for g, w in zip(got, want):
        assert_bit_equal(g, w)


def _model(tmp, device, dtype, multiphase, B=2):
    inp = tmp / "inp"
    inp.mkdir()
    write_synthetic_clarke_table(inp)
    write_synthetic_radiation_tables(inp)
    kw = dict(BTZ96, dtype=dtype, inpdir=str(inp))
    if multiphase:
        mech = tmp / "mech"
        mech.mkdir()
        write_synthetic_photolysis_tables(inp)
        write_synthetic_tot_mechanism(str(mech), 12, 25)
        kw.update(chem=True, nkc_l=4, mechdir=str(mech))
    model = pt.Model(pt.MistraConfig(grid=pt.GridParams(**TINY_GRID), **kw),
                     device=device)
    state = model.init_state(B)
    # the second column at noon
    tim = state.tim.replace(
        lst=torch.tensor([0, 12], dtype=torch.int32, device=device),
        lmin=torch.ones(B, dtype=torch.int32, device=device))
    return model, state.replace(tim=tim)


def _seeded(model, state, seed, top=None):
    """state with every aqueous species of every bin at random
    concentrations in [0, 1e-9) (zero from level top up, if given), and
    ff scaled by up to 2x either way so that sedp moves every bin."""
    drv = model._chemistry
    rng = np.random.default_rng(seed)
    conc = state.chem.conc.clone()
    aq = np.nonzero(np.asarray(drv.tot.species_bin) > 0)[0]
    vals = rng.random((conc.shape[0], aq.size, conc.shape[2])) * 1e-9
    if top is not None:
        vals[..., top:] = 0.0
    conc[:, aq] = torch.tensor(vals, dtype=conc.dtype, device=conc.device)
    ff = state.micro.ff * torch.tensor(
        rng.uniform(0.5, 2.0, tuple(state.micro.ff.shape)),
        dtype=conc.dtype, device=conc.device)
    return state.replace(chem=state.chem.replace(conc=conc),
                         micro=state.micro.replace(ff=ff))


def _plain_on_card(monkeypatch):
    """Route the kernel's wrappers to the plain versions, on CUDA tensors."""
    monkeypatch.setattr(sed_cuda, "advsed", lambda c, y, up: torch.where(
        up[..., None], sed.advsed0(c, y), sed.advsed1(c, y)))
    monkeypatch.setattr(sed_cuda, "advsed_splits",
                        sed.advsed1_splits_plain)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_sedp_and_sedl_through_kernel_match_plain_on_card(
        cuda, tmp_path, monkeypatch, dtype):
    model, state = _model(tmp_path, cuda, dtype, multiphase=True)
    state = _seeded(model, state, 5)
    sed_cuda.reset_counts()
    kp = sed.sedp(model, state, 10.0)
    kl = model._chemistry.sedl(state, 10.0)
    assert sed_cuda.advsed.launches >= 1
    assert sed_cuda.advsed_splits.launches == 1
    with monkeypatch.context() as m:
        _plain_on_card(m)
        pp = sed.sedp(model, state, 10.0)
        pl = model._chemistry.sedl(state, 10.0)
    for got, want in ((kp.micro.ff, pp.micro.ff),
                      (kp.micro.fsum, pp.micro.fsum),
                      (kp.surf.ajs, pp.surf.ajs), (kp.surf.ds1, pp.surf.ds1),
                      (kp.surf.ds2, pp.surf.ds2), (kl.conc, pl.conc)):
        assert_bit_equal(got, want)
    assert not torch.equal(kp.micro.ff, state.micro.ff)
    assert not torch.equal(kl.conc, state.chem.conc)


@pytest.mark.gpu
def test_sedl_closes_column_budget_on_card(cuda, tmp_path):
    """As on the CPU (test_torch_multiphase_slice.py): what leaves the
    column shows up in the ground reservoir, species by species."""
    model, state = _model(tmp_path, cuda, "float64", multiphase=True)
    drv = model._chemistry
    nf = model.cfg.grid.nf
    detw = model.atm.detw
    state = _seeded(model, state, 2, top=nf - 2)
    sed_cuda.reset_counts()
    out = drv.sedl(state, 10.0)
    assert sed_cuda.advsed_splits.launches == 1
    aq = np.nonzero(np.asarray(drv.tot.species_bin) > 0)[0]
    conc_b, conc_a = state.chem.conc[:, aq], out.conc[:, aq]
    col_b = conc_b[..., 1:nf - 1] @ detw[1:nf - 1]
    col_a = conc_a[..., 1:nf - 1] @ detw[1:nf - 1]
    resid = (col_b - col_a) - (conc_a[..., 0] - conc_b[..., 0])
    assert (resid.abs().max() / col_b.abs().max()).item() < 1e-12
    assert bool((conc_a[..., 0] > conc_b[..., 0]).any())


@pytest.mark.gpu
@pytest.mark.parametrize("multiphase", [False, True])
def test_minutes_reach_the_kernel(cuda, tmp_path, multiphase):
    """One launch per sedp pass (its host checks less one per call) and one
    per sedl call, in a BTZ96 and a multiphase minute on the card."""
    model, state = _model(tmp_path, cuda, "float32", multiphase)
    sed_cuda.reset_counts()
    profiling.reset()
    try:
        with profiling.tracing():
            model.minute_step(state)
            summary = profiling.summary()
    finally:
        profiling.reset()
    sedp = summary["sedp"]
    passes = sedp["counts"]["sync.sedp"] - sedp["calls"]
    assert sedp["calls"] == 6 and passes >= 6
    assert sed_cuda.advsed.launches == passes
    calls = summary["sedl"]["calls"] if multiphase else 0
    assert calls == (6 if multiphase else 0)
    assert sed_cuda.advsed_splits.launches == calls
