"""Shared helpers of the parity tests between the JAX package and its
PyTorch port (tests/test_torch_*.py).

Both packages are built on the same tiny grid from the same synthetic
``clarke.dat`` (the reference's input tables are not in the repository),
with radiation off, or on with the synthetic PIFM2 and Mie tables, and
with chemistry off, or on with the synthetic photolysis tables and a
small synthetic gas mechanism (chem=T, nkc_l=0) or tot mechanism (chem=T,
nkc_l=4, the multiphase driver); the JAX state and the
constants its init returns are carried across to the port with
``state_from_numpy``.  Inputs beyond the initial state are made with numpy
from a fixed seed.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

import mistra_tpu_torch as pt
from mistra_tpu.config import GridParams, MistraConfig
from mistra_tpu.model import Model as JaxModel
from mistra_tpu.radiation.driver import RadiationDriver as JaxRadiation
from mistra_tpu_torch.chemistry.mech import (write_synthetic_gas_mechanism,
                                             write_synthetic_tot_mechanism)
from mistra_tpu_torch.photolysis.tables import \
    write_synthetic_photolysis_tables
from mistra_tpu_torch.physics.surface import write_synthetic_clarke_table
from mistra_tpu_torch.radiation.tables import \
    write_synthetic_radiation_tables

# the suite runs in several worker processes at once, and each would start
# one torch thread per core: the cores are oversubscribed many times over,
# and the tiny grid's small ops run fastest on one thread in any case
# (the multiphase slice alone: 83 s with 8 threads, 52 s with 1)
torch.set_num_threads(1)

TINY_GRID = dict(nf=20, n_extra=10, nka=16, nkt=16, nb=8)
# BTZ96 radiation-fog configuration of __graft_entry__, with the inversion
# kept inside the tiny grid
BTZ96 = dict(chem=False, mic=True, tw=288.15, zinv=100.0, dtinv=7.0, ug=8.5,
             vg=0.0, nw_prof_opt=1, wmax=-0.005, z0=0.0001, alat=55.0)
# the port's column batch in the tests: two or more columns check that the
# batch axis carries independent columns
B = 2
# gas species of the small synthetic gas mechanism (plus its 7 binned het
# products): enough for every name the drivers look up, few enough that
# the JAX chemistry minute compiles in well under a minute
N_GAS = 20
# the small synthetic tot mechanism: the gas species through SO2 and DMS
# (the fewest the stand-in takes) and the 25 aqueous stems the drivers
# look up, in 4 bins: nvar 115, 458 reactions
N_GAS_TOT = 12
N_AQ_TOT = 25


def make_models(inpdir, dtype="float64", radiation=False, mechdir=None,
                multiphase=False, **cfg):
    """(JAX model, port model, JAX initial state) on the tiny grid, with
    radiation on in both or in neither.

    With radiation the synthetic PIFM2 and Mie tables go into inpdir too,
    and the JAX init's radiation call is made jitted: the JAX init makes
    it op by op, which takes ~40 s on a CPU for the same result (the call
    reads only the state that the rest of the init has made).

    With mechdir, both run the gas-phase chemistry (chem=True, nkc_l=0) of
    the small synthetic gas mechanism written there or, with multiphase,
    the multiphase chemistry (chem=True, nkc_l=4) of the small synthetic
    tot mechanism, and photolysis on the synthetic tables written to
    inpdir; the JAX init's photolysis call is jitted too, after its
    radiation call, as the JAX init orders them.  Further keywords go
    into both configurations.
    """
    write_synthetic_clarke_table(inpdir)
    if radiation:
        write_synthetic_radiation_tables(inpdir)
    kw = dict(BTZ96, dtype=dtype, inpdir=str(inpdir), **cfg)
    if mechdir is not None:
        write_synthetic_photolysis_tables(inpdir)
        if multiphase:
            write_synthetic_tot_mechanism(mechdir, N_GAS_TOT, N_AQ_TOT)
        else:
            write_synthetic_gas_mechanism(mechdir, N_GAS)
        kw = dict(kw, chem=True, nkc_l=4 if multiphase else 0,
                  mechdir=str(mechdir))
        kw.update(cfg)
    jm = JaxModel(MistraConfig(grid=GridParams(**TINY_GRID), **kw))
    jm.radiation_enabled = False
    js = jm.init_state()
    if radiation:
        jm.radiation_enabled = True
        jm._radiation = JaxRadiation(jm)
        jm._radiation.build_static(js)
        js = jax.jit(jm._radiation)(js)
    if radiation and mechdir is not None:
        from mistra_tpu.photolysis.jrates import PhotolysisDriver
        jm._photolysis = PhotolysisDriver(jm, jm._radiation)
        pj = jnp.where(js.rad.u0 > jm._chemistry.u0min,
                       jax.jit(jm._photolysis)(js), 0.0)
        js = js.replace(chem=js.chem.replace(photol_j=pj))
    tm = pt.Model(pt.MistraConfig(grid=pt.GridParams(**TINY_GRID), **kw),
                  device="cpu")
    tm.radiation_enabled = radiation
    tm.set_consts(jm.consts)
    return jm, tm, js


def to_numpy(js):
    return jax.tree.map(np.asarray, js)


def to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def to_port(js, columns=B):
    return pt.state_from_numpy(to_numpy(js), columns)


def to_port_columns(states):
    """One port state whose column c is the JAX state states[c]."""
    parts = [pt.state_from_numpy(to_numpy(s), 1) for s in states]

    def cat(objs):
        first = objs[0]
        if first is None:
            return None
        if torch.is_tensor(first):
            return torch.cat(objs, dim=0)
        return type(first)(**{f: cat([getattr(o, f) for o in objs])
                              for f in first.__dataclass_fields__})
    return cat(parts)


def column(x, c):
    """Column c of a port tensor, keeping the batch axis."""
    return x[c:c + 1]


def foggy(js, nf, seed=0):
    """A JAX state with droplets and supersaturated levels.

    Adds random droplet number densities in water bins >= 3 on levels
    1..nf, raises xm1 to 0.2-1.5 % supersaturation on levels 2..8 and
    jitters t by up to 0.3 K, so growth, sedimentation and the Newton
    loop all have work to do.
    """
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.array, js)
    met, mic = tree.met, tree.micro
    nkt, nka, n = mic.ff.shape
    add = rng.uniform(0.0, 1.0, (nkt, nka, n)) \
        * 10.0 ** rng.uniform(-4.0, 0.0, (nkt, nka, n))
    add[:3] = 0.0
    add[..., 0] = 0.0
    add[..., nf + 1:] = 0.0
    ff = mic.ff + add
    t = met.t + rng.uniform(-0.3, 0.3, n) * (np.arange(n) > 0)
    es = 610.7 * np.exp(17.15 * (t - 273.15) / (t - 38.33))
    qs = 0.62198 * es / (met.p - 0.37802 * es)
    lev = np.arange(n)
    sup = (lev >= 2) & (lev <= 8)
    xm1 = np.where(sup, qs * rng.uniform(1.002, 1.015, n), met.xm1)
    feu = xm1 * met.p / ((0.62198 + 0.37802 * xm1) * es)
    met = met.replace(t=t, talt=t, xm1=xm1, xm1a=xm1, feu=feu)
    mic = mic.replace(ff=ff, fsum=ff.sum(axis=(0, 1)))
    return to_jax(tree.replace(met=met, micro=mic))


# fields that are differences of order-one quantities: their rounding floor
# is that of the operands, not of the (possibly ~0) difference.  dfddt is a
# change of relative humidity (~1) over the 10-s substep.
FLOOR = {"dfddt": 0.1}


def field_err(want, got, floor=0.0) -> float:
    """max |got - want| over every column, relative to the larger of
    max |want| and floor."""
    a = np.asarray(want, dtype=np.float64)
    b = np.asarray(got.detach().cpu().numpy() if torch.is_tensor(got)
                   else got, dtype=np.float64)
    b = b.reshape((-1,) + a.shape)
    scale = max(np.abs(a).max() if a.size else 0.0, floor)
    diff = np.abs(b - a[None]).max() if a.size else 0.0
    if scale == 0.0:
        return float(diff)
    return float(diff / scale)


def assert_close(want, got, tol, what=""):
    """Every column of the port's got [B, ...] matches the JAX want [...]
    within tol of want's largest magnitude (or of the field's FLOOR)."""
    err = field_err(want, got, FLOOR.get(what.split(".")[-1], 0.0))
    assert err <= tol, f"{what}: relative error {err:.3e} > {tol:.1e}"


def assert_equal_int(want, got, what=""):
    a = np.asarray(want)
    b = got.detach().cpu().numpy().reshape((-1,) + a.shape)
    assert (b == a[None]).all(), f"{what}: {b} != {a}"


def assert_substate_close(want, got, tol, what=""):
    """Field-by-field comparison of one JAX sub-state and its port."""
    for name in got.__dataclass_fields__:
        g = getattr(got, name)
        w = getattr(want, name)
        if g.is_floating_point():
            assert_close(w, g, tol, f"{what}.{name}")
        else:
            assert_equal_int(w, g, f"{what}.{name}")


def assert_rows_close(want, got, tol, what=""):
    """Every column of the port's got [B, R, ...] matches the JAX want
    [R, ...] within tol of each row's largest magnitude over the levels
    and columns (a row that is zero everywhere must stay zero)."""
    a = np.asarray(want, dtype=np.float64)
    b = got.detach().cpu().numpy().astype(np.float64)
    b = b.reshape((-1,) + a.shape)
    scale = np.maximum(np.abs(a).reshape(a.shape[0], -1).max(1),
                       np.abs(b).reshape(b.shape[0], b.shape[1], -1)
                       .max(2).max(0))
    diff = np.abs(b - a[None]).reshape(b.shape[0], b.shape[1], -1).max(2)
    err = np.where(scale > 0.0, diff / np.where(scale > 0.0, scale, 1.0),
                   diff).max(0)
    worst = int(err.argmax())
    assert err[worst] <= tol, (f"{what}: row {worst} relative error "
                               f"{err[worst]:.3e} > {tol:.1e}")


def assert_chem_close(want, got, tol, what="chem"):
    """The chemistry state, gas-phase or multiphase: the concentrations
    (sgas, or conc through its sgas alias) and photol_j per row (species,
    J slot), vg per field; nonconv and the multiphase state's cloud flags
    exactly."""
    assert_rows_close(want.sgas, got.sgas, tol, f"{what}.sgas")
    assert_rows_close(want.photol_j, got.photol_j, tol, f"{what}.photol_j")
    assert_close(want.vg, got.vg, tol, f"{what}.vg")
    assert_equal_int(want.nonconv, got.nonconv, f"{what}.nonconv")
    if hasattr(got, "cloud"):
        assert_equal_int(want.cloud, got.cloud, f"{what}.cloud")


def assert_state_close(js, ts, tol):
    for sub in ("met", "turb", "surf", "micro", "rad", "tim"):
        assert_substate_close(getattr(js, sub), getattr(ts, sub), tol, sub)
    if getattr(js, "chem", None) is not None or ts.chem is not None:
        assert_chem_close(js.chem, ts.chem, tol)
