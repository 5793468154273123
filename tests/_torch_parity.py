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

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

import mistra_tpu_torch as pt
from mistra_tpu.config import GridParams, MistraConfig
from mistra_tpu.model import Model as JaxModel
from mistra_tpu.model import solar_zenith
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


def jax_init(jm, radiation, chem):
    """The JAX model's initial state, made as its ``init_state`` makes it
    but with the radiation call (and, with chem, the photolysis call after
    it) jitted: op by op the radiation call takes ~40 s on a CPU for the
    same result (it reads only the state that the rest of the init has
    made).  Installs the radiation and photolysis drivers in jm."""
    jm.radiation_enabled = False
    js = JaxModel.init_state(jm)
    if radiation:
        jm.radiation_enabled = True
        jm._radiation = JaxRadiation(jm)
        jm._radiation.build_static(js)
        js = jax.jit(jm._radiation)(js)
    if radiation and chem:
        from mistra_tpu.photolysis.jrates import PhotolysisDriver
        jm._photolysis = PhotolysisDriver(jm, jm._radiation)
        pj = jnp.where(js.rad.u0 > jm._chemistry.u0min,
                       jax.jit(jm._photolysis)(js), 0.0)
        js = js.replace(chem=js.chem.replace(photol_j=pj))
    return js


def configs(inpdir, dtype="float64", radiation=False, mechdir=None,
            multiphase=False, n_gas=N_GAS, **cfg):
    """(JAX config, port config) on the tiny grid, with the input tables
    (and with mechdir the mechanism) written as ``make_models`` says."""
    write_synthetic_clarke_table(inpdir)
    if radiation:
        write_synthetic_radiation_tables(inpdir)
    kw = dict(BTZ96, dtype=dtype, inpdir=str(inpdir), **cfg)
    if mechdir is not None:
        write_synthetic_photolysis_tables(inpdir)
        if multiphase:
            write_synthetic_tot_mechanism(mechdir, N_GAS_TOT, N_AQ_TOT)
        else:
            write_synthetic_gas_mechanism(mechdir, n_gas)
        kw = dict(kw, chem=True, nkc_l=4 if multiphase else 0,
                  mechdir=str(mechdir))
        kw.update(cfg)
    return (MistraConfig(grid=GridParams(**TINY_GRID), **kw),
            pt.MistraConfig(grid=pt.GridParams(**TINY_GRID), **kw))


def make_models(inpdir, dtype="float64", radiation=False, mechdir=None,
                multiphase=False, n_gas=N_GAS, **cfg):
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
    radiation call, as the JAX init orders them.  n_gas is the gas
    stand-in's number of gas species (41 or more include OIO).  Further
    keywords go into both configurations.
    """
    jcfg, tcfg = configs(inpdir, dtype, radiation, mechdir, multiphase,
                         n_gas, **cfg)
    jm = JaxModel(jcfg)
    js = jax_init(jm, radiation, mechdir is not None)
    tm = pt.Model(tcfg, device="cpu")
    tm.radiation_enabled = radiation
    tm.set_consts(jm.consts)
    return jm, tm, js


def make_box_models(inpdir, mechdir, multiphase=False, n_gas=N_GAS, **cfg):
    """(JAX BoxModel, port BoxModel, JAX initial box state) on the tiny
    grid with radiation and photolysis on and the chemistry of
    ``make_models``; the JAX box's column init is ``jax_init``.  In
    chamber mode the synthetic chamber.dat goes into inpdir/photolys: the
    JAX config names that directory in its ``cinpdir_phot`` attribute,
    the port finds it there by default."""
    from mistra_tpu.boxmodel import BoxModel as JaxBoxModel
    from mistra_tpu_torch.boxmodel import write_synthetic_chamber_dat
    jcfg, tcfg = configs(inpdir, "float64", True, mechdir, multiphase,
                         n_gas, **cfg)
    if jcfg.chamber:
        phot = f"{inpdir}/photolys"
        write_synthetic_chamber_dat(phot)
        jcfg.cinpdir_phot = phot
    jbm = JaxBoxModel(jcfg)
    jm = jbm.model
    jm.init_state = lambda: jax_init(jm, True, True)
    jbs = jbm.init_state()
    tbm = pt.BoxModel(tcfg, device="cpu")
    tbm.model.set_consts(jm.consts)
    return jbm, tbm, jbs


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


def at_noon(jm, js):
    """js at 12:00 local solar time with its u0 and, with photolysis, the
    J-rates the init would make."""
    tim = js.tim.replace(lst=jnp.int32(12))
    u0 = solar_zenith(tim.lst, tim.lmin, jm.astro.alat, jm.astro.declin)
    s = js.replace(tim=tim, rad=js.rad.replace(u0=u0))
    if jm._photolysis is None:
        return s
    pj = jnp.where(u0 > jm._chemistry.u0min, jax.jit(jm._photolysis)(s),
                   0.0)
    return s.replace(chem=s.chem.replace(photol_j=pj))


def step_both(jm, tm, js, minutes=2, tol=1e-6):
    """The port's batch of a noon and a midnight column and the two JAX
    states, each stepped ``minutes`` jitted JAX minutes and the port's
    batch as many port minutes; returns (JAX states, port start, port
    end) after checking every column against its JAX state within tol.
    In float64 each module matches JAX to 1e-10, and over whole minutes
    subkon's Newton exit test can flip within rounding and move the
    fields by up to ~1e-6 of their scale (test_torch_chem_slice.py)."""
    step = jax.jit(jm.minute_step)
    states = [at_noon(jm, js), js]
    ts0 = to_port_columns(states)
    ts = ts0
    for _ in range(minutes):
        states = [step(s) for s in states]
        ts = tm.minute_step(ts)
    for c, s in enumerate(states):
        assert_state_close(to_numpy(s), ts.map(lambda x: x[c:c + 1]), tol)
    return states, ts0, ts


@contextlib.contextmanager
def ros3_steps(*kernels):
    """Collects the Ros3 steps per cell of every integrate call of the
    kernels (JAX or port) into a list, one array per call: inside a
    jitted JAX function through a debug callback."""
    seen = []
    saved = [k.integrate for k in kernels]

    def spying(f):
        def spy(*a, **kw):
            y, info = f(*a, **kw)
            if isinstance(info["nsteps"], torch.Tensor):
                seen.append(info["nsteps"].numpy().copy())
            else:
                jax.debug.callback(lambda x: seen.append(np.asarray(x)),
                                   info["nsteps"])
            return y, info
        return spy

    for k, f in zip(kernels, saved):
        k.integrate = spying(f)
    try:
        yield seen
    finally:
        for k, f in zip(kernels, saved):
            k.integrate = f


def step_minutes(jbm, tbm, states, ts, jkern, tkern, minutes=2, tol=1e-6):
    """Steps each JAX state and the port's batch ``minutes`` minutes;
    checks every field and the Ros3 steps of every substep; returns the
    port's state."""
    step = jax.jit(jbm.minute_step)
    with ros3_steps(tkern) as tsteps:
        for _ in range(minutes):
            ts = tbm.minute_step(ts)
    # one spy for every JAX call: the compiled minute keeps the callback
    # of its first trace
    with ros3_steps(jkern) as jsteps:
        wants = []
        for s in states:
            for _ in range(minutes):
                s = step(s)
            wants.append(s)
        jax.effects_barrier()
    calls = 6 * minutes
    assert len(tsteps) == calls and len(jsteps) == calls * len(states)
    cells = tsteps[0].shape[0] // len(states)
    for c, s in enumerate(wants):
        assert_state_close(to_numpy(s), ts.map(lambda x: x[c:c + 1]),
                           tol)
        for j, t in zip(jsteps[c * calls:(c + 1) * calls], tsteps):
            assert np.array_equal(j, t[c * cells:(c + 1) * cells])
    return ts
