"""Spawned ranks of the port's ensemble-mesh tests (tp > 1).

Each rank is a fresh ``spawn`` process that imports torch and the port
only (never JAX): it joins a gloo process group through a ``file://``
init under the test's temporary directory, builds its ``Model`` on the
CPU with ``bins=mesh.bins(nka)``, takes its share of a global state
(``shard_state``), steps it and writes what the test compares into the
same directory.  ``spawn`` joins every rank with a deadline and raises
if one failed or is still running.
"""

from __future__ import annotations

import multiprocessing
import os
import sys
import time
import traceback

import numpy as np
import torch

import mistra_tpu_torch as pt
from mistra_tpu_torch.io.checkpoint import flatten_state
from mistra_tpu_torch.model import solar_zenith
from mistra_tpu_torch.parallel import mesh
from mistra_tpu_torch.physics import growth

# the collectives' timeout in a rank: a rank whose partner failed stops
# after this long
RANK_TIMEOUT_S = 60.0
# a gathered tp > 1 run against tp = 1: whole minutes within 1e-6 of
# each field's scale (the whole-minute tolerance of
# _torch_parity.step_both)
TOL = 1e-6
# fields that are differences of order-one quantities (as
# _torch_parity.FLOOR): their rounding floor is that of the operands
FLOOR = {"met.dfddt": 0.1}
# fields compared per row (species, J slot), each to its own scale
ROWS = ("chem.sgas", "chem.conc", "chem.photol_j")


def rel_errs(want: dict, got: dict) -> dict:
    """{path: max |got - want| relative to the field's largest |want|
    (per row for ROWS)}; integer fields must be equal (error 0 or
    inf)."""
    assert want.keys() == got.keys()
    out = {}
    for path, a in want.items():
        b = got[path]
        assert a.shape == b.shape and a.dtype == b.dtype, path
        if not a.is_floating_point():
            out[path] = 0.0 if torch.equal(a, b) else float("inf")
            continue
        a, b = a.double(), b.double()
        if path in ROWS:
            scale = a.abs().amax(dim=(0, 2))
            diff = (a - b).abs().amax(dim=(0, 2))
            out[path] = float(torch.where(
                scale > 0, diff / scale.clamp(min=1e-300), diff).max())
            continue
        scale = max(float(a.abs().max()), FLOOR.get(path, 0.0))
        diff = float((a - b).abs().max())
        out[path] = diff / scale if scale > 0 else diff
    return out


def check_close(want, got, record, what, tol=TOL):
    """Every field of got within tol of want (``rel_errs``); the largest
    difference recorded as the test property max_rel_err_<what>."""
    errs = rel_errs(want, got)
    worst = max(errs, key=errs.get)
    record(f"max_rel_err_{what}", f"{errs[worst]:.3e} ({worst})")
    print(f"{what}: largest difference {errs[worst]:.3e} of scale "
          f"({worst})")
    bad = {k: v for k, v in errs.items() if v > tol}
    assert not bad, f"{what}: {bad}"


def spawn(fn, world: int, tmpdir, job=None, timeout: float = 120.0):
    """fn(rank, world, job) in ``world`` spawned processes joined to one
    gloo group; returns each rank's result, in rank order.  The job goes
    to the ranks through a file (``torch.save``).  Raises if a rank
    failed, or is still running after ``timeout`` seconds (then killed)."""
    return join(start(fn, world, tmpdir, job, timeout))


def start(fn, world: int, tmpdir, job=None, timeout: float = 120.0):
    """``spawn``'s ranks started, for ``join`` to wait on: the caller can
    work meanwhile (the deadline counts from here)."""
    tmpdir = str(tmpdir)
    job_path = os.path.join(tmpdir, "job.pt")
    torch.save(job, job_path)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, tmpdir, job_path))
             for r in range(world)]
    for p in procs:
        p.start()
    return procs, tmpdir, time.monotonic() + timeout, timeout


def join(started):
    """Each rank's result of ``start``'s ranks, in rank order; raises as
    ``spawn`` does."""
    procs, tmpdir, deadline, timeout = started
    world = len(procs)
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    late = [r for r, p in enumerate(procs) if p.is_alive()]
    for r in late:
        procs[r].kill()
        procs[r].join(10.0)
    errors = []
    for r, p in enumerate(procs):
        path = os.path.join(tmpdir, f"rank{r}.err")
        if os.path.exists(path):
            with open(path) as f:
                errors.append(f"rank {r}:\n{f.read()}")
    if late:
        raise RuntimeError(f"ranks {late} still running after {timeout} s"
                           + "".join(errors))
    codes = [p.exitcode for p in procs]
    if any(codes):
        raise RuntimeError(f"rank exit codes {codes}\n" + "\n".join(errors))
    return [torch.load(os.path.join(tmpdir, f"rank{r}.pt"),
                       weights_only=False) for r in range(world)]


def _rank_main(fn, rank, world, tmpdir, job_path):
    import torch.distributed as dist
    torch.set_num_threads(1)
    try:
        job = torch.load(job_path, weights_only=False)
        if not mesh.init_distributed(f"file://{tmpdir}/init", world, rank,
                                     backend="gloo",
                                     timeout_s=RANK_TIMEOUT_S):
            raise RuntimeError("no process group")
        out = fn(rank, world, job)
        out["jax_imported"] = sorted(
            m for m in sys.modules
            if m == "jax" or m.startswith(("jax.", "mistra_tpu."))
            or m == "mistra_tpu")
        torch.save(out, os.path.join(tmpdir, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(tmpdir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def rank_join(rank, world, job):
    """What init_distributed and the process group say in a rank."""
    import torch.distributed as dist
    again = mesh.init_distributed(f"file://{job}/init", world, rank,
                                  backend="gloo")
    return {"rank": dist.get_rank(), "world": dist.get_world_size(),
            "backend": dist.get_backend(), "again": again}


def rank_host_mesh(rank, world, job):
    """This rank's host meshes of job["ranks_per_host"] ranks per host, at
    tp=2 and at tp=1: their shapes and indices, and the sum of the ranks'
    numbers over each one's tp group (through ``BinShard.sum_bins``);
    and the error of a host size that does not divide the world."""
    per_host = job["ranks_per_host"]
    out = {}
    for tp in (2, 1):
        m = mesh.make_host_mesh(tp=tp, ranks_per_host=per_host,
                                devices=["cpu"] * world)
        out[tp] = {"shape": m.shape, "index": (m.dp_index, m.tp_index),
                   "tp_sum": float(m.bins(16).sum_bins(
                       torch.tensor([float(rank)])))}
    try:
        mesh.make_host_mesh(tp=1, ranks_per_host=world - 1,
                            devices=["cpu"] * world)
    except ValueError as e:
        out["bad_host_size"] = str(e)
    return out


# --------------------------------------------------------------------------
# states and runs shared by the ranks and the tests' tp = 1 runs


def fog(state, nf, seed):
    """state with droplets and supersaturated levels in every column (a
    different draw per column): random droplet number densities in water
    bins >= 3 on levels 1..nf, xm1 at 0.2-1.5 % supersaturation on levels
    2..8, t jittered by up to 0.3 K, so growth, settling and the Newton
    loop all have work to do (the port's counterpart of
    ``_torch_parity.foggy``)."""
    rng = np.random.default_rng(seed)
    met, mic = state.met, state.micro
    B, nkt, nka, n = mic.ff.shape
    lev = np.arange(n)
    add = rng.uniform(0.0, 1.0, (B, nkt, nka, n)) \
        * 10.0 ** rng.uniform(-4.0, 0.0, (B, nkt, nka, n))
    add[:, :3] = 0.0
    add[..., 0] = 0.0
    add[..., nf + 1:] = 0.0
    ff = mic.ff + torch.from_numpy(add).to(mic.ff)
    t = met.t.numpy() + rng.uniform(-0.3, 0.3, (B, n)) * (lev > 0)
    p = met.p.numpy()
    es = 610.7 * np.exp(17.15 * (t - 273.15) / (t - 38.33))
    qs = 0.62198 * es / (p - 0.37802 * es)
    sup = (lev >= 2) & (lev <= 8)
    xm1 = np.where(sup, qs * rng.uniform(1.002, 1.015, (B, n)),
                   met.xm1.numpy())
    feu = xm1 * p / ((0.62198 + 0.37802 * xm1) * es)

    def tt(x):
        return torch.from_numpy(x).to(met.t)
    met = met.replace(t=tt(t), talt=tt(t), xm1=tt(xm1), xm1a=tt(xm1),
                      feu=tt(feu))
    mic = mic.replace(ff=ff, fsum=ff.sum(dim=(1, 2)))
    return state.replace(met=met, micro=mic)


def noon_and_midnight(model, state):
    """state with its first column at 12:00 local solar time (its u0 and,
    with photolysis, its J-rates made anew), the others as they are."""
    lst = state.tim.lst.clone()
    lst[0] = 12
    u0 = solar_zenith(lst, state.tim.lmin, model.astro.alat,
                      model.astro.declin, model.dtype)
    state = state.replace(tim=state.tim.replace(lst=lst),
                          rad=state.rad.replace(u0=u0))
    if model._photolysis is not None:
        state = model.photolysis_step(
            state, torch.ones_like(u0, dtype=torch.bool))
    return state


def start_state(cfg, radiation, B, seed):
    """(model, global start state) on the CPU: the port's initial state of
    B columns, fogged, the first column at noon."""
    model = pt.Model(cfg, device="cpu")
    model.radiation_enabled = radiation
    state = fog(model.init_state(B), cfg.grid.nf, seed)
    return model, noon_and_midnight(model, state)


def step_recording(model, step, state, minutes):
    """state after ``minutes`` of step(state), with subkon's Newton
    iterations per column and substep [substeps, B] and, with chemistry,
    the Ros3 steps per cell and call [calls, cells] of the gas kernel
    ("ros3") and of the multiphase driver's tot kernel ("ros3_tot")."""
    newton, ros3 = [], []
    subkon = growth.subkon

    def spy(*a, **kw):
        info = {}
        out = subkon(*a, info=info, **kw)
        newton.append(info["iterations"].clone())
        return out

    # the gas kernel, and the multiphase driver's tot kernel
    drv = model._chemistry
    kernels = {name: getattr(drv, name) for name in ("kernel", "tot_kernel")
               if drv is not None and hasattr(drv, name)}
    seen = {name: [] for name in kernels}
    saved = {name: k.integrate for name, k in kernels.items()}

    def spying(name):
        def spy_integrate(*a, **kw):
            y, info = saved[name](*a, **kw)
            seen[name].append(info["nsteps"].clone())
            return y, info
        return spy_integrate
    for name, k in kernels.items():
        k.integrate = spying(name)
    growth.subkon = spy
    try:
        for _ in range(minutes):
            state = step(state)
    finally:
        growth.subkon = subkon
        for name, k in kernels.items():
            k.integrate = saved[name]

    def stacked(xs):
        return torch.stack(xs) if xs else None
    return state, {"newton": stacked(newton),
                   "ros3": stacked(seen.get("kernel", [])),
                   "ros3_tot": stacked(seen.get("tot_kernel", []))}


def rank_minutes(rank, world, job):
    """This rank's share of job["state"] (a flattened global state) on a
    (world / tp, tp) mesh, stepped job["minutes"] minutes of a Model of
    job["cfg"] (radiation as job["radiation"]; job["consts"], where given,
    installed after its init); returns its share, the gathered global
    state (rank 0), its Newton and Ros3 counts and its all_reduce
    calls."""
    tp = job["tp"]
    m = mesh.make_mesh(tp=tp, devices=["cpu"] * world)
    cfg = job["cfg"]
    model = pt.Model(cfg, device="cpu", bins=m.bins(cfg.grid.nka))
    model.radiation_enabled = job["radiation"]
    template = model.init_state(1)
    if job.get("consts"):
        model.set_consts(job["consts"])
    flat = job["state"]
    local = mesh.shard_state(template.map_paths(lambda p, _x: flat[p]), m)
    step = mesh.make_ensemble_step(model, m)
    local, counts = step_recording(model, step, local, job["minutes"])
    gathered = mesh.gather_state(local, m)
    return {"rank": rank, "dp_index": m.dp_index, "tp_index": m.tp_index,
            "bins": (model.bins.lo, model.bins.hi),
            "local": flatten_state(local),
            "gathered": flatten_state(gathered) if rank == 0 else None,
            "allreduce_calls": model.bins.calls, **counts}


def rank_subkon_skewed(rank, world, job):
    """subkon on this rank's share of job["state"] at tp = world, the
    replicated temperature of rank r shifted by r * job["t_skew"] kelvin
    (as if the ranks' replicated fields had drifted apart), then one more
    sum over the bins; returns the Newton iterations per column, that sum
    and the all_reduce calls."""
    m = mesh.make_mesh(tp=world, devices=["cpu"] * world)
    cfg = job["cfg"]
    model = pt.Model(cfg, device="cpu", bins=m.bins(cfg.grid.nka))
    model.radiation_enabled = False
    template = model.init_state(1)
    flat = job["state"]
    state = mesh.shard_state(template.map_paths(lambda p, _x: flat[p]), m)
    model.bins.reset_counts()
    met = state.met
    lo, hi = 1, cfg.grid.nf + 1
    info = {}
    growth.subkon(
        10.0, state.micro.ff[..., lo:hi].permute(0, 3, 1, 2),
        state.rad.totrad.transpose(1, 2)[:, lo:hi], met.dfddt[:, lo:hi],
        met.feu[:, lo:hi], met.p[:, lo:hi], met.talt[:, lo:hi],
        met.t[:, lo:hi] + rank * job["t_skew"], met.xm1a[:, lo:hi],
        met.xm1[:, lo:hi],
        torch.zeros((cfg.grid.mb, cfg.grid.nkt, model.bins.width),
                    dtype=met.t.dtype),
        (model.consts["a0m"], model.b0m), model.micro, bins=model.bins,
        info=info)
    after = model.bins.sum_bins(torch.ones(3, dtype=torch.float64))
    return {"iterations": info["iterations"], "after": after,
            "allreduce_calls": model.bins.calls}



# --------------------------------------------------------------------------
# the chemistry paths at tp > 1 (test_torch_mesh_tp_chem.py): the same
# runs in the parent at tp = 1 and in every rank


def build(cfg, radiation, bins=None):
    """(Model, stepper) on the CPU: the stepper is the ``BoxModel`` of a
    box or chamber configuration (which owns the Model), else the
    Model."""
    if cfg.box or cfg.chamber:
        box = pt.BoxModel(cfg, device="cpu", bins=bins)
        box.model.radiation_enabled = radiation
        return box.model, box
    model = pt.Model(cfg, device="cpu", bins=bins)
    model.radiation_enabled = radiation
    return model, model


def run_group(group, m=None, built=None):
    """The runs of one configuration from one global start state: in a
    rank of mesh m on its share, or (m None) at tp = 1 on the whole
    state.  group: {"cfg", "radiation", "state" (flattened), "runs":
    {name: extra}}, the runs among

    - "feedback": the mass feedback once, extra the conc before the
      chemistry [B, nvar, n]; also how much of each call's contribution
      went to bins outside this rank's ("sent");
    - "konc": konc once, extra ff after kon (the whole axis; this rank's
      bins are taken);
    - "nucleation": one 10-s nucleation step; also the largest change of
      this rank's ff;
    - "minute": extra minutes of the ensemble step with the Newton and
      Ros3 counts.

    Each run returns its end state (flattened: this rank's share "local"
    and, gathered, the global "state"), its all_reduce calls and
    bytes.  ``built``: the (Model, stepper, start state) to run at tp =
    1, the model's init made (``start_group``)."""
    if built is None:
        cfg = group["cfg"]
        bins = m.bins(cfg.grid.nka) if m is not None else None
        model, stepper = build(cfg, group["radiation"], bins)
        flat = group["state"]
        start = stepper.init_state(1).map_paths(lambda p, _x: flat[p])
    else:
        model, stepper, start = built
    local = start if m is None else mesh.shard_state(start, m)
    drv, b = model._chemistry, model.bins

    def done(state, **extra):
        return {"local": flatten_state(state),
                "state": flatten_state(state) if m is None
                else flatten_state(mesh.gather_state(state, m)),
                "allreduce_calls": b.calls, "allreduce_bytes": b.bytes,
                **extra}

    out = {}
    for name, extra in group["runs"].items():
        b.reset_counts()
        if name == "feedback":
            sent, home = [], b.reduce_home
            others = torch.ones(b.nka, dtype=torch.bool)
            others[b.lo:b.hi] = False
            others = torch.nonzero(others)[:, 0]

            def spy(x, dim):
                sent.append(float(x.index_select(dim, others).sum()))
                return home(x, dim)
            b.reduce_home = spy
            try:
                state = drv.aerosol_mass_feedback(local, extra)
            finally:
                b.reduce_home = home
            out[name] = done(state, sent=sent)
        elif name == "konc":
            chem = drv.konc(local.chem, local.micro.ff, b.take(extra, 2))
            out[name] = done(local.replace(chem=chem))
        elif name == "nucleation":
            state, _ = model._nucleation(local, 10.0)
            out[name] = done(state, ff_change=float(
                (state.micro.ff - local.micro.ff).abs().max()))
        elif name == "minute":
            step = stepper.minute_step if m is None \
                else mesh.make_ensemble_step(stepper, m)
            state, counts = step_recording(model, step, local, extra)
            out[name] = done(state, nonconv=state.chem.nonconv, **counts)
        else:
            raise ValueError(f"no run {name!r}")
    return out


def start_group(cfg, radiation, B, seed, vapors=None, time_s=None):
    """(Model, stepper, global start state) at tp = 1 on the CPU: the
    port's initial state of B columns (boxes), fogged, the first at
    noon; vapors {name: mol/m3}, where given, set in the concentrations
    at 0.1-10 x their value (a seeded draw per level); time_s, where
    given, the clock's seconds."""
    model, stepper = build(cfg, radiation)
    state = noon_and_midnight(model, fog(stepper.init_state(B),
                                         cfg.grid.nf, seed))
    if vapors:
        drv = model._chemistry
        rng = np.random.default_rng(seed)
        conc = getattr(state.chem, drv.conc_name).clone()
        for name, val in vapors.items():
            conc[:, drv.conc_n2i[name]] = val * torch.from_numpy(
                10.0 ** rng.uniform(-1.0, 1.0, conc.shape[::2])).to(conc)
        state = state.replace(chem=state.chem.replace(
            **{drv.conc_name: conc}))
    if time_s is not None:
        state = state.replace(tim=state.tim.replace(
            time=torch.full_like(state.tim.time, time_s)))
    return model, stepper, state


def rank_groups(rank, world, job):
    """``run_group`` of each of job["groups"] in this rank of a (world /
    tp, tp) mesh, tp = job["tp"]; rank 0 keeps the gathered states."""
    m = mesh.make_mesh(tp=job["tp"], devices=["cpu"] * world)
    groups = {}
    for key, group in job["groups"].items():
        runs = run_group(group, m)
        if rank != 0:
            for run in runs.values():
                run["state"] = None
        groups[key] = runs
    nka = next(iter(job["groups"].values()))["cfg"].grid.nka
    return {"rank": rank, "dp_index": m.dp_index, "tp_index": m.tp_index,
            "bins": (m.bins(nka).lo, m.bins(nka).hi), "groups": groups}
