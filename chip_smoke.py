"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. device: requires CUDA, prints the card and its power limit, builds the
     CUDA kernels of mistra_tpu_torch/csrc with nvcc;
  2. kernels against their plain torch versions on the card, at the
     production shape (100 levels x 70 dry bins rows of 70 bins per
     column), float64 and float32, walk band J in {32, 70}; times both
     and sets each time beside its bound (the least time the card could
     take: bytes over the memory rate against operations over the peak
     rate, the larger of the two);
  3. main path: the BTZ96 minute step (mic=T, chem=F, PIFM2 radiation on)
     at the production grid in float32 for 64 columns, three minutes, with
     the kernels' launch counters read around them; then the radiation
     call alone (host clock around synchronised calls, launches per call
     from torch.profiler) and one minute under torch.profiler, with its
     device time by kernel (key_averages); then both Bott kernels timed on
     the rows of one more minute's first launches;
  4. the same port on the card (kernels) against the port on the CPU
     (plain versions): two columns, one at 00:00 and one at 12:00,
     float64, one minute, radiation fields included;
  4b. radiation alone: nstrahl on the card against the CPU at the
     production nrlay, a noon and a midnight column, float64 and float32;
  5. the batched-inverse kernel against its plain torch version on the
     card, float64 and float32, at the stiff chemistry solve's shapes for
     2048 cells ([8192, 80, 80] aqueous blocks, [2048, 101, 101] Schur
     complements): equilibrated stage matrices of the tot-shaped
     mechanism, a diagonally dominant batch and a batch that needs
     pivoting; times both and torch.linalg.inv beside them, and sets
     each time beside its bound;
  6. chemistry path: GasKernel.integrate (Ros3, block-arrow solver) for
     2048 cells in float64, one warm 10-s substep and timed substeps, with
     the inverse kernel's launch counter read around it;
  7. the chemistry path on the card against the CPU: 16 cells, float64,
     one substep.

The input tables of phases 3-4b are the reference's where $INPDIR holds
them (clarke.dat; pifm2_171115.dat with the six Mie files), else synthetic
stand-ins (write_synthetic_clarke_table, write_synthetic_radiation_tables;
not the reference's values).  The mechanism of phases 5-7 is the
reference's tot mechanism when $MECHDIR holds master_gas.eqn and
master_aqueous.eqn, else a synthetic stand-in of its block shape
(mistra_tpu_torch.chemistry.mech.write_synthetic_multiphase_mechanism; not
the reference's chemistry).

The last two lines are a JSON object of per-kernel results and the
device line {"ok": true, "device": {...}}.  Imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# BTZ96 radiation-fog configuration of the flagship entry point
BTZ96 = dict(chem=False, mic=True, tw=288.15, zinv=800.0, dtinv=7.0, ug=8.5,
             vg=0.0, nw_prof_opt=1, wmax=-0.005, z0=0.0001, alat=55.0)
MAIN_COLUMNS = 64
MAIN_MINUTES = 3
CMP_COLUMNS = 4
DT = 10.0
RAD_REPS = 5
# the model grid of phases 3-4b: None is GridParams(), the production grid
GRID = None

# kernel against plain, on one card, same inputs.  The kernels do the plain
# version's arithmetic expression by expression (no contracted multiply-
# adds); what differs is the order of the row reductions.  The error is
# taken relative to the row's largest bin (advect) or, for dwsum, a
# difference of gained and lost water mass, to the sum of the magnitudes
# it is made of, sum_k (|psi_k| + |z_k|) e_k.
KERNEL_TOL = {torch.float64: 1e-9, torch.float32: 1e-4}
# advect conserves each row's mass of significant bins
MASS_TOL = {torch.float64: 1e-12, torch.float32: 2e-5}
# card against CPU, two columns, float64, one minute: relative to each
# field's largest magnitude.  Libm and reduction order differ between the
# devices; a flip of one Newton convergence test (|res| < 1e-6) moves the
# mean saturation by ~1e-6, which bounds what t, xm1 and ff can move by.
# The radiation call after the minute sees those states: t moved by 1e-6
# moves the Planck fluxes (T^4) by 4e-6, hence sk, sl and the band sums of
# totrad; the heating rate, a layer difference of net fluxes ~400x its
# size, by up to ~2e-3 of its scale.
DEVICE_TOL = {"t": 1e-6, "xm1": 1e-6, "ff": 1e-5, "dtrad": 2e-3,
              "totrad": 1e-4, "sk": 1e-5, "sl": 1e-5}
# nstrahl alone, card against CPU on the same inputs, relative to each
# output's largest magnitude.  float64: libm differs by ulps, which the
# heating rate's difference of fluxes (~400x) and the cancelling a6 of
# the IR coefficients (~1e-6 relative at dtau ~1e-7) lift to <= ~1e-10.
# float32: the solve's own float32 error against float64 on the same
# inputs (tiny grid, CPU) is hr 3.2e-4, totrad 1.5e-3, fnseb 5.5e-7,
# flgeg 1.3e-3 of the scale (cancellations such as the a6 above, in
# float32); two devices' float32 results differ by up to about as much
RAD_TOL = {torch.float64: {"hr": 1e-9, "totrad": 1e-9, "fnseb": 1e-9,
                           "flgeg": 1e-9},
           torch.float32: {"hr": 3e-3, "totrad": 3e-3, "fnseb": 1e-4,
                           "flgeg": 3e-3}}

# the card's peak rates for bound_ms (H100 SXM data sheet, at 700 W): HBM
# bytes per second; operations per second of float32 outside the tensor
# cores, and of float64 at the tensor cores' rate (DMMA), its highest
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.float32: 67e12, torch.float64: 67e12}
# operations of the Bott kernels: a divide and an add per bin and
# direction for the prefix sums, and about 100 per significant source bin
# for the searched walk (~30) and the order-4 Bott split (~70); the
# deposit's few compares and adds per bin are left out (a lower bound)
BOTT_SCAN_OPS_PER_BIN = 4
BOTT_OPS_PER_SOURCE = 100

# stiff chemistry solve (phases 5-7)
DEVICE = "cuda"
CHEM_CELLS = 2048
CHEM_DT = 10.0
CHEM_TIMED = 3
CHEM_CMP_CELLS = 16
# batched inverse, kernel against plain on one card, same inputs: the same
# operations in the same order (no contracted multiply-adds), so they agree
# up to a differing rounding of the two compilers; relative to the largest
# entry of the inverse
LU_TOL = {torch.float64: 1e-12, torch.float32: 1e-5}
# normwise residual ||A X - I|| / (||A|| ||X||) (infinity norms) of a
# pivoted elimination is a few m * eps: at most 1.8 m eps on the float32
# aqueous stage blocks, 0.2 m eps in float64 (plain version, CPU); the
# bound leaves a margin of ~9
LU_RES_FACTOR = 16
# card against CPU, chemistry path, 16 cells, float64, one 10-s substep:
# relative to each species' largest |y| over the cells.  Both runs hold
# every step's local error under rtol = 1e-3 of |y|; runs that differ only
# by rounding agree far closer while they take the same steps, and stay
# within ~rtol of each other where an accept/reject decision flips
CHEM_DEVICE_TOL = 1e-3


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok, msg) -> None:
    """Fail the run (an assert would vanish under python -O)."""
    if not ok:
        raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of fn() in ms, by CUDA events around reps calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def bott_inputs(rows: int, nkt: int, dtype, seed: int):
    """Mixed-sign velocities with zeros, fast rows (|u| >> 1, walks beyond
    the band) and slow rows; sparse positive spectra with sub-YMIN bins."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(-3.0, 3.0, (rows, nkt))
    u[rng.uniform(size=u.shape) < 0.15] = 0.0
    fast = rng.uniform(size=rows) < 0.05
    u[fast] = rng.choice([-1.0, 1.0], (int(fast.sum()), 1)) \
        * rng.uniform(5.0, 40.0, (int(fast.sum()), nkt))
    slow = rng.uniform(size=rows) < 0.05
    u[slow] *= 1e-6
    z = rng.lognormal(0.0, 2.0, (rows, nkt))
    z[rng.uniform(size=z.shape) < 0.3] = 0.0
    z[rng.uniform(size=z.shape) < 0.02] = 1e-35
    e = np.exp(np.linspace(-20.0, 8.0, nkt))
    dev = torch.device("cuda")
    return (torch.tensor(u, dtype=dtype, device=dev),
            torch.tensor(z, dtype=dtype, device=dev),
            torch.tensor(e, dtype=dtype, device=dev))


def bound(nbytes: float, ops: float, dtype) -> dict:
    """bound_ms (the larger of bytes over the memory rate and operations
    over the dtype's peak rate) and what bounds it."""
    by_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    by_ops = 1e3 * ops / PEAK_OPS_PER_S[dtype]
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def bott_bounds(u, z) -> dict:
    """bound of each Bott kernel on these inputs: advect reads u, z and
    writes psi; dwsum reads u, z and e and writes one value per row."""
    rows, nkt = z.shape
    elt = z.element_size()
    ops = (BOTT_SCAN_OPS_PER_BIN * z.numel()
           + BOTT_OPS_PER_SOURCE * int((z >= 1e-32).sum()))
    return {"bott_advect": bound(3 * z.numel() * elt, ops, z.dtype),
            "bott_dwsum": bound((2 * z.numel() + nkt + rows) * elt, ops,
                                z.dtype)}


def dwsum_scale(psi, z, e):
    """Per-row magnitude of the terms of dwsum: sum_k (|psi_k|+|z_k|) e_k."""
    return ((psi.abs() + z.abs()) * e).sum(dim=1).clamp(min=1e-300)


def compare_kernels(growth, bott_cuda, rows, dtype, J, seed, plain_reps):
    """Both kernels against their plain versions on one input of rows x 70
    bins: checks agreement and advect's mass, times both (CUDA events)
    and returns each kernel's result fields."""
    nkt = 70
    u, z, e = bott_inputs(rows, nkt, dtype, seed)
    zmax = z.abs().amax(dim=1, keepdim=True).clamp(min=1e-300)

    psi_k = bott_cuda.bott_advect(DT, u, z, J)
    psi_p = growth.bott_advect_plain(DT, u, z, J)
    rel_a = ((psi_k - psi_p).abs() / zmax).max().item()
    sig = torch.where(z >= growth.YMIN, z, 0.0).sum(dim=1)
    mass = ((psi_k.sum(dim=1) - sig).abs()
            / sig.clamp(min=1e-300)).max().item()
    dw_k = bott_cuda.bott_dwsum(DT, u, z, e, J)
    dw_p = growth.bott_dwsum_plain(DT, u, z, e, J)
    rel_d = ((dw_k - dw_p).abs() / dwsum_scale(psi_p, z, e)).max().item()

    tol = KERNEL_TOL[dtype]
    shape = f"{rows}x{nkt} {str(dtype).replace('torch.', '')} J={J}"
    bounds = bott_bounds(u, z)
    out = {
        "bott_advect": dict(
            max_abs_err=(psi_k - psi_p).abs().max().item(), rel_err=rel_a,
            tol=tol, shape=shape,
            ms=cuda_ms(lambda: bott_cuda.bott_advect(DT, u, z, J), 20),
            plain_ms=cuda_ms(lambda: growth.bott_advect_plain(DT, u, z, J),
                             plain_reps),
            library_ms=None, **bounds["bott_advect"]),
        "bott_dwsum": dict(
            max_abs_err=(dw_k - dw_p).abs().max().item(), rel_err=rel_d,
            tol=tol, shape=shape,
            ms=cuda_ms(lambda: bott_cuda.bott_dwsum(DT, u, z, e, J), 20),
            plain_ms=cuda_ms(
                lambda: growth.bott_dwsum_plain(DT, u, z, e, J),
                plain_reps),
            library_ms=None, **bounds["bott_dwsum"]),
    }
    for r in out.values():
        r["roofline_share"] = r["bound_ms"] / r["ms"]
    log(f"kernels {shape}: " + "; ".join(
        f"{k} err {r['max_abs_err']:.3e} (rel {r['rel_err']:.3e}) "
        f"{r['ms'] * 1e3:.1f} us vs plain {r['plain_ms'] * 1e3:.1f} us, "
        f"bound {r['bound_ms'] * 1e3:.1f} us ({r['bound_by']}, "
        f"{100.0 * r['roofline_share']:.1f} %)"
        for k, r in out.items()) + f"; advect mass {mass:.3e}")
    check(rel_a <= tol, f"advect disagrees: {rel_a} > {tol}")
    check(rel_d <= tol, f"dwsum disagrees: {rel_d} > {tol}")
    check(mass <= MASS_TOL[dtype], f"advect mass error {mass}")
    return out


def phase_kernels(growth, bott_cuda):
    """Kernel against plain on the card, at each dtype and band for a few
    columns, then at the main path's shape, dtype and band (64 columns,
    float32, J = 32), whose fields go into the JSON line."""
    for dtype in (torch.float64, torch.float32):
        for J in (32, 70):
            compare_kernels(growth, bott_cuda, CMP_COLUMNS * 100 * 70, dtype,
                            J, seed=J, plain_reps=5)
    return compare_kernels(growth, bott_cuda, MAIN_COLUMNS * 100 * 70,
                           torch.float32, growth.BAND, seed=1, plain_reps=3)


def input_dir(tmp: str) -> str:
    """tmp, holding the input tables of the BTZ96 step: links to INPDIR's
    reference tables where it holds them, else the synthetic stand-ins
    (clarke.dat; pifm2_171115.dat with the six Mie files)."""
    from mistra_tpu_torch.physics.surface import write_synthetic_clarke_table
    from mistra_tpu_torch.radiation.tables import (
        MIE_FILES, PIFM2_FILE, write_synthetic_radiation_tables)
    inpdir = os.environ.get("INPDIR")
    for label, files, write in (
            ("clarke.dat", ("clarke.dat",), write_synthetic_clarke_table),
            ("radiation tables", (PIFM2_FILE,) + MIE_FILES,
             write_synthetic_radiation_tables)):
        if inpdir and all(os.path.exists(os.path.join(inpdir, f))
                          for f in files):
            for f in files:
                os.symlink(os.path.abspath(os.path.join(inpdir, f)),
                           os.path.join(tmp, f))
            log(f"{label}: reference tables from INPDIR ({inpdir})")
        else:
            write(tmp)
            log(f"{label}: synthetic stand-in (INPDIR lacks "
                f"{', '.join(files)})")
    return tmp


def model_config(inpdir, dtype):
    from mistra_tpu_torch import GridParams, MistraConfig
    return MistraConfig(grid=GRID or GridParams(), dtype=dtype,
                        inpdir=inpdir, **BTZ96)


def count_launches(fn):
    """(device events, aten ops) of one fn(): the kernels and copies the
    card ran, from torch.profiler (None if it recorded no device events),
    and the operators the host dispatched."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    dev = sum(1 for e in events if e.device_type == DeviceType.CUDA)
    ops = sum(1 for e in events if e.device_type == DeviceType.CPU
              and e.name.startswith("aten::"))
    return (dev or None), ops


def device_time_by_kernel(prof, top: int = 10) -> list:
    """[(kernel, launches, device ms)] of the top kernels by device time
    in prof, from key_averages."""
    from torch.autograd import DeviceType
    rows = [(e.key, e.count, e.self_device_time_total * 1e-3)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    return sorted(rows, key=lambda r: -r[2])[:top]


def profile_minute(model, state):
    """One minute step under torch.profiler: (state, wall s, device busy
    s, device events, top kernels by device time); busy is the union of
    the kernels' intervals."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state = model.minute_step(state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return state, wall, busy * 1e-6, len(spans), device_time_by_kernel(prof)


def main_path_rows(model, state, growth, bott_cuda):
    """One more minute step, keeping the inputs of its first dwsum and
    advect launches: what the main path's rows look like (significant
    bins, walk directions, the deposit's reach) and both kernels' time on
    them, with dwsum on the same rows emptied (no significant bin: loads
    and reduction only) as the floor of its time."""
    kept = {}
    dwsum, advect = growth.bott_dwsum, growth.bott_bin_advection

    def keep_dwsum(dt, u, z, e, band=growth.BAND):
        kept.setdefault("dwsum", (dt, u.clone(), z.clone(), e, band))
        return dwsum(dt, u, z, e, band)

    def keep_advect(dt, u, z, band=growth.BAND):
        kept.setdefault("advect", (dt, u.clone(), z.clone(), band))
        return advect(dt, u, z, band)

    growth.bott_dwsum, growth.bott_bin_advection = keep_dwsum, keep_advect
    try:
        model.minute_step(state)
    finally:
        growth.bott_dwsum, growth.bott_bin_advection = dwsum, advect
    dt, u, z, e, J = kept["dwsum"]
    nkt = z.shape[-1]
    u, z = u.reshape(-1, nkt), z.reshape(-1, nkt)
    sig = z >= growth.YMIN
    k_low, k_high, _, _ = growth._bott_split(dt, u, z, J)
    i = torch.arange(nkt, device=z.device)
    reach = torch.where(sig, torch.maximum((k_low - i).abs(),
                                           (k_high - i).abs()), 0).amax(1)
    both = (sig & (u > 0)).any(1) & (sig & (u < 0)).any(1)
    dt_a, u_a, z_a, J_a = kept["advect"]
    out = {"rows": z.shape[0],
           "rows_with_significant_bin": sig.any(1).float().mean().item(),
           "significant_bins_per_row": sig.sum(1).float().mean().item(),
           "rows_walking_both_ways": both.float().mean().item(),
           "mean_reach": reach.float().mean().item(),
           "dwsum_ms": cuda_ms(
               lambda: bott_cuda.bott_dwsum(dt, u, z, e, J), 20),
           "dwsum_empty_rows_ms": cuda_ms(
               lambda: bott_cuda.bott_dwsum(dt, u, torch.zeros_like(z), e,
                                            J), 20),
           "advect_ms": cuda_ms(
               lambda: bott_cuda.bott_advect(dt_a, u_a, z_a, J_a), 20)}
    log(f"main-path rows ({out['rows']} rows of {nkt} bins, float32): "
        f"{100.0 * out['rows_with_significant_bin']:.1f} % with a "
        f"significant bin, {out['significant_bins_per_row']:.2f} "
        f"significant bins per row, "
        f"{100.0 * out['rows_walking_both_ways']:.1f} % walking both ways, "
        f"mean reach {out['mean_reach']:.2f} bins; dwsum "
        f"{out['dwsum_ms']:.4f} ms (the same rows emptied "
        f"{out['dwsum_empty_rows_ms']:.4f} ms), advect "
        f"{out['advect_ms']:.4f} ms")
    return out


def phase_main(inpdir, bott_cuda):
    """The BTZ96 minute step on the card; returns the launch counts."""
    from mistra_tpu_torch import Model
    cfg = model_config(inpdir, "float32")
    model = Model(cfg, device=DEVICE)
    state = model.init_state(MAIN_COLUMNS)
    check(model._radiation is not None, "no radiation driver")
    torch.cuda.synchronize()
    t_start = state.tim.time.clone()

    bott_cuda.reset_counts()
    times = []
    for _ in range(MAIN_MINUTES):
        t0 = time.perf_counter()
        state = model.minute_step(state)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    counts = {"bott_dwsum": bott_cuda.bott_dwsum.launches,
              "bott_advect": bott_cuda.bott_advect.launches}

    gp = cfg.grid
    for sub in ("met", "turb", "surf", "micro"):
        for name, x in vars(getattr(state, sub)).items():
            if x.is_floating_point():
                check(bool(torch.isfinite(x).all()),
                      f"non-finite {sub}.{name}")
    shape = tuple(state.micro.ff.shape)
    check(shape == (MAIN_COLUMNS, gp.nkt, gp.nka, gp.n), f"ff shape {shape}")
    advanced = (state.tim.time - t_start).cpu().numpy()
    check(np.all(advanced == 60.0 * MAIN_MINUTES), f"clock {advanced}")
    check(bool((state.tim.lmin == MAIN_MINUTES).all()), "minute counter")
    # every substep runs at least one Newton iteration and one replay
    check(counts["bott_dwsum"] >= 6 * MAIN_MINUTES, f"launches {counts}")
    check(counts["bott_advect"] == 6 * MAIN_MINUTES, f"launches {counts}")

    for name in ("dtrad", "totrad", "sk", "sl"):
        x = getattr(state.rad, name)
        check(bool(torch.isfinite(x).all()), f"non-finite rad.{name}")
    check(bool((state.rad.dtrad != 0).any()), "radiation left dtrad zero")

    steady = times[1:] if len(times) > 1 else times
    ms = 1e3 * sum(steady) / len(steady)
    log(f"main path: {MAIN_COLUMNS} columns x {MAIN_MINUTES} minutes, "
        f"float32, grid n={gp.n} nka={gp.nka} nkt={gp.nkt}, radiation on; "
        f"minute step {[round(1e3 * t, 1) for t in times]} ms, steady "
        f"{ms:.1f} ms = {MAIN_COLUMNS / (ms / 1e3):.2f} column-minutes/s; "
        f"launches {counts}; max xm2 {state.met.xm2.max().item():.3e} "
        f"kg/m3; dtrad range [{state.rad.dtrad.min().item() * 86400:.3f}, "
        f"{state.rad.dtrad.max().item() * 86400:.3f}] K/day")

    # the radiation call alone, as post_minute makes it
    rad = model._radiation
    rad_s = []
    for _ in range(RAD_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rad(state)
        torch.cuda.synchronize()
        rad_s.append(time.perf_counter() - t0)
    dev_events, ops = count_launches(lambda: rad(state))
    rad_ms = 1e3 * sum(rad_s) / len(rad_s)
    log(f"radiation call: {MAIN_COLUMNS} columns, float32, nrlay "
        f"{gp.nrlay}; {[round(1e3 * t, 2) for t in rad_s]} ms, mean "
        f"{rad_ms:.2f} ms ({100.0 * rad_ms / ms:.1f} % of the steady minute "
        f"step); per call {dev_events} device events (kernels + copies, "
        f"torch.profiler), {ops} aten ops")
    check(ops > 0, "no operators in the radiation call")

    state, wall, busy, events, top = profile_minute(model, state)
    log(f"one minute under torch.profiler: wall {1e3 * wall:.1f} ms, device "
        f"busy {1e3 * busy:.1f} ms ({100.0 * busy / wall:.1f} %), {events} "
        f"device events; device time by kernel (key_averages):")
    for name, calls, kms in top:
        log(f"  {kms:9.3f} ms {100.0 * kms / (1e3 * busy):5.1f} % of busy "
            f"{100.0 * kms / (1e3 * wall):5.1f} % of wall  {calls:6d} x "
            f"{name[:90]}")
    from mistra_tpu_torch.physics import growth
    rows = main_path_rows(model, state, growth, bott_cuda)
    return counts, {"radiation_ms": rad_ms, "radiation_device_events":
                    dev_events, "radiation_aten_ops": ops,
                    "minute_ms": ms, "profiled_minute_events": events,
                    "profiled_minute_wall_ms": 1e3 * wall,
                    "profiled_minute_busy_ms": 1e3 * busy,
                    "profiled_minute_top_kernels": [
                        {"kernel": n, "launches": c, "ms": t}
                        for n, c, t in top],
                    "main_path_rows": rows}


def midnight_and_noon(model, B=2):
    """model's initial state of B columns: column 0 at 00:00 (the BTZ96
    start) and column 1 at 12:00 local solar time, each with its own
    solar zenith angle."""
    from mistra_tpu_torch.model import solar_zenith
    state = model.init_state(B)
    lst = state.tim.lst.clone()
    lst[1] = 12
    u0 = solar_zenith(lst, state.tim.lmin, model.astro.alat,
                      model.astro.declin, model.dtype)
    return state.replace(tim=state.tim.replace(lst=lst),
                         rad=state.rad.replace(u0=u0))


def phase_device_vs_cpu(inpdir):
    """Port on the card (kernels) against the port on the CPU (plain): a
    midnight and a noon column, float64, one minute."""
    from mistra_tpu_torch import Model
    cfg = model_config(inpdir, "float64")
    out = {}
    for dev in (DEVICE, "cpu"):
        model = Model(cfg, device=dev)
        state = model.minute_step(midnight_and_noon(model))
        out[dev] = {k: v.cpu().numpy() for k, v in (
            ("t", state.met.t), ("xm1", state.met.xm1),
            ("ff", state.micro.ff), ("dtrad", state.rad.dtrad),
            ("totrad", state.rad.totrad), ("sk", state.rad.sk),
            ("sl", state.rad.sl))}
    check(out["cpu"]["sk"][1] > 0.0 == out["cpu"]["sk"][0],
          f"noon/midnight sk {out['cpu']['sk']}")
    errs = {}
    for k, tol in DEVICE_TOL.items():
        ref = out["cpu"][k]
        errs[k] = float(np.abs(out[DEVICE][k] - ref).max()
                        / np.abs(ref).max())
        check(errs[k] <= tol, f"{k}: card vs CPU {errs[k]:.3e} > {tol}")
    log("card vs cpu (2 columns at 00:00 and 12:00, float64, 1 minute) max "
        "rel err: " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))


def phase_radiation(inpdir):
    """nstrahl on the card against the CPU on the same inputs (a midnight
    and a noon column at the grid's nrlay), float64 and float32; also
    float32 against float64 on the card, the solve's own float32 error."""
    from mistra_tpu_torch import Model
    from mistra_tpu_torch.radiation.driver import nstrahl
    model = Model(model_config(inpdir, "float64"), device=DEVICE)
    state = midnight_and_noon(model)
    drv = model._radiation
    tx, px, rhox, xm1x, ts, bea, baa, ga = drv.load_profile(state)

    def flip(x):
        return torch.flip(x, dims=[-1])

    zeros = torch.zeros_like(bea[:, 0])
    c = drv._consts(tx.device)
    args = [flip(tx), flip(px), flip(rhox), flip(xm1x), ts,
            c["qmo3_td"].expand(2, -1), flip(bea), flip(baa), flip(ga),
            zeros, zeros, zeros, c["thk_td"].expand(2, -1), state.rad.u0,
            c["albedo"], c["emis"], c["berayl"]]
    names = ("hr", "totrad", "fnseb", "flgeg")
    out = {}
    for dtype in (torch.float64, torch.float32):
        for dev in (DEVICE, "cpu"):
            a = [x.to(dev, dtype) for x in args]
            out[dtype, dev] = [r.double().cpu().numpy()
                               for r in nstrahl(drv.pt, *a)]

    def rel(got, ref):
        return {k: float(np.abs(g - r).max() / np.abs(r).max())
                for k, g, r in zip(names, got, ref)}

    for dtype in (torch.float64, torch.float32):
        errs = rel(out[dtype, DEVICE], out[dtype, "cpu"])
        tol = RAD_TOL[dtype]
        log(f"nstrahl card vs cpu ({str(dtype).replace('torch.', '')}, 2 "
            f"columns at 00:00 and 12:00, nrlay {model.cfg.grid.nrlay}) max "
            f"rel err: " + ", ".join(f"{k} {v:.3e} (tol {tol[k]})"
                                     for k, v in errs.items()))
        for k, g in zip(names, out[dtype, DEVICE]):
            check(np.isfinite(g).all(), f"non-finite nstrahl {k}")
            check(errs[k] <= tol[k], f"nstrahl {dtype} {k}: card vs CPU "
                  f"{errs[k]:.3e} > {tol[k]}")
    own = rel(out[torch.float32, DEVICE], out[torch.float64, DEVICE])
    log("nstrahl float32 vs float64 on the card (same inputs): "
        + ", ".join(f"{k} {v:.3e}" for k, v in own.items())
        + f"; fnseb {out[torch.float64, 'cpu'][2]}, flgeg "
        f"{out[torch.float64, 'cpu'][3]} W/m2")


def chem_mechanism(tmp: str):
    """(mechanism, is_reference): $MECHDIR's tot mechanism if it holds the
    reference's master_gas.eqn and master_aqueous.eqn, else the synthetic
    stand-in written to tmp."""
    from mistra_tpu_torch.chemistry.mech import (
        load_multiphase_mechanism, write_synthetic_multiphase_mechanism)
    mechdir = os.environ.get("MECHDIR")
    if mechdir and all(os.path.exists(os.path.join(mechdir, f)) for f in
                       ("master_gas.eqn", "master_aqueous.eqn")):
        log(f"mechanism: reference tot mechanism from MECHDIR ({mechdir})")
        return load_multiphase_mechanism(mechdir, name="tot"), True
    write_synthetic_multiphase_mechanism(tmp)
    log("mechanism: synthetic tot-shaped stand-in (MECHDIR has none)")
    return load_multiphase_mechanism(tmp, name="tot"), False


def chem_inputs(mech, reference, cells, dtype, device, seed=0):
    """(GasKernel, k, fix, y0) for cells with te over 275-295 K, air at
    1 atm and log-normal concentrations, all drawn from seed with numpy
    (the same values on every device)."""
    from mistra_tpu_torch.chemistry.gas_kernel import GasKernel
    from mistra_tpu_torch.chemistry.rates import RateEnv, probe_dry_extras
    rng = np.random.default_rng(seed)
    te = rng.uniform(275.0, 295.0, cells)
    air = 101325.0 / (8.314 * te)                     # mol/m3
    y0 = 1e-8 * rng.lognormal(0.0, 1.0, (cells, mech.nvar))
    # aqueous water of the stand-in's "+ H2Olz" reactions; the reference
    # mechanism runs dry, as benchmarks/bench_chem.py runs it
    cols = {"O2": 0.21 * air, "N2": 0.79 * air, "H2O": np.full(cells, 0.5)}
    aq_water = 0.0 if reference else 1e-2
    fix = np.stack([cols.get(s, np.full(cells, aq_water))
                    for s in mech.fixed], axis=-1)

    def dev(x):
        return torch.tensor(x, dtype=dtype, device=device)

    env = RateEnv(te=dev(te), aircc=dev(air * 6.022e17),
                  h2oppm=dev(np.full(cells, 1.2e4)),
                  pk=dev(np.full(cells, 101325.0)),
                  ph_rat=dev(np.full((cells, 47), 1.0e-5)))
    if reference:
        env = dataclasses.replace(env, extras=probe_dry_extras(
            mech, env, torch.zeros(cells, dtype=dtype, device=device)))
    kern = GasKernel(mech, dtype=dtype, device=device)
    return kern, kern.rate_constants(env, fix=dev(fix)), dev(fix), dev(y0)


def normwise_residual(a, x):
    """max over the batch of ||A X - I|| / (||A|| ||X||), infinity norms."""
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
    r = (a @ x - eye).abs().sum(-1).amax(-1)
    na = a.abs().sum(-1).amax(-1)
    nx = x.abs().sum(-1).amax(-1)
    return (r / (na * nx)).max().item()


def compare_inverse(lu, lu_cuda, a, label):
    """The inverse kernel against the plain version (and torch.linalg.inv
    as a reference figure) on one batch; checks and times them."""
    n, m, _ = a.shape
    dtype = a.dtype
    # reads A, writes X; Gauss-Jordan does ~m^3 multiply-adds per matrix
    bnd = bound(2 * a.numel() * a.element_size(), 2.0 * n * m ** 3, dtype)
    xk = lu_cuda.batched_inv(a)
    xp = lu.batched_inv_plain(a)
    xl = torch.linalg.inv(a)
    torch.cuda.synchronize()
    rel = ((xk - xp).abs().amax() / xp.abs().amax()).item()
    res_k, res_l = normwise_residual(a, xk), normwise_residual(a, xl)
    res_tol = LU_RES_FACTOR * m * torch.finfo(dtype).eps
    out = dict(
        max_abs_err=(xk - xp).abs().max().item(), rel_err=rel,
        tol=LU_TOL[dtype], residual=res_k, linalg_residual=res_l,
        residual_tol=res_tol,
        shape=f"{n}x{m}x{m} {str(dtype).replace('torch.', '')} {label}",
        ms=cuda_ms(lambda: lu_cuda.batched_inv(a), 10),
        plain_ms=cuda_ms(lambda: lu.batched_inv_plain(a), 2, warmup=1),
        library_ms=cuda_ms(lambda: torch.linalg.inv(a), 5), **bnd)
    out["roofline_share"] = out["bound_ms"] / out["ms"]
    log(f"batched_inv {out['shape']}: err {out['max_abs_err']:.3e} (rel "
        f"{rel:.3e}), residual {res_k:.3e} (linalg.inv {res_l:.3e}); "
        f"{out['ms']:.3f} ms vs plain {out['plain_ms']:.3f} ms, "
        f"linalg.inv {out['library_ms']:.3f} ms, bound "
        f"{out['bound_ms']:.3f} ms ({out['bound_by']}, "
        f"{100.0 * out['roofline_share']:.1f} %)")
    check(bool(torch.isfinite(xk).all()), f"non-finite inverse {label}")
    check(rel <= LU_TOL[dtype], f"inverse disagrees: {rel} > {LU_TOL[dtype]}")
    check(res_k <= res_tol, f"inverse residual {res_k} > {res_tol}")
    return out


def phase_lu(mech, reference):
    """Kernel against plain at the chemistry solve's shapes, both dtypes,
    three kinds of input; returns the results per (dtype, m, kind)."""
    from mistra_tpu_torch.chemistry import lu, lu_cuda
    out = {}
    for dtype in (torch.float64, torch.float32):
        kern, k, fix, y = chem_inputs(mech, reference, CHEM_CELLS, dtype,
                                      DEVICE)
        rng = np.random.default_rng(5)
        ghinv = torch.tensor(10.0 ** rng.uniform(-0.5, 5.0, CHEM_CELLS),
                             dtype=dtype, device=DEVICE)
        blk = kern.block
        # the equilibrated stage matrices R (ghinv I - J) whose inverses
        # the solve takes: the aqueous blocks and the Schur complement
        fact = blk.prepare(blk.assemble(kern.kw_weights(y, k, fix)), ghinv)
        stage = (fact.abb.reshape(-1, blk.ma, blk.ma), fact.s)
        del fact, kern
        for a_stage in stage:
            n, m, _ = a_stage.shape
            a_dom = rng.random((n, m, m)) + 4.0 * np.eye(m)
            a_piv = rng.standard_normal((n, m, m))
            a_piv[:, np.arange(m // 2), np.arange(m // 2)] = 0.0
            for kind, a in (("stage", a_stage), ("dominant", a_dom),
                            ("pivoting", a_piv)):
                a = torch.as_tensor(a, dtype=dtype, device=DEVICE)
                out[(dtype, m, kind)] = compare_inverse(lu, lu_cuda, a,
                                                        kind)
    return out


def phase_chem(mech, reference):
    """The stiff chemistry solve on the card: GasKernel.integrate for
    CHEM_CELLS cells in float64, one warm substep then CHEM_TIMED timed
    ones, each from the last (clamped at 0, as benchmarks/bench_chem.py);
    returns the inverse kernel's launches and the Ros3 loop iterations."""
    from mistra_tpu_torch.chemistry import lu_cuda
    kern, k, fix, y = chem_inputs(mech, reference, CHEM_CELLS,
                                  torch.float64, DEVICE)
    check(kern.solver == "block", f"solver {kern.solver}")
    torch.cuda.synchronize()
    lu_cuda.reset_counts()
    iterations, times, steps = 0, [], []
    for _ in range(1 + CHEM_TIMED):
        t0 = time.perf_counter()
        y, info = kern.integrate(y, k, fix, CHEM_DT)
        y = torch.clamp(y, min=0.0)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        nsteps = info["nsteps"].cpu().numpy()
        steps.append(nsteps)
        iterations += int(nsteps.max())
        check(int(info["n_failed"]) == 0, f"{int(info['n_failed'])} cells "
              "failed")
        check(bool(info["done"].all()), "cells not done")
        check(bool(torch.isfinite(y).all()), "non-finite concentrations")
    launches = lu_cuda.batched_inv.launches
    check(tuple(y.shape) == (CHEM_CELLS, mech.nvar), f"y shape {y.shape}")
    # two inverses per Ros3 step attempt, and nothing else calls the kernel
    check(launches == 2 * iterations,
          f"batched_inv launches {launches} != 2 x {iterations} iterations")
    timed = times[1:]
    rate = CHEM_CELLS * len(timed) / sum(timed)
    log(f"chemistry path: {CHEM_CELLS} cells, float64, nvar {mech.nvar}, "
        f"nrxn {mech.nrxn}; substeps {[round(t, 3) for t in times]} s "
        f"(first warm); {rate:.1f} cell-substeps/s over {len(timed)} timed "
        f"substeps; Ros3 steps per cell mean/max: warm "
        f"{steps[0].mean():.1f}/{steps[0].max()}, timed "
        f"{np.mean(steps[1:]):.1f}/{np.max(steps[1:])}; n_failed 0; "
        f"batched_inv launches {launches} = 2 x {iterations} iterations")
    return launches, iterations


def phase_chem_device_vs_cpu(mech, reference):
    """Chemistry path on the card (kernel) against the CPU (plain
    inverse): CHEM_CMP_CELLS cells, float64, one substep."""
    out = {}
    for dev in (DEVICE, "cpu"):
        kern, k, fix, y0 = chem_inputs(mech, reference, CHEM_CMP_CELLS,
                                       torch.float64, dev, seed=1)
        y, info = kern.integrate(y0, k, fix, CHEM_DT)
        check(int(info["n_failed"]) == 0, f"{dev}: cells failed")
        out[dev] = (y.cpu().numpy(), info["nsteps"].cpu().numpy())
    ref = out["cpu"][0]
    scale = np.maximum(np.abs(ref).max(axis=0), 1e-300)
    err = float((np.abs(out[DEVICE][0] - ref) / scale).max())
    ndiff = int((out[DEVICE][1] != out["cpu"][1]).sum())
    log(f"chemistry card vs cpu ({CHEM_CMP_CELLS} cells, float64, one "
        f"substep): max err {err:.3e} of each species' largest |y| (tol "
        f"{CHEM_DEVICE_TOL}); nsteps differ in {ndiff} of "
        f"{CHEM_CMP_CELLS} cells (cpu mean {out['cpu'][1].mean():.1f})")
    check(err <= CHEM_DEVICE_TOL, f"chemistry card vs CPU {err:.3e}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    # the port and its kernel sources come from this checkout, not from an
    # installed copy
    import mistra_tpu_torch
    from mistra_tpu_torch.kernels import build
    from mistra_tpu_torch.physics import bott_cuda, growth
    pkg = Path(mistra_tpu_torch.__file__).resolve().parent
    check(pkg == ROOT / "mistra_tpu_torch",
          f"mistra_tpu_torch imported from {pkg}, not from {ROOT}")

    card = card_line()
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    build.load_library()
    log(f"kernel build + load {time.perf_counter() - t0:.2f} s "
        f"(nvcc {build.build_seconds if build.build_seconds else 0.0:.2f} s)")
    for line in build.ptxas_log.splitlines():
        if "registers" in line or "spill" in line:
            log("ptxas: " + line.strip())

    kernels = phase_kernels(growth, bott_cuda)
    with tempfile.TemporaryDirectory(prefix="mistra_inp_") as tmp:
        inpdir = input_dir(tmp)
        counts, main = phase_main(inpdir, bott_cuda)
        phase_device_vs_cpu(inpdir)
        phase_radiation(inpdir)
    with tempfile.TemporaryDirectory(prefix="mistra_mech_") as tmp:
        mech, reference = chem_mechanism(tmp)
    lu_results = phase_lu(mech, reference)
    counts["batched_inv"], ros3_iterations = phase_chem(mech, reference)
    phase_chem_device_vs_cpu(mech, reference)

    rows = []
    for name, line in (("bott_dwsum", 204), ("bott_advect", 173)):
        rows.append({"name": name, "route": "cuda",
                     "source": "mistra_tpu_torch/csrc/bott.cu",
                     "replaces": f"mistra_tpu/physics/bott_pallas.py:{line}",
                     "launches": counts[name],
                     "launches_per_minute": counts[name] / MAIN_MINUTES,
                     "main_path_rows_ms": main["main_path_rows"][
                         name.replace("bott_", "") + "_ms"],
                     **kernels[name]})
    # the main path's calls: float64 stage matrices, the aqueous blocks
    # and the Schur complement (one of each per Ros3 step attempt)
    main_calls = [r for (dt, _, kind), r in lu_results.items()
                  if dt == torch.float64 and kind == "stage"]
    inv = {k: sum(r[k] for r in main_calls)
           for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    rows.append({
        "name": "batched_inv", "route": "cuda",
        "source": "mistra_tpu_torch/csrc/lu.cu",
        "replaces": "mistra_tpu/chemistry/lu_pallas.py:67,100",
        "launches": counts["batched_inv"],
        "launches_per_ros3_iteration":
            counts["batched_inv"] / ros3_iterations,
        "max_abs_err": max(r["max_abs_err"] for r in main_calls),
        **inv,
        "bound_by": "+".join(sorted({r["bound_by"] for r in main_calls})),
        "roofline_share": inv["bound_ms"] / inv["ms"],
        "shape": " + ".join(r["shape"] for r in main_calls),
        "all": [{k: r[k] for k in ("shape", "rel_err", "residual",
                                   "linalg_residual", "ms", "plain_ms",
                                   "library_ms", "bound_ms", "bound_by",
                                   "roofline_share")}
                for r in lu_results.values()]})
    log(json.dumps({"main_path": main}))
    log(json.dumps({"kernels": rows}))
    log(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
