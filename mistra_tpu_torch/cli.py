"""Run harness: the reference's param/namelist launch workflow as a CLI
(torch counterpart of ``mistra_tpu.cli``).

Parity with the bash launchers (param/param_*, C40): configuration comes
from the INPDIR / OUTDIR / MECHDIR / NAMELIST environment variables or
command-line flags; the run writes 15-min science output, a per-minute
progress line (tima.out equivalent), hourly ASCII profiles, 12-hourly
restart checkpoints and a final restart + aerosol dump.

The run is one column on the card (``--platform cpu`` runs it on the CPU;
without a card and without that flag it raises).  Box and chamber runs go
through ``BoxModel``.  The state's dtype is the namelist's ``dtype``.
Checkpoints are ``torch.save`` files (``io/checkpoint.py``):
``restart_day<d>_<hh>h.pt`` every 12 hours and ``restart.pt`` at the end.
The science output is netCDF where the native writer finds libnetcdf
(``io/netcdf.py``), else numpy files under ``<outdir>/output``
(``io/output.py``).

Usage:
    python -m mistra_tpu_torch --namelist /path/to/namelist.BTZ96
        [--hours H | --minutes M] [--outdir DIR] [--restart CKPT]
        [--platform cpu] [--grid nf=..,n_extra=..] [--profile DIR]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time as wallclock

import numpy as np
import torch

from .boxmodel import BoxModel
from .chemistry import diagnostics as chem_diag
from .chemistry import lu_cuda
from .config import GridParams, MistraConfig, config_from_namelist
from .io import netcdf as ncio
from .io import profiles as prof
from .io.checkpoint import restore_checkpoint, save_checkpoint
from .io.output import OutputWriter
from .io.profiles import host
from .model import Model
from .physics import bott_cuda
from .utils import profiling, resolve_device
from .utils.profiling import span, trace


def device_for(platform: str):
    """The torch device of ``--platform``: the card unless it says cpu."""
    if platform in ("", "gpu"):
        platform = "cuda"
    return resolve_device(platform)


def override_grid(cfg, spec: str) -> None:
    """Apply ``--grid``'s 'nf=12,n_extra=6,...[,zinv=100]' to cfg."""
    kv = dict(p.split("=") for p in spec.split(","))
    zinv = kv.pop("zinv", None)
    cfg.grid = GridParams(**{k: int(v) for k, v in kv.items()})
    if zinv is not None:
        cfg.zinv = float(zinv)


@contextlib.contextmanager
def profiled(logdir: str):
    """torch.profiler's Chrome trace of the block into logdir, and beside
    it the records of the program's spans that closed in the block
    (``spans_<pid>.json``, ``profiling.collect``'s dicts)."""
    with profiling.tracing(records=True):
        with trace(logdir):
            yield
        records = profiling.collect()
    with open(os.path.join(logdir, f"spans_{os.getpid()}.json"), "w") as f:
        json.dump(records, f)


def span_report(summary: dict, minutes: int) -> dict:
    """{span name: {calls, ms_per_minute, syncs_per_minute}} over the
    run's minutes: each span's own time and its own host syncs (the
    ``sync.*`` counters counted in it and not in a child)."""
    per = 1.0 / max(minutes, 1)
    return {name: {"calls": agg["calls"],
                   "ms_per_minute": 1e3 * agg["seconds"] * per,
                   "syncs_per_minute": per * sum(
                       n for k, n in agg["counts"].items()
                       if k.startswith("sync."))}
            for name, agg in sorted(summary.items(), key=lambda kv:
                                    -kv[1]["seconds"]) if name is not None}


def main(argv=None):
    ap = argparse.ArgumentParser(prog="mistra_tpu_torch")
    ap.add_argument("--namelist",
                    default=os.environ.get("NAMELIST", ""),
                    help="Fortran namelist file (reference format)")
    ap.add_argument("--outdir", default=os.environ.get("OUTDIR", "./output"))
    ap.add_argument("--hours", type=float, default=None,
                    help="override lstmax integration hours")
    ap.add_argument("--restart", default="",
                    help="checkpoint file to restore from")
    ap.add_argument("--platform", default="",
                    help="torch device: the card by default (cuda), or cpu")
    ap.add_argument("--grid", default="",
                    help="override grid sizes for quick runs, e.g. "
                         "'nf=12,n_extra=6,nka=16,nkt=16,nb=8[,zinv=100]'")
    ap.add_argument("--minutes", type=int, default=None,
                    help="integrate this many minutes instead of full hours")
    ap.add_argument("--profile", default="",
                    help="capture a torch.profiler trace of minutes 2-4 "
                         "into this directory (Chrome trace format), with "
                         "the program's spans; report each span's ms and "
                         "host syncs per minute")
    args = ap.parse_args(argv)
    # the program's tracer: on around the snapshots and checkpoints, whose
    # times the report gives, and with --profile over the run's minutes
    profiling.reset()

    device = device_for(args.platform)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    if args.namelist:
        cfg = config_from_namelist(args.namelist)
    else:
        cfg = MistraConfig()
    if args.hours is not None:
        cfg.lstmax = max(1, int(round(args.hours)))
    if args.grid:
        override_grid(cfg, args.grid)
    cfg.outdir = args.outdir
    os.makedirs(args.outdir, exist_ok=True)

    print(f"mistra_tpu_torch: "
          f"{'box' if cfg.box else 'chamber' if cfg.chamber else '1-D'}"
          f" run, {cfg.lstmax} h, chem={cfg.chem} mic={cfg.mic}, "
          f"{cfg.dtype} on {device}")
    if cfg.box or cfg.chamber:
        box = BoxModel(cfg, device=device)
        model = box.model
        state = box.init_state()
        step_owner = box
    else:
        model = Model(cfg, device=device)
        state = model.init_state()
        step_owner = model
    if args.restart:
        state = restore_checkpoint(args.restart, state)
        print(f"restored state from {args.restart}")

    if ncio.available():
        # reference-layout netCDF groups via the native async writer
        writer = ncio.NetCDFOutputWriter(args.outdir, model)
        print(f"writer: netCDF ({ncio.library_path()})")
    else:
        out = os.path.join(args.outdir, "output")
        writer = OutputWriter(out, model)
        print(f"writer: numpy files in {out} (netCDF unavailable: "
              f"{ncio.unavailable_reason()})")
    # the run's one column: the writer's, which every other output takes too
    col = writer.column

    # the snapshots' spans: the initial record (with the 2-D spectrum ff
    # where mic, and the first calls' set-up), and the loop's, by whether
    # they wrote ff (every 30 minutes, with mic)
    snap_kinds = ("initial", "ff", "no_ff")

    def snapshot(particles, key=None):
        key = key or ("ff" if particles else "no_ff")
        with profiling.tracing(), span(f"snapshot.{key}"):
            writer.snapshot(state, particles)
    snapshot(cfg.mic, "initial")

    step = step_owner.minute_step
    itmax = args.minutes if args.minutes is not None else 60 * cfg.lstmax
    n = cfg.grid.n
    drv = model._chemistry

    with contextlib.ExitStack() as stack:
        stack.callback(writer.close)
        # hourly element-family mass closure (mass_ch, kpp.f90:5900-6181)
        mass_out = None
        if drv is not None:
            mech_m = ncio.output_mechanism(model)
            sb = getattr(mech_m, "species_bin", None)
            mass_out = stack.enter_context(
                open(os.path.join(args.outdir, "mass.out"), "w"))
            mass_out.write("# day hh:mm  column totals [mol/m2]: "
                           "Cl Br I S N\n")

        # opt-in per-reaction budgets (C33): accumulate every minute at the
        # nlev_bud output levels, write with each 15-min snapshot; the S/DMS
        # species budgets (bud_s_{g,a,t}.f) at all levels, on the S channels
        budgets = cfg.binout and drv is not None and writer.rxn is not None
        if budgets:
            lev_bud = writer.bud_levels
            lev_all = np.arange(1, n - 1)
            s_ch = writer.s_channels
            bud_cum = sbud_cum = None

            def rates_at(levels):
                """The run's column's rates [nrxn, len(levels)]."""
                r = drv.reaction_rates_at(state, levels)
                return host(r.reshape(-1, len(levels), r.shape[-1]), col).T
        xn_apacc = None   # cumulative apparent-nucleation count (nucout2)
        tima = stack.enter_context(
            open(os.path.join(args.outdir, "tima.out"), "w"))
        # the --profile trace of minutes 2-4, closed with the run if it ends
        # earlier
        tracing = stack.enter_context(contextlib.ExitStack())
        # the hand-written kernels' launches in the run's minutes (on the card;
        # the plain versions that run on the CPU count nothing)
        bott_cuda.reset_counts()
        lu_cuda.reset_counts()
        if args.profile:
            stack.enter_context(profiling.tracing())
        sync()
        t_start = wallclock.time()

        for it in range(1, itmax + 1):
            if args.profile and it == 2:
                tracing.enter_context(profiled(args.profile))
            state = step(state)
            if args.profile and it == 4:
                tracing.close()
                print(f"profiler trace written to {args.profile}")
            lday, lst, lmin = (int(host(state.tim.lday, col)),
                               int(host(state.tim.lst, col)),
                               int(host(state.tim.lmin, col)))
            # progress line (reference cadence: every minute; str.f90:517-531)
            tke = host(state.met.tke, col)
            atkh = host(state.turb.atkh, col)
            xm2 = host(state.met.xm2, col)
            rho = host(state.met.rho, col)
            line = (f"{lday:2d}:{lst:2d}:{lmin:2d} "
                    f"tke={tke[:100].max():8.3f} atkh={atkh[:100].max():8.3f} "
                    f"lwc={1000 * (xm2[:100] / rho[:100]).max():8.3f}")
            nonconv = int(host(state.chem.nonconv, col)) \
                if state.chem is not None else 0
            if nonconv:
                # per-cell stiff-solver failures (reference warning path,
                # gas.f:764-767): frozen cells, cumulative count
                line += f" chem_nonconv={nonconv}"
            tima.write(line + "\n")
            tima.flush()
            if budgets:
                inst = rates_at(lev_bud)
                bud_cum = inst * 60.0 if bud_cum is None \
                    else bud_cum + inst * 60.0
                s_lev = rates_at(lev_all)[s_ch]
                s_inst_full = np.zeros((s_lev.shape[0], n))
                s_inst_full[:, 1:n - 1] = s_lev
                sbud_cum = s_inst_full * 60.0 if sbud_cum is None \
                    else sbud_cum + s_inst_full * 60.0
            if it % 15 == 0:
                snapshot(cfg.mic and it % 30 == 0)
                if budgets:
                    writer.write_budgets(inst, bud_cum, s_inst_full, sbud_cum)
                if writer.nuc is not None and model._nucleation is not None:
                    # nucleation diagnostics snapshot (nucout1/2), recomputed
                    # at dd = 60 s as the JAX package does
                    _, nuc_diag = model._nucleation(state, 60.0)
                    xn = host(nuc_diag["xn_app"], col) * 900.0
                    xn_apacc = xn if xn_apacc is None else xn_apacc + xn
                    writer.write_nucleation(nuc_diag, xn_apacc)
            if lmin == 0:   # hourly ASCII profiles (str.f90:504-508)
                with open(os.path.join(args.outdir, "profm.out"), "a") as fh:
                    prof.profm(fh, state, model.atm, cfg.grid.nf,
                               column=col)
                with open(os.path.join(args.outdir, "profr.out"), "a") as fh:
                    prof.profr(fh, state, model.atm, cfg.grid.nf,
                               column=col)
                if drv is not None:
                    with open(os.path.join(args.outdir, "profc.out"),
                              "a") as fh:
                        prof.profc(fh, state, model.atm,
                                   ncio.output_mechanism(model).species,
                                   cfg.grid.nf, column=col)
            if mass_out is not None and lmin == 0:
                tot = chem_diag.family_column_totals(
                    state.chem.sgas, mech_m.species, model.atm.detw,
                    species_bin=sb)
                tot = {k: float(host(v, col)) for k, v in tot.items()}
                mass_out.write(f"{lday:2d} {lst:02d}:{lmin:02d}  "
                               + " ".join(f"{tot[e]:.6e}" for e in
                                          ("Cl", "Br", "I", "S", "N")) + "\n")
                mass_out.flush()
            if lst % 12 == 0 and lmin == 0 and not cfg.box:
                with profiling.tracing(), span("checkpoint"):
                    save_checkpoint(os.path.join(
                        args.outdir, f"restart_day{lday}_{lst:02d}h.pt"),
                        state)
            if it % 60 == 0:
                el = wallclock.time() - t_start
                print(f"  {it}/{itmax} min done ({el:.0f}s wall, "
                      f"{el / it:.1f} s/min)")
        tracing.close()
        sync()
        launches = {"bott_dwsum": bott_cuda.bott_dwsum.launches,
                    "bott_advect": bott_cuda.bott_advect.launches,
                    "batched_inv": lu_cuda.batched_inv.launches}

        with profiling.tracing(), span("checkpoint"):
            save_checkpoint(os.path.join(args.outdir, "restart.pt"), state)
        # final aerosol spectrum (ae*.out equivalent; str.f90:540-553)
        if cfg.mic:
            aer = host(state.micro.ff, col).sum(axis=0)  # [nka, n]
            np.save(os.path.join(args.outdir, "aerosol_final.npy"), aer.T)
    el = wallclock.time() - t_start
    spans = profiling.summary()
    none = {"calls": 0, "seconds": 0.0}
    snaps = {k: spans.get(f"snapshot.{k}", none) for k in snap_kinds}
    ckpt = spans.get("checkpoint", none)
    report = {"minutes": itmax, "seconds": el,
              "s_per_minute": el / max(itmax, 1),
              **{f"snapshots_{k}": a["calls"] for k, a in snaps.items()},
              **{f"snapshot_{k}_ms": 1e3 * a["seconds"] / max(a["calls"], 1)
                 for k, a in snaps.items()},
              "checkpoints": ckpt["calls"],
              "checkpoint_ms": 1e3 * ckpt["seconds"] / max(ckpt["calls"], 1),
              "kernel_launches": launches}
    if args.profile:
        report["spans"] = span_report(spans, itmax)
    print(f"run report: {json.dumps(report)}")
    print("run complete")
    return 0


if __name__ == "__main__":
    sys.exit(main())
