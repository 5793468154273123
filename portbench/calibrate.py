"""Readings that the limits of ``correct`` are set from (not run by the
benchmark's own runs).

    python3 -m portbench.calibrate --workload <cell> --seconds <s> \\
        --seeds 11 12 13 [--controls bf16 f32_tot --control-seeds 11 12] \\
        [--fault chem_unchanged]

Runs the cell once per seed in this one process (set-up, a window of
``--seconds``, the reference) and prints one JSON line per seed: the
program's gaps to the reference (the sound readings), where each widest
gap lies and which boolean fields differ (the look at a reading), and,
for the seeds in ``--control-seeds``, the gaps of each control named in
``--controls`` (the configuration's ``controls``: the reference in the
program's place, in a lower precision).  With ``--fault`` the program
runs with that fault of ``faults`` planted, and its gaps are the fault's
readings.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from . import faults, registry
from .run import judge, run_cell


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--controls", nargs="*", default=())
    ap.add_argument("--control-seeds", type=int, nargs="*", default=())
    ap.add_argument("--fault", choices=sorted(faults.FAULTS))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.calibrate: no CUDA card", file=sys.stderr)
        return 2
    bench = registry.load_benchmark()
    cell = registry.cell(bench, args.workload)
    limits = registry.config(cell["config"])["limits"]
    undo = faults.install(args.fault) if args.fault else None
    try:
        for seed in args.seeds:
            out = run_cell(cell, seed, args.seconds, False,
                           controls=(args.controls if seed in
                                     args.control_seeds else ()),
                           started=time.time(), diagnose=True)
            print(json.dumps({
                "workload": args.workload, "seed": seed,
                "fault": args.fault, "minutes": out["minutes"],
                "e2e": out["e2e"], "failed": out["failed"],
                "reference_s": out["reference_s"], "gaps": out["gaps"],
                "correct": judge(out["gaps"], limits)[0],
                "where": out["where"], "flips": out["flips"],
                "controls": {k: dict(g, correct=judge(g, limits)[0])
                             for k, g in out["controls"].items()}}),
                flush=True)
    finally:
        if undo is not None:
            undo()
    return 0


if __name__ == "__main__":
    sys.exit(main())
