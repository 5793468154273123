"""The cells whose tot Ros3 solve runs out of steps in a multiphase substep,
and what makes them stiff.

    python3 -m mistra_tpu_torch.chemistry.stiff_cells [--dtype float32]
        [--inpdir DIR] [--mechdir DIR]

Builds the multiphase column minute of ``chip_smoke.py``'s phase 10 (the
BTZ96 fog with chem=True, nkc_l=4, halo=True, iod=False) at the production
grid for one column at 00:00, on the synthetic input tables and tot
mechanism unless the directories given hold the reference's; runs its
first substep up to the tot solve, solves that batch of cells and prints,
for every cell that ran out of Ros3 steps, how far into the substep it
came and the steps of its layer and its neighbours; for each bin holding water, cm and cw, the Pitzer ions'
molalities (Na+ from the charge balance, as the activity stage takes it),
the ionic strength and the largest activity coefficient; and the three
largest rate constants with their reactions.  It runs on the CPU (the
plain versions of the kernels): one column takes about a minute.
"""

from __future__ import annotations

import argparse
import tempfile

import numpy as np
import torch

from ..config import GridParams, MistraConfig
from .activity import ION_SPECIES, xgamma_field

# chip_smoke.py's BTZ96 settings with its multiphase chemistry
MULTIPHASE = dict(chem=True, mic=True, tw=288.15, zinv=800.0, dtinv=7.0,
                  ug=8.5, vg=0.0, nw_prof_opt=1, wmax=-0.005, z0=0.0001,
                  alat=55.0, nkc_l=4, halo=True, iod=False)
# charge of each Pitzer ion, by sion1 slot
_CHARGE = {1: 1, 2: 1, 19: -1, 8: -2, 13: -1, 14: -1}


class _AtTheSolve(Exception):
    pass


def tot_solve_inputs(model):
    """(state, conc, lp, lev) of the first substep's tot solve from
    model's initial state of one column."""
    state = model.pre_minute(model.init_state(1))
    drv = model._chemistry
    seen = {}

    def stop(state, conc, lp, lev, dt):
        seen.update(state=state, conc=conc, lp=lp, lev=lev)
        raise _AtTheSolve

    drv._integrate_tot = stop
    try:
        model.substep(state, 10.0)
    except _AtTheSolve:
        pass
    finally:
        del drv._integrate_tot
    return seen["state"], seen["conc"], seen["lp"], seen["lev"]


def bin_report(drv, state, conc, lp, layer):
    """Lines on every bin of ``layer`` that holds water."""
    n2i = drv.tot_n2i
    cm, cw = lp["cm"][0, :, layer], lp["cw"][0, :, layer]
    xg, _ = xgamma_field(state.met.t.double(), conc.double(),
                         lp["cm"].double(), lp["cw"].double(), n2i,
                         drv.model.cfg.grid.nf)
    lines = []
    for b in range(1, drv.nkc + 1):
        if float(cw[b - 1]) <= 0.0:
            continue
        m = {}
        for slot, stem in ION_SPECIES.items():
            i = n2i.get(f"{stem}l{b}")
            m[slot] = 0.0 if i is None else (
                float(conc[0, i, layer]) * 1.0e-3
                / max(float(cm[b - 1]), 1e-30))
        na = max(sum(-_CHARGE[s] * v for s, v in m.items() if _CHARGE[s] < 0)
                 - m[1] - m[2], 0.0)
        ionic = 0.5 * (sum(_CHARGE[s] ** 2 * v for s, v in m.items()) + na)
        g = xg[0, :, b - 1, layer]
        top = int(torch.argmax(g))
        lines.append(
            f"  bin {b}: cm {float(cm[b - 1]):.3e} cw {float(cw[b - 1]):.3e}"
            f"; molality " + ", ".join(f"{ION_SPECIES[s]} {v:.3g}"
                                       for s, v in m.items())
            + f", Na {na:.3g}; ionic strength {ionic:.4g}; largest "
            f"activity coefficient {float(g[top]):.3e} (slot {top + 1})")
    return lines


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "float64"))
    ap.add_argument("--inpdir", help="the reference's input tables")
    ap.add_argument("--mechdir", help="the reference's tot mechanism")
    args = ap.parse_args(argv)

    from ..model import Model
    from ..photolysis.tables import write_synthetic_photolysis_tables
    from ..physics.surface import write_synthetic_clarke_table
    from ..radiation.tables import write_synthetic_radiation_tables
    from .mech import write_synthetic_tot_mechanism

    with tempfile.TemporaryDirectory() as tmp:
        inpdir, mechdir = args.inpdir, args.mechdir
        if inpdir is None:
            inpdir = tmp
            for write in (write_synthetic_clarke_table,
                          write_synthetic_radiation_tables,
                          write_synthetic_photolysis_tables):
                write(tmp)
        if mechdir is None:
            mechdir = tmp
            write_synthetic_tot_mechanism(tmp)
        cfg = MistraConfig(grid=GridParams(), dtype=args.dtype,
                           inpdir=inpdir, mechdir=mechdir, **MULTIPHASE)
        model = Model(cfg, device="cpu")
        state, conc, lp, lev = tot_solve_inputs(model)
        drv = model._chemistry
        nvar = drv.tot.nvar
        y0 = conc[..., lev].transpose(1, 2).reshape(-1, nvar) \
            .to(drv.tot_dtype)
        k, fix = drv._tot_env(state, lp, lev, y0)
        _, info = drv.tot_kernel.integrate(
            y0, k.to(drv.tot_dtype), fix.to(drv.tot_dtype), 10.0)
        steps = info["nsteps"].cpu().numpy()
        reached = info["t"].cpu().numpy()
        failed = np.nonzero(info["failed"].cpu().numpy())[0]
        print(f"tot solve of the first substep: {len(steps)} cells (layers "
              f"1..{cfg.grid.nf - 1}), nvar {nvar}, steps mean "
              f"{steps.mean():.1f} max {steps.max()}; {len(failed)} "
              f"ran out of steps")
        for c in failed:
            layer = int(lev[c])
            near = ", ".join(f"layer {layer + d}: {steps[c + d]}"
                             for d in (-1, 1) if 0 <= c + d < len(steps))
            print(f"layer {layer}: {steps[c]} steps (failed) reached "
                  f"t = {reached[c]:.3e} s of 10 s; {near}")
            for line in bin_report(drv, state, conc, lp, layer):
                print(line)
            kc = k[c].double().cpu().numpy()
            for i in np.argsort(-np.abs(kc))[:3]:
                r = drv.tot.reactions[i]
                print(f"  k {kc[i]:.3e} {r.label}: {r.rate_expr}")


if __name__ == "__main__":
    main()
