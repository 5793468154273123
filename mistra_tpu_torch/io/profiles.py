"""Hourly ASCII profile output.

Torch counterpart of ``mistra_tpu.io.profiles``, the same text character
for character: ``profm`` (met), ``profc`` (chemistry), ``profr``
(radiation) of the reference (outp.f90:1745-2277), written every hour from
the main loop (str.f90:504-508).  Column-aligned text, one line per level,
one block per output time, for one column (``column``) of a batched
state.
"""

from __future__ import annotations

import numpy as np
import torch


def host(x, column=None) -> np.ndarray:
    """x (a tensor or an array) as a numpy array on the host; with column,
    that column of a batched tensor."""
    if torch.is_tensor(x):
        if column is not None:
            x = x[column]
        return x.detach().cpu().numpy()
    x = np.asarray(x)
    return x if column is None else x[column]


def _stamp(tim, column):
    return (f"# day {int(host(tim.lday, column))} "
            f"{int(host(tim.lst, column)):02d}:"
            f"{int(host(tim.lmin, column)):02d}")


def profm(fh, state, atm, nf: int, column: int = 0):
    """Meteorology profile block (profm, outp.f90:1745-1918)."""
    met = state.met
    fh.write(f"{_stamp(state.tim, column)}"
             f"  t={float(host(state.tim.time, column)):.0f}s\n")
    fh.write("#  k     eta[m]      u[m/s]      v[m/s]       T[K]"
             "    theta[K]  q[kg/kg]   rh[-]   tke[m2/s2]\n")
    eta = host(atm.eta)
    u, v = host(met.u, column), host(met.v, column)
    t, th = host(met.t, column), host(met.theta, column)
    q, feu = host(met.xm1, column), host(met.feu, column)
    tke = host(met.tke, column)
    for k in range(min(nf + 1, len(eta))):
        fh.write(f"{k:4d} {eta[k]:10.2f} {u[k]:11.4f} {v[k]:11.4f} "
                 f"{t[k]:10.3f} {th[k]:11.3f} {q[k]:9.5f} {feu[k]:7.4f} "
                 f"{tke[k]:11.5f}\n")
    fh.write("\n")
    fh.flush()


def profr(fh, state, atm, nf: int, column: int = 0):
    """Radiation profile block (profr, outp.f90:2153-2277)."""
    rad = state.rad
    fh.write(f"{_stamp(state.tim, column)}"
             f"  u0={float(host(rad.u0, column)):.4f}\n")
    fh.write("#  k     eta[m]   dtrad[K/h]\n")
    eta = host(atm.eta)
    dtrad = host(rad.dtrad, column)
    for k in range(min(nf + 1, len(eta))):
        fh.write(f"{k:4d} {eta[k]:10.2f} {dtrad[k] * 3600.0:12.5f}\n")
    fh.write("\n")
    fh.flush()


def profc(fh, state, atm, species, nf: int, names=("O3", "NO", "NO2",
                                                   "HNO3", "NH3", "SO2",
                                                   "DMS", "O1D", "OH",
                                                   "HCl", "HBr", "HI"),
          column: int = 0):
    """Chemistry profile block for selected gases (profc,
    outp.f90:1919-2152), in mol/m3 as stored."""
    n2i = {s: i for i, s in enumerate(species)}
    sel = [(nm, n2i[nm]) for nm in names if nm in n2i]
    if not sel:
        return
    fh.write(f"{_stamp(state.tim, column)}  [mol/m3]\n")
    fh.write("#  k     eta[m] " + " ".join(f"{nm:>10s}" for nm, _ in sel)
             + "\n")
    eta = host(atm.eta)
    sgas = host(state.chem.sgas, column)
    for k in range(min(nf + 1, len(eta))):
        vals = " ".join(f"{sgas[i, k]:10.3e}" for _, i in sel)
        fh.write(f"{k:4d} {eta[k]:10.2f} {vals}\n")
    fh.write("\n")
    fh.flush()
