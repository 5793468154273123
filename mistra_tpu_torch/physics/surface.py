"""Surface layer: Clarke-function drag interpolation and the water-surface
boundary condition (torch counterpart of ``mistra_tpu.physics.surface``).

Reference semantics: ``claf`` (str.f90:4369-4477) interpolates tabulated
Clarke functions read from ``input/clarke.dat``; ``surf0``
(str.f90:3954-4071) applies the constant-SST water surface with forced
relative humidity and Charnock roughness.  The bare-soil surface
(``soil``/``surf1``, isurf=1) is not ported yet.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from ..constants import EPS_RATIO, G, ONE_MINUS_EPS
from .thermo import p21


@dataclass(frozen=True)
class ClarkeTable:
    fu: object      # [18, 7] momentum Clarke function
    ft: object      # [18, 7] heat/moisture Clarke function
    xzpdl: object   # [18] stability coordinate nodes
    xzpdz0: object  # [7] roughness coordinate nodes

    def to(self, dtype, device) -> "ClarkeTable":
        """The table as tensors of ``dtype`` on ``device``."""
        def cv(x):
            return torch.as_tensor(x, dtype=dtype, device=device)
        return ClarkeTable(fu=cv(self.fu), ft=cv(self.ft),
                           xzpdl=cv(self.xzpdl), xzpdz0=cv(self.xzpdz0))


def load_clarke_table(inpdir: str) -> ClarkeTable:
    """Parse input/clarke.dat (free whitespace floats, Fortran fill order)."""
    path = os.path.join(inpdir, "clarke.dat")
    with open(path) as f:
        vals = np.array([float(tok) for tok in f.read().split()])
    nfu = 18 * 7
    fu = vals[:nfu].reshape(7, 18).T           # read i-fastest, k slow
    ft = vals[nfu:2 * nfu].reshape(7, 18).T
    xzpdl = vals[2 * nfu:2 * nfu + 18]
    xzpdz0 = vals[2 * nfu + 18:2 * nfu + 25]
    return ClarkeTable(fu=fu, ft=ft, xzpdl=xzpdl, xzpdz0=xzpdz0)


def write_synthetic_clarke_table(inpdir) -> str:
    """Write a stand-in ``clarke.dat`` into inpdir and return its path.

    Not the reference's Clarke values: a smooth table on the reference's
    node layout (18 stability x 7 roughness nodes), for runs and tests
    where the reference input tables are absent.  Both packages read it
    with ``load_clarke_table``, so they see the same inputs.
    """
    xzpdl = np.linspace(-5.5, 3.0, 18)
    xzpdz0 = np.array([1.0, 3.0, 5.0, 8.0, 11.0, 14.0, 17.0])
    stab = (1.0 + 0.3 * np.maximum(xzpdl, 0.0)
            + 0.05 * np.minimum(xzpdl, 0.0))
    fu = xzpdz0[None, :] / 0.4 * stab[:, None]
    ft = 0.9 * fu
    vals = np.concatenate([fu.T.ravel(), ft.T.ravel(), xzpdl, xzpdz0])
    path = os.path.join(str(inpdir), "clarke.dat")
    with open(path, "w") as f:
        f.write("\n".join(f"{v:.17g}" for v in vals) + "\n")
    return path


def claf(table: ClarkeTable, zpdl, zpdz0):
    """Interpolate Clarke functions (cu for momentum, ctq for heat).

    zpdl, zpdz0: tensors of one shape (typically [B]).  The table may hold
    numpy arrays or tensors; it is taken in zpdl's dtype and device.
    """
    tab = table.to(zpdl.dtype, zpdl.device)
    fu, ft, xzpdl, xzpdz0 = tab.fu, tab.ft, tab.xzpdl, tab.xzpdz0

    zpdla = torch.clamp(zpdl, -5.5, 3.0)
    zpdz0a = torch.clamp(zpdz0, max=17.0)

    # nl: first node index with xzpdl[nl] > zpdla (0-based, in 1..17)
    nl = torch.clamp(torch.searchsorted(xzpdl, zpdla, right=True), 1, 17)
    # nz: first node index with xzpdz0[nz] > zpdz0a (0-based, in 0..6)
    nz = torch.clamp(torch.searchsorted(xzpdz0, zpdz0a, right=True), 0, 6)

    dx = (zpdla - xzpdl[nl - 1]) / (xzpdl[nl] - xzpdl[nl - 1])

    # --- branch nz == 0: scale from the first roughness node --------------
    dy0 = zpdz0a / xzpdz0[0]
    u_b0 = (fu[nl, 0] * dx + fu[nl - 1, 0] * (1.0 - dx)) * dy0
    t_b0 = (ft[nl, 0] * dx + ft[nl - 1, 0] * (1.0 - dx)) * dy0 / 1.35

    # --- branch nz >= 1: bilinear interpolation ---------------------------
    nzs = torch.clamp(nz, min=1)
    dy = (zpdz0a - xzpdz0[nzs - 1]) / (xzpdz0[nzs] - xzpdz0[nzs - 1])

    def bilin(t):
        t00 = t[nl - 1, nzs - 1]
        t10 = t[nl, nzs - 1]
        t01 = t[nl - 1, nzs]
        t11 = t[nl, nzs]
        return t00 + (t10 - t00) * dx + (t01 - t00) * dy \
            + (t11 - t01 + t00 - t10) * dx * dy

    u_b1 = bilin(fu)
    t_b1 = bilin(ft) / 1.35

    u = torch.where(nz == 0, u_b0, u_b1)
    tq_unstable = torch.where(nz == 0, t_b0, t_b1)
    tq = torch.where(zpdl >= 0.0, u / 1.35, tq_unstable)
    return u, tq


def surf0(table: ClarkeTable, met, surf, eta, dt, *, rhsurf=1.0,
          ltwcst=True, ntwopt=1):
    """Water-surface boundary condition; returns (met, surf) updates.

    Out of place: level 0 of t and xm1 is set in fresh copies.
    """
    tw = surf.tw
    if not ltwcst:
        rate = {1: 5.787e-6, 2: 6.94444e-6}[ntwopt]
        tw = tw - rate * dt

    zp21 = p21(tw)
    t0 = tw
    xm1_0 = rhsurf * EPS_RATIO * zp21 / (met.p[:, 0] - ONE_MINUS_EPS * zp21)

    uu, vv = met.u[:, 1], met.v[:, 1]
    vqr = uu * uu + vv * vv
    vbt = torch.sqrt(vqr)

    zp = 0.5 * eta[1] + surf.z0
    zpdz0 = torch.log(zp / surf.z0)
    xnvl = G * (met.theta[:, 1] - tw) * 2.0 / (met.theta[:, 1] + tw)
    zpdl = zp * xnvl / vqr

    cu, ctq = claf(table, zpdl, zpdz0)

    ustern = torch.clamp(vbt / cu, min=0.01)
    z0_new = 0.015 * ustern * ustern / G

    t = met.t.clone()
    t[:, 0] = t0
    xm1 = met.xm1.clone()
    xm1[:, 0] = xm1_0
    met = met.replace(t=t, xm1=xm1)
    surf = surf.replace(tw=tw, ustern=ustern, z0=z0_new, gclu=cu, gclt=ctq)
    return met, surf
