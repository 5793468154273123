# Frozen copy of mistra_tpu_torch/physics/surface.py (lines 1-367, commit b2518445).
"""Surface layer: Clarke-function drag interpolation and the water-surface
boundary condition (torch counterpart of ``mistra_tpu.physics.surface``).

Reference semantics: ``claf`` (str.f90:4369-4477) interpolates tabulated
Clarke functions read from ``input/clarke.dat``; ``surf0``
(str.f90:3954-4071) applies the constant-SST water surface with forced
relative humidity and Charnock roughness; ``soil`` (str.f90:3842-3953) and
``surf1`` (str.f90:4072-4342) are the bare-soil surface of isurf=1.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from ..constants import CP, EPS_RATIO, G, ONE_MINUS_EPS, R1
from ..utils.tridiag import implicit_sweep
from .growth import xl21
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


# --------------------------------------------------------------------------
# Bare-soil surface (isurf=1): soil diffusion + surface energy balance
# --------------------------------------------------------------------------

# sandy-loam soil constants (reference data_surface.f90:63-71)
AKS = 3.41e-5     # saturated hydraulic conductivity [m/s]
ANU0 = 43.415524  # thermal conductivity reference
BS = 4.9          # moisture potential exponent
BS0 = 2.128043    # conductivity exponent
EBC = 0.0742724   # reference soil moisture
EBS = 0.435       # volumetric porosity
PSIS = -0.218     # saturated moisture potential [m]
RHOC = 1.34e6     # volumetric heat capacity, dry soil [J/m3/K]
RHOCW = 4.186e6   # volumetric heat capacity, water [J/m3/K]
AL31 = 2.835e6    # latent heat of sublimation [J/kg]
SIGMA_SB = 5.6697e-8
T0C = 273.15
# surf1's Newton iteration: a fixed count, converged columns frozen
SURF1_ITERS = 20


def p31(t):
    """Saturation vapour pressure over ice [Pa] (Goff-Gratch form)."""
    t1 = 273.16
    xlog10 = (-9.09685 * (t1 / t - 1.0) - 3.56654 * torch.log10(t1 / t)
              + 0.87682 * (1.0 - t / t1) + 0.78614)
    return 100.0 * 10.0 ** xlog10


def _lower_coefficient(xa, dzbw):
    """xc[k] = xa[k-1] dzbw[k-1] / dzbw[k], xc[0] = 0; xa [B, nb]."""
    return torch.cat([torch.zeros_like(xa[:, :1]),
                      xa[:, :-1] * dzbw[:-1] / dzbw[1:]], dim=1)


def soil(surf, soil_grid, dt):
    """Implicit heat and moisture diffusion in the soil columns
    (str.f90:3842-3953); tb, eb [B, nb].  Returns the new surface state."""
    tb, eb = surf.tb, surf.eb

    def t(x):
        return torch.as_tensor(x, dtype=tb.dtype, device=tb.device)

    dzb, dzbw = t(soil_grid.dzb), t(soil_grid.dzbw)

    # soil temperature: conductivity depends on moisture
    x0 = torch.clamp(eb, min=EBC)
    akb = ANU0 * x0 ** BS0 / ((1.0 - EBS) * RHOC + eb * RHOCW)
    xa = akb * dt / (dzbw * dzb)
    tb_new = implicit_sweep(xa, _lower_coefficient(xa, dzbw),
                            tb[:, :, None])[:, :, 0]

    # volumetric moisture: hydraulic conductivity ak and diffusivity d
    x0c = 2.0 * BS + 3.0
    x1c = BS + 2.0
    x2c = -BS * AKS * PSIS / EBS
    ebp = torch.cat([eb[:, 1:], eb[:, -1:]], dim=1)
    x3 = (eb + dzbw * (ebp - eb) / (2.0 * dzb)) / EBS
    ak = AKS * x3 ** x0c
    d = x2c * x3 ** x1c
    ak = torch.cat([torch.zeros_like(ak[:, :1]), ak[:, 1:]], dim=1)
    de = eb[:, 1] - eb[:, 0]
    d0 = torch.where(torch.abs(de) > 1.0e-5,
                     surf.ajm * dzb[0] / (1000.0 * de), 0.0)
    d = torch.cat([d0[:, None], d[:, 1:]], dim=1)
    xa_m = d * dt / (dzbw * dzb)
    akm = torch.cat([torch.zeros_like(ak[:, :1]), ak[:, :-1]], dim=1)
    rhs = eb + dt / dzbw * (akm - ak)
    rhs = torch.cat([eb[:, :1], rhs[:, 1:]], dim=1)
    eb_new = implicit_sweep(xa_m, _lower_coefficient(xa_m, dzbw),
                            eb[:, :, None], rhs=rhs[:, :, None])[:, :, 0]
    return surf.replace(tb=tb_new, eb=eb_new)


def surf1(table, met, surf, rad, atm_grid, soil_grid, dt):
    """Bare-soil surface energy/moisture balance (str.f90:4072-4342) of a
    column batch.

    2-D Newton-Raphson iteration on the surface temperature Ts and the
    top-layer soil moisture eta1, balancing radiation, soil heat flux,
    latent and sensible fluxes; includes the dew (tau) and rime (reif)
    reservoirs.  The iteration runs SURF1_ITERS times for every column
    and freezes a column once it has converged (no host sync).  Returns
    (met', surf').
    """
    dtype, dev = met.t.dtype, met.t.device
    dzb0 = float(soil_grid.dzb[0])
    rrho = met.rho[:, 0]
    uu, vv = met.u[:, 1], met.v[:, 1]
    vqr = torch.clamp(uu * uu + vv * vv, min=1.0e-12)
    vbt = torch.sqrt(vqr)
    bs3 = 2.0 * BS + 3.0
    psi2 = PSIS * (EBS / surf.eb[:, 1]) ** BS
    qq2 = met.xm1[:, 1]
    ps = met.p[:, 0]
    theta1 = met.theta[:, 1]
    tb2 = surf.tb[:, 1]
    eb2 = surf.eb[:, 1]
    sk, sl = rad.sk, rad.sl
    ajs, tau, reif = surf.ajs, surf.tau, surf.reif

    zp = atm_grid.deta[0] + surf.z0
    zpdz0 = torch.log(zp / surf.z0)

    def cm(pp):
        return 0.62198 * pp / (ps - 0.37802 * pp)

    def clarke(ts):
        xnvl = G * (theta1 - ts) * 2.0 / (theta1 + ts)
        zpdl = zp * xnvl / vqr
        cu, ctq = claf(table, zpdl, zpdz0)
        ustern = torch.clamp(vbt / cu, min=0.01)
        return cu, ctq, ustern

    _, ctq, ustern = clarke(met.t[:, 0])

    def fluxes(ts, eb1, ddew):
        xm21s = torch.where(ts >= T0C, cm(p21(ts)), cm(p31(ts)))
        psi1 = PSIS * (EBS / eb1) ** BS
        qs = xm21s * torch.exp(G * psi1 / (R1 * ts))
        tst = (theta1 - ts * (1.0 + 0.608 * qs)) / ctq
        qst = (qq2 - qs) / ctq
        anu = ANU0 * torch.clamp(eb1, min=EBC) ** BS0
        ajb = anu * (tb2 - ts) / dzb0
        ajq = rrho * ustern * qst
        ajl = torch.where(ts < T0C, AL31 * ajq - (AL31 - xl21(ts)) * ajs,
                          xl21(ts) * ajq)
        ajt = rrho * CP * ustern * tst
        rak1 = 1000.0 * AKS * ((0.5 * eb1 + 0.5 * eb2) / EBS) ** bs3
        ajm = rak1 * ((psi2 - psi1) / dzb0 - 1.0)
        x0 = ajq + ajm + ajs
        sat = eb1 >= EBS
        ddew0 = tau / dt
        ajd = torch.where(sat, torch.where(x0 < 0.0,
                                           torch.minimum(-x0, ddew0), -x0),
                          0.0)
        ddew_new = torch.where(sat, ddew0 - ajd, ddew)
        fts = sl + sk + ajb + ajl + ajt - SIGMA_SB * ts ** 4
        fqs = x0 + ajd
        return dict(fts=fts, fqs=fqs, xm21s=xm21s, psi1=psi1, qs=qs,
                    anu=anu, ajb=ajb, ajq=ajq, ajl=ajl, ajt=ajt, ajm=ajm,
                    ajd=ajd, rak1=rak1, ddew=ddew_new)

    ts = met.t[:, 0]
    eb1 = surf.eb[:, 0]
    flx = fluxes(ts, eb1, torch.zeros_like(ts))
    done = torch.zeros(ts.shape, dtype=torch.bool, device=dev)
    for _ in range(SURF1_ITERS):
        psi1, qs, anu, ajb, ajq, rak1 = (flx[k] for k in (
            "psi1", "qs", "anu", "ajb", "ajq", "rak1"))
        fts, fqs, ddew_c = flx["fts"], flx["fqs"], flx["ddew"]
        djbde = torch.where(eb1 > EBC, ajb * BS0 / eb1, 0.0)
        djbdt = -anu / dzb0
        djqde = rrho * ustern * qs * G * BS * psi1 / (ctq * R1 * ts * eb1)
        x0p = p21(ts)
        djqdt = rrho * ustern * qs / ctq * (
            G * psi1 / (R1 * ts * ts)
            + x0p * 4027.163 / ((x0p - 0.37802 * ps) * (ts - 38.33) ** 2))
        djtdt = -rrho * CP * ustern / ctq
        djmde = rak1 / dzb0 * psi1 * BS / eb1
        xl = xl21(ts)
        f1e = djbde + xl * djqde
        f1t = djbdt - 2335.5 * ajq + xl * djqdt + djtdt \
            - 4.0 * SIGMA_SB * ts ** 3
        f2e = djqde + djmde
        f2t = djqdt
        det = f1e * f2t - f1t * f2e
        det = torch.where(torch.abs(det) < 1.0e-10,
                          torch.sign(det) * 1.0e-10 + 1.0e-10, det)
        ts_new = ts + (fts * f2e - fqs * f1e) / det
        eb1_new = eb1 + (fqs * f1t - fts * f2t) / det
        eb1_new = torch.clamp(eb1_new, EBS / 15.0, EBS)
        eb1_new = torch.where(ddew_c > 0.0, EBS, eb1_new)
        ts_new = torch.where((ts_new > 300.0) | (ts_new < 250.0),
                             ts - 0.01, ts_new)
        flx_new = fluxes(ts_new, eb1_new, ddew_c)
        conv = ((torch.abs(ts_new - ts) <= 1.0e-2)
                & (torch.abs(eb1_new - eb1) <= 1.0e-3)) \
            | ((torch.abs(flx_new["fts"]) <= 0.1)
               & (torch.abs(flx_new["fqs"])
                  <= 0.1 * torch.abs(flx_new["ajq"])))
        ts = torch.where(done, ts, ts_new)
        eb1 = torch.where(done, eb1, eb1_new)
        flx = {k: torch.where(done, flx[k], flx_new[k]) for k in flx}
        done = done | conv

    fts, xm21s, qs, ajd = flx["fts"], flx["xm21s"], flx["qs"], flx["ajd"]

    # dew / rime bookkeeping
    l1 = ((tau > 0.0) & (ts < T0C)) | ((ts > T0C) & (reif > 0.0))
    ts = torch.where(l1, torch.full_like(ts, T0C), ts)
    tau = torch.where(ts >= T0C, tau - ajd * dt, tau)
    reif = torch.where(ts < T0C, reif - ajd * dt, reif)
    uwr = torch.minimum(torch.maximum(dt * fts / 3.35e5, -tau), reif)
    tau = torch.where(l1, tau + uwr, tau)
    reif = torch.where(l1, reif - uwr, reif)
    tau = torch.clamp(tau, min=0.0)
    reif = torch.clamp(reif, min=0.0)

    cu2, ctq2, ustern2 = clarke(ts)

    def at0(x, v):
        return torch.cat([v[:, None], x[:, 1:]], dim=1)

    met = met.replace(t=at0(met.t, ts), xm1=at0(met.xm1, qs),
                      feu=at0(met.feu, qs / xm21s))
    surf = surf.replace(tb=at0(surf.tb, ts), eb=at0(surf.eb, eb1),
                        tau=tau, reif=reif, ajb=flx["ajb"], ajq=flx["ajq"],
                        ajl=flx["ajl"], ajt=flx["ajt"], ajm=flx["ajm"],
                        ajd=ajd, ustern=ustern2, gclu=cu2, gclt=ctq2)
    return met, surf
