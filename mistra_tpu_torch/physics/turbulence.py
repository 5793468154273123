"""Mellor-Yamada 2.5 turbulence closure over a column batch.

Torch counterpart of ``mistra_tpu.physics.turbulence`` (``atk1``,
str.f90:3549-3841, and the startup variant ``atk0``, str.f90:3451-3543).
Fields are [B, n]; the grid arrays are [n] tensors in the state's dtype.
The inversion searches and the mixing-length sums, implicit per column
under ``vmap`` in the JAX package, reduce over the level axis (dim 1).
"""

from __future__ import annotations

import torch

from ..constants import G, KAPPA
from .thermo import p21

# Mellor & Yamada closure constants (eq. 45) and BTZ96 a1..a9 composition
MY_A1 = 0.92
MY_B1 = 16.6
MY_A2 = 0.74
MY_B2 = 10.1
MY_C1 = 0.08
A1 = MY_A2
A2 = -9.0 * MY_A1 * MY_A2 ** 2
A3 = 18.0 * MY_A1 ** 2 * MY_A2 * MY_C1
A4 = MY_A1 * (1.0 - 3.0 * MY_C1)
A5 = 3.0 * MY_A1 * MY_A2 * (3.0 * MY_A2 + MY_B2 * (3.0 * MY_C1 - 1.0)
                            + 12.0 * MY_A1 * MY_C1)
A6 = -3.0 * MY_A2 * (7.0 * MY_A1 + MY_B2)
A7 = 27.0 * MY_A1 * MY_A2 ** 2 * (4.0 * MY_A1 + MY_B2)
A8 = 6.0 * MY_A1 ** 2
A9 = 18.0 * MY_A1 ** 2 * MY_A2 * (3.0 * MY_A2 - MY_B2)
EPS_DISS = 1.0 / MY_B1

# exponential time filters (old-value fractions)
F_BUOY_OLD = 0.8
F_SH_OLD = 0.8
F_SM_OLD = 0.8
F_XL_OLD = 0.95

GH_MIN = -0.6
GH_MAX = 0.03


def _diff(x):
    """Forward difference along levels, last level repeated (np.diff
    with append=x[-1:])."""
    return torch.diff(x, dim=1, append=x[:, -1:])


def atk0(met, turb, surf, grid, ug, vg, z0):
    """Initial exchange coefficients and mixing length (model start)."""
    eta, etw, deta = grid.eta, grid.etw, grid.deta
    B = met.u.shape[0]
    u, v, theta = met.u, met.v, met.theta

    x1 = (ug + vg) * 2.7
    x2 = KAPPA * etw
    xl = x2 * x1 / (x2 + x1)
    xl = torch.minimum(xl, deta)
    xl = torch.cat([torch.zeros_like(xl[:1]), xl[1:]])

    atkm0 = 0.5 * eta[1] * surf.ustern / surf.gclu
    atkh0 = 0.5 * eta[1] * surf.ustern / surf.gclt

    # interior levels k = 1..n-2
    du = u[:, 2:] - u[:, 1:-1]
    dv = v[:, 2:] - v[:, 1:-1]
    vh = (du ** 2 + dv ** 2) / deta[1:-1] ** 2
    zz = etw[1:-1] + z0
    x0 = (0.4 * zz / (1.0 + 0.4 * zz / xl[1:-1])) ** 2
    st = G * (theta[:, 2:] - theta[:, 1:-1]) / (deta[1:-1] * theta[:, 1:-1])

    unstable = st <= 0.0
    atkm_u = x0 * torch.sqrt(torch.clamp(vh - 11.0 * st, min=0.0))
    atkh_u = torch.where(vh - 3.0 * st == 0.0, atkm_u,
                         1.35 * atkm_u * (vh - 5.5 * st) / (vh - 3.0 * st))
    atkm_s = x0 * vh / torch.sqrt(vh + 6.0 * st)
    atkh_s = 1.35 * atkm_s * vh / (vh + 6.0 * st)

    atkm_i = torch.clamp(torch.where(unstable, atkm_u, atkm_s), min=1.0e-3)
    atkh_i = torch.clamp(torch.where(unstable, atkh_u, atkh_s), min=1.0e-3)

    zero = torch.zeros_like(atkm0[:, None])
    atkm = torch.cat([atkm0[:, None], atkm_i, zero], dim=1)
    atkh = torch.cat([atkh0[:, None], atkh_i, zero], dim=1)
    return turb.replace(atkm=atkm, atkh=atkh,
                        xl=xl.expand(B, -1).clone())


def atk1(met, turb, surf, micro, grid):
    """One closure update: returns (met', turb', kinv [B] int32).

    met' carries updated buoy/thetl/tkep; turb' the new exchange
    coefficients, stability functions, mixing length and TKE production.
    """
    eta, etw, deta, detw = grid.eta, grid.etw, grid.deta, grid.detw
    n = eta.shape[0]
    k = torch.arange(n, device=eta.device)
    interior = (k >= 1) & (k <= n - 2)  # Fortran 2..nm

    theta, xm1, xm2, rho, t = met.theta, met.xm1, met.xm2, met.rho, met.t
    thet = (met.p[:, :1] / met.p) ** 0.286
    theti = 1.0 / thet
    lcl = micro.lcl[:, None].long()     # 0-based layer indices, [B, 1]
    lct = micro.lct[:, None].long()

    dtheta = _diff(theta)
    dxm1 = _diff(xm1)

    # ---------------- cloud-free buoyancy ---------------------------------
    x0_free = ((1.0 + 0.61 * xm1) * dtheta + 0.61 * theta * dxm1) / deta
    sm_free = torch.where(interior, x0_free, turb.sm)
    sh_free = torch.where(interior, x0_free, turb.sh)
    buoy_free = torch.where(
        interior, F_BUOY_OLD * met.buoy + (1 - F_BUOY_OLD) * x0_free,
        met.buoy)
    thetl_free = torch.where(interior, (1.0 + 0.61 * xm1) * theta, met.thetl)
    # inversion level: first k >= 9 (0-based) with buoy > 1e-5, else n-1
    cand_free = (k >= 9) & (buoy_free > 1.0e-5)
    kinv_free = torch.where(cand_free.any(dim=1),
                            cand_free.to(torch.int32).argmax(dim=1), n - 1)

    # ---------------- cloudy buoyancy (Bott 1997 moist closure) ------------
    thetl_c = theta - 2465.1 * thet * xm2 / rho
    thetl_c = torch.cat([thetl_c[:, :n - 1], thetl_c[:, n - 2:n - 1] + 1.0],
                        dim=1)
    xmw = xm1 + xm2 / rho
    dthetl = _diff(thetl_c) / deta
    dmw = _diff(xmw) / deta
    x0_sh = (1.0 + 0.61 * xmw) * dthetl + 0.61 * thetl_c * dmw
    sh_cloud = torch.where(
        interior, F_SH_OLD * turb.sh + (1 - F_SH_OLD) * x0_sh, turb.sh)

    ql = xm2 / rho
    esat = p21(t)
    qs = 0.62198 * esat / (met.p - 0.37802 * esat)
    qslt = 5368.0 * qs / (t * t)
    xa = 1.0 / (1.0 + 2465.1 * qslt)
    xb = xa * theti * qslt
    betat = 1.0 + 0.61 * xm1 - ql
    betaw = 0.61 * (thetl_c + 2465.1 * thet * ql)
    betal = (1.0 + 0.61 * xmw - 3.22 * ql) * 2465.1 * thet - 1.61 * thetl_c
    x0_sm = (betat - xb * betal) * dthetl + (betaw + xa * betal) * dmw
    below_top = (k >= 1) & (k < lct)  # Fortran 2..lct-1
    sm_cloud = torch.where(
        below_top, F_SM_OLD * turb.sm + (1 - F_SM_OLD) * x0_sm, turb.sm)
    alpha = torch.exp(60.0 * (torch.clamp(met.feu, max=1.0) - 1.0))
    betal_a = betal * alpha
    x0_b = (betat - xb * betal_a) * dthetl + (betaw + xa * betal_a) * dmw
    buoy_cloud = torch.where(
        below_top, F_BUOY_OLD * met.buoy + (1 - F_BUOY_OLD) * x0_b, met.buoy)
    buoy_cloud = torch.where((k >= lct) & (k <= n - 2), sh_cloud, buoy_cloud)
    # inversion level near cloud top
    in_win = (k >= lct - 4) & (k <= lct + 4) & (buoy_cloud > 1.0e-5)
    kinv_win = torch.where(
        in_win.any(dim=1),
        torch.where(in_win, k, n + 99).amin(dim=1), lct[:, 0] + 5)
    kinv_cloud = kinv_win - 1

    # ---------------- select branch ---------------------------------------
    cloudy = lct > lcl + 2                                  # [B, 1]
    sm = torch.where(cloudy, sm_cloud, sm_free)
    sh = torch.where(cloudy, sh_cloud, sh_free)
    buoy = torch.where(cloudy, buoy_cloud, buoy_free)
    thetl = torch.where(cloudy, thetl_c, thetl_free)
    kinv = torch.where(cloudy[:, 0], kinv_cloud, kinv_free)
    kinv = torch.clamp(kinv, 2, n - 1).long()               # [B]

    # ---------------- mixing length (eq. 50) ------------------------------
    es = torch.sqrt(2.0 * met.tke)
    below_inv = (k >= 1) & (k < kinv[:, None])  # Fortran 2..kinv-1
    wsum = torch.where(below_inv, es * deta, 0.0)
    x2 = (wsum * etw).sum(dim=1) / wsum.sum(dim=1)          # [B]
    zinv = etw[kinv]
    x4 = 0.1 - detw[kinv] / x2
    x0k = KAPPA * etw
    x1_below = torch.maximum(
        detw, x2[:, None] * (0.1 - x4[:, None]
                             * torch.exp((etw - zinv[:, None]) / 15.0)))
    x1k = torch.where(below_inv, x1_below, detw)
    xl_new = x0k * x1k / (x0k + x1k)
    first = k == 0
    xl_new = torch.where(first, 0.0, xl_new)
    xl = torch.where(interior, F_XL_OLD * turb.xl + (1 - F_XL_OLD) * xl_new,
                     xl_new)
    xl = torch.where(first, 0.0, xl)

    # ---------------- stability functions ---------------------------------
    safe_xl = torch.where(xl > 0.0, xl, 1.0)
    x1g = safe_xl * safe_xl / (es * es)
    ghn = -G * x1g / theta * buoy
    gh = torch.clamp(ghn, GH_MIN, GH_MAX)
    du = _diff(met.u)
    dv = _diff(met.v)
    gmn = x1g * (du ** 2 + dv ** 2) / (deta * deta)
    gm = torch.minimum(gmn, 25.0 * (GH_MAX - gh))
    gh = torch.where(interior, gh, torch.where(first, 0.0, turb.gh))
    gm = torch.where(interior, gm, torch.where(first, 0.0, turb.gm))

    denom = 1.0 / (1.0 + (A6 + A7 * gh) * gh + (A8 + A9 * gh) * gm)
    shn = (A1 + A2 * gh + A3 * gm) * denom
    smn = (A4 + A5 * gh) * denom

    x1p = es ** 3 / safe_xl
    tkeps = torch.where(interior, x1p * smn * gm, turb.tkeps)
    tkepb = torch.where(interior, x1p * shn * gh, turb.tkepb)
    tkepd = torch.where(interior, -x1p * EPS_DISS, turb.tkepd)
    tkep = torch.where(interior, tkeps + tkepb + tkepd, met.tkep)

    x2e = es * xl
    atkh0 = (0.5 * eta[1] * surf.ustern / surf.gclt)[:, None]
    atkm0 = (0.5 * eta[1] * surf.ustern / surf.gclu)[:, None]
    atkh = torch.where(interior, x2e * shn,
                       torch.where(first, atkh0, turb.atkh))
    atkm = torch.where(interior, x2e * smn,
                       torch.where(first, atkm0, turb.atkm))
    atke = torch.where(interior, torch.minimum(atkm, x2e * 0.2),
                       torch.where(first, atkm0, turb.atke))
    # face average over k = 0..n-2
    atke = torch.cat([0.5 * (atke[:, :-1] + atke[:, 1:]), atke[:, -1:]],
                     dim=1)

    met = met.replace(buoy=buoy, thetl=thetl, tkep=tkep)
    turb = turb.replace(atke=atke, atkh=atkh, atkm=atkm, gm=gm, gh=gh,
                        sm=sm, sh=sh, xl=xl, tkeps=tkeps, tkepb=tkepb,
                        tkepd=tkepd)
    return met, turb, kinv.to(torch.int32)
