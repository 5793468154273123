"""Initial meteorological state and aerosol loading.

Parity with the reference initializer (``initm``, str.f90:782-1475):
solar-time constants, the inversion-capped temperature/humidity/wind
profiles, hydrostatic pressure, log-normal aerosol size distributions
(Jaenicke-88 / Hoppel-90/94 / polar / chamber sets) and the Koehler-curve
coefficients.  All host-side numpy float64; the result seeds the state.

Torch counterpart of ``mistra_tpu.init``: the host code is the same; the
state is built as one column ([1, ...] tensors on the CPU) in the
configuration's dtype.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from .config import MistraConfig
from .constants import G, GAMMA_DRY, PI, R0
from .grids import Grids
from .state import torch_dtype, zeros_state

_DAYS_PER_MONTH = [31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31]


@dataclass(frozen=True)
class AstroConsts:
    """Solar geometry constants fixed for the whole run."""
    declin: float      # solar declination [deg]
    alat: float        # latitude [deg]
    time_corr: float   # equation-of-time + longitude correction [h]
    day_of_year: int


def solar_constants(cfg: MistraConfig) -> AstroConsts:
    doy = sum(_DAYS_PER_MONTH[: cfg.nmonth - 1]) + cfg.nday
    if cfg.nyear % 4 == 0 and cfg.nmonth >= 3:
        doy += 1
        tot = 366
    else:
        tot = 365
    gam = 2.0 * PI * (doy - 1) / tot
    # equation of time [h]
    deltat = 24.0 / (2.0 * PI) * (
        0.0000075 + 0.001868 * math.cos(gam) - 0.032077 * math.sin(gam)
        - 0.014615 * math.cos(2 * gam) - 0.040849 * math.sin(2 * gam))
    tkorr = 4.0 * cfg.alon / 60.0 + deltat
    rdec = (0.006918 - 0.399912 * math.cos(gam) + 0.070257 * math.sin(gam)
            - 0.006758 * math.cos(2 * gam) + 0.000907 * math.sin(2 * gam))
    declin = math.degrees(rdec)
    if cfg.chamber:
        declin = 18.0
    return AstroConsts(declin=declin, alat=cfg.alat, time_corr=tkorr,
                       day_of_year=doy)


# --------------------------------------------------------------------------
# Aerosol size-distribution constant sets [type 1..4 x mode 1..3]
# --------------------------------------------------------------------------

def _distribution_constants(jp_set: int):
    """Log-normal superposition constants (wn, wr, ws) per aerosol type.

    Types: 0=urban, 1=rural, 2=ocean, 3=background (0-based).
    Set 0: Jaenicke (1988).  Set 1: + Hoppel et al. 1990 maritime.
    Set 2: Hoppel et al. 1994 maritime.  Set 3: polar (Jaenicke 1988 #164).
    Set 4: chamber special case.
    """
    # Jaenicke 1988 baseline, indexed [type, mode]
    wn = np.array([[1.6169e5, 664.9, 4.3091e4],
                   [1.1791e4, 105.29, 2.9846e3],
                   [80.76, 126.52, 3.0827],
                   [79.788, 94.138, 0.0596]])
    wr = np.array([[6.51e-3, 7.14e-3, 0.0248],
                   [7.39e-3, 0.0269, 0.0419],
                   [3.9e-3, 0.133, 0.29],
                   [3.6e-3, 0.127, 0.259]])
    ws = np.array([[8.3299, 1.1273, 4.4026],
                   [9.8765, 1.6116, 7.0665],
                   [1.1583, 11.338, 3.1885],
                   [1.2019, 7.8114, 2.7682]])
    if jp_set == 0:
        pass
    elif jp_set == 1:  # Hoppel et al. 1990 maritime replaces type 3
        wn[2] = [159.576, 427.438, 5.322]
        wr[2] = [0.027, 0.105, 0.12]
        ws[2] = [8.0, 39.86, 2.469]
    elif jp_set == 2:  # Hoppel et al. 1994 maritime
        wr[2] = [0.02, 0.05, 0.15]
        raw_n = np.array([110.0, 72.0, 7.0])
        raw_s = np.array([0.14, 0.16, 0.18])
        wn[2] = raw_n / (math.sqrt(2 * PI) * raw_s)
        ws[2] = 1.0 / (2.0 * raw_s ** 2)
    elif jp_set == 3:  # polar, Jaenicke 1988 #164
        wr[2] = [6.89e-2, 3.75e-1, 4.29]
        raw_n = np.array([21.7, 0.186, 3.04e-4])
        raw_s = np.array([0.245, 0.300, 0.291])
        wn[2] = raw_n / (math.sqrt(2 * PI) * raw_s)
        ws[2] = 1.0 / (2.0 * raw_s ** 2)
    elif jp_set == 4:  # chamber
        wn[1] = [-0.17e2, 0.0, 0.53e2]
        wr[1] = [1.4, 0.0, 0.357]
        ws[1] = [-0.125, 0.0, 0.126]
    else:
        raise ValueError(f"unknown jpPartDistSet {jp_set}")
    return wn, wr, ws


def dfdlogr(r, wn, wr, ws, nmodes=3):
    """Tri-modal log-normal dN/dlog(r) for one aerosol type."""
    out = np.zeros_like(r)
    for m in range(nmodes):
        out += wn[m] * np.exp(-ws[m] * np.log10(r / wr[m]) ** 2)
    return out


# --------------------------------------------------------------------------
# Koehler coefficients (solubility per aerosol type; str.f90:1311-1410)
# --------------------------------------------------------------------------

def koehler_coefficients(cfg: MistraConfig, rn: np.ndarray):
    """Returns (a0m, b0m[nka], fcs[nka], xmol3[nka])."""
    from .constants import R1, RHOW
    xmol2 = 18.0
    nka = rn.shape[0]
    fcs = np.empty(nka)
    xmol3 = np.empty(nka)
    xnue = np.empty(nka)
    ktype = cfg.iaertyp
    for ia in range(nka):
        if ktype == 1:  # urban: 2 NH4NO3 + 1 (NH4)2SO4
            if not cfg.lp_joyce14bc:
                fcs[ia] = 0.4 - rn[ia] * 0.3 if rn[ia] <= 1.0 else 0.1
                xnue[ia] = (3.0 + 2.0 * 2.0) / 3.0
                xmol3[ia] = (132.0 + 80.0 * 2.0) / 3.0
            else:
                fcs[ia] = 0.9 - rn[ia] * 0.4 if rn[ia] <= 1.0 else 0.1
                xnue[ia] = 3.0 / 4.0
                xmol3[ia] = (98.08 + 122.21 + 35.45) / 4.0
        elif ktype == 2:  # rural: (NH4)2SO4
            fcs[ia] = 0.9 - rn[ia] * 0.4 if rn[ia] <= 1.0 else 0.5
            xnue[ia] = 3.0
            xmol3[ia] = 132.0
        else:  # maritime (3) and background (4): sulfate mix / NaCl
            fcs[ia] = 1.0
            xnue[ia] = 0.32 * 3 + 0.64 * 2 + 0.04 * 2
            xmol3[ia] = 0.32 * 132 + 0.64 * 115 + 0.04 * 80
            if rn[ia] >= 0.5:
                xnue[ia] = 2.0
                xmol3[ia] = 58.4
            if cfg.lp_buys13_0d:
                fcs[ia] = 0.0
                xnue[ia] = 2.0
                xmol3[ia] = 58.4
    a0m = 152200.0 / (R1 * RHOW)
    b0m = fcs * xnue * xmol2 / xmol3
    return a0m, b0m, fcs, xmol3


# --------------------------------------------------------------------------


def initial_state(cfg: MistraConfig, grids: Grids, clarke_table) -> tuple:
    """Build the initial state of one column on the host.

    Returns (state, consts): state tensors are [1, ...] on the CPU in the
    configuration's dtype; consts holds the numpy Koehler coefficients,
    aerosol types and astro constants, as in the JAX package.
    """
    from .physics.surface import claf

    gp = cfg.grid
    n, nf, nka, nkt = gp.n, gp.nf, gp.nka, gp.nkt
    eta, etw = grids.atm.eta, grids.atm.etw
    deta, detw = grids.atm.deta, grids.atm.detw

    # inversion layer (first k with eta[k] < zinv <= eta[k+1])
    kinv = 1
    for k in range(1, nf):
        if grids.atm.eta[k] < cfg.zinv <= grids.atm.eta[k + 1]:
            kinv = k
            break
    if kinv == 1:
        raise ValueError(f"zinv={cfg.zinv} below the second model layer")

    # temperature: dry adiabatic below the inversion, stable above
    t = np.empty(n)
    t[0] = cfg.tw
    t[1:kinv + 1] = t[0] - GAMMA_DRY * eta[1:kinv + 1]
    t_top = t[kinv] + cfg.dtinv
    t[kinv + 1:] = t_top - 0.006 * (eta[kinv + 1:] - eta[kinv])

    # hydrostatic pressure (layer-integrated form of the reference)
    p = np.empty(n)
    poben = cfg.rp0
    cc = G / (2.0 * R0)
    for k in range(n):
        punten = poben
        dd = detw[k] * cc / t[k]
        poben = punten * (1.0 - dd) / (1.0 + dd)
        p[k] = 0.5 * (poben + punten)

    thet = (p[0] / p) ** 0.286
    theta = t * thet
    es = 610.7 * np.exp(17.15 * (t - 273.15) / (t - 38.33))
    xm21s = 0.62198 * es / (p - 0.37802 * es)
    xm1 = np.where(np.arange(n) <= kinv,
                   np.minimum(cfg.xm1w, cfg.rh_max_bl * xm21s),
                   np.minimum(cfg.xm1i, cfg.rh_max_ft * xm21s))
    feu = xm1 * p / ((0.62198 + 0.37802 * xm1) * es)
    rho = p / (R0 * t * (1.0 + 0.61 * xm1))
    thetl = theta * (1.0 + 0.61 * xm1)

    # winds
    ks = np.arange(n)
    if cfg.nuv_prof_opt == 0:
        u = np.full(n, cfg.ug)
        v = np.full(n, cfg.vg)
        u[0], v[0] = 0.0, 0.0
        u[1], v[1] = 0.25 * cfg.ug, 0.25 * cfg.vg
        u[2], v[2] = 0.75 * cfg.ug, 0.75 * cfg.vg
    else:  # linear below inversion (Bott 2020)
        u = np.where(ks <= kinv, cfg.ug / cfg.zinv * eta, cfg.ug)
        v = np.where(ks <= kinv, cfg.vg / cfg.zinv * eta, cfg.vg)

    # subsidence profile
    if cfg.nw_prof_opt == 1:
        w = 0.5 * cfg.wmax * (np.tanh((eta - 500.0) / 250.0) + 1.0)
    elif cfg.nw_prof_opt == 2:
        w = eta / 1000.0 * 0.5 * (cfg.wmin + cfg.wmax)
    else:
        w = np.where(ks <= kinv,
                     (cfg.wmax - cfg.wmin) / cfg.zinv * eta + cfg.wmin,
                     cfg.wmax)
    w = w - w[0]

    tke = np.where(ks <= kinv, 0.05, 1.0e-5)
    buoy = np.full(n, -1.0e-4)

    # aerosol loading
    wn, wr, ws = _distribution_constants(cfg.jp_part_dist_set)
    ityp = cfg.iaertyp - 1
    rn = grids.micro.rn
    ff = np.zeros((nkt, nka, n))
    base = dfdlogr(rn, wn[ityp], wr[ityp], ws[ityp]) * grids.micro.dlgenw / 3.0
    base2 = (wn[ityp][0] * np.exp(-ws[ityp][0] * np.log10(rn / wr[ityp][0]) ** 2)
             + wn[ityp][1] * np.exp(-ws[ityp][1] * np.log10(rn / wr[ityp][1]) ** 2)
             ) * grids.micro.dlgenw / 3.0  # two-mode variant above inversion
    for k in range(n):
        if cfg.lp_joyce14bc:
            x0 = 1.0e-4
        else:
            x0 = 0.2 if (cfg.iaertyp < 3 and k + 1 > nf) else 1.0
        ff[0, :, k] = (base2 if k > kinv else base) * x0
    fsum = ff.sum(axis=(0, 1))

    a0m, b0m, fcs, xmol3 = koehler_coefficients(cfg, rn)

    # aerosol type per level for radiation (background -> rural above surface)
    nar = np.full(n, cfg.iaertyp, dtype=np.int32)
    if cfg.iaertyp == 4:
        nar[1:] = 2

    # initial Clarke functions / frictional velocity (str.f90:1414-1424);
    # host float64 scalars, one per configuration
    vbt = math.sqrt(u[1] ** 2 + v[1] ** 2)
    zp = deta[0] + cfg.z0
    zpdz0 = math.log(zp / cfg.z0)
    zpdl = G * (theta[1] - t[0]) * zp / (theta[1] * vbt)
    cu, ctq = claf(clarke_table, torch.tensor([zpdl], dtype=torch.float64),
                   torch.tensor([zpdz0], dtype=torch.float64))
    cu, ctq = float(cu[0]), float(ctq[0])
    ustern = max(0.01, vbt / cu)

    # soil
    nb = gp.nb
    tb = np.full(nb, 285.0)
    ebs = 0.435
    eb = np.full(nb, 0.5 * ebs)
    zb = grids.soil.zb
    shallow = zb < 0.1
    tb[shallow] = (t[0] * (0.1 - zb[shallow]) + 285.0 * zb[shallow]) / 0.1

    state = zeros_state(cfg, 1)
    dt = torch_dtype(cfg)

    def a(x):
        return torch.as_tensor(np.asarray(x, dtype=np.float64),
                               dtype=dt)[None]

    def i32(x):
        return torch.tensor([x], dtype=torch.int32)

    met = state.met.replace(
        u=a(u), v=a(v), w=a(w), t=a(t), theta=a(theta), thetl=a(thetl),
        talt=a(t), p=a(p), rho=a(rho), xm1=a(xm1), xm1a=a(xm1),
        xm2=a(np.zeros(n)), feu=a(feu), dfddt=a(np.zeros(n)), tke=a(tke),
        tkep=a(np.zeros(n)), buoy=a(buoy))
    surf = state.surf.replace(
        tw=a(cfg.tw), ustern=a(ustern), z0=a(cfg.z0), gclu=a(cu),
        gclt=a(ctq), tb=a(tb), eb=a(eb))
    micro = state.micro.replace(ff=a(ff), fsum=a(fsum),
                                lcl=i32(0), lct=i32(0))
    tim = state.tim.replace(lst=i32(cfg.nhour), kinv=i32(kinv))
    state = state.replace(met=met, surf=surf, micro=micro, tim=tim)

    consts = {
        "astro": solar_constants(cfg),
        "a0m": a0m,
        "b0m": b0m,
        "fcs": fcs,
        "xmol3": xmol3,
        "nar": nar,
        "kinv0": kinv,
    }
    return state, consts
