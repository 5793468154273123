# Frozen copy of mistra_tpu_torch/chemistry/activity.py (lines 1-353, commit b2518445).
"""Pitzer ion-activity coefficients and water activity, in torch.

Port of ``mistra_tpu/chemistry/activity.py`` (the reference activity
module, activity.f90:48-1025: Beiping Luo's simplified Pitzer model with
the unsymmetrical e-theta / E-theta' mixing terms): 3 cations (H+, NH4+,
Na+) x 4 anions (HSO4-, SO4=, NO3-, Cl-).  Every operation broadcasts
over an arbitrary cell batch, so the whole [B, nkc, n] plane computes at
once.

The reference tracks Na+ as an inert charge-balance species
(sion1(20)); as in the JAX package, the Na+ molality is recovered from
the charge balance of the seven Pitzer ions.
"""

from __future__ import annotations

import numpy as np
import torch

T1 = 298.15
T0 = 273.15
ALPHA = 2.0
M_WAT = 18.015e-3

ZC = np.array([1.0, 1.0, 1.0])       # H+, NH4+, Na+
ZA = np.array([1.0, 2.0, 1.0, 1.0])  # HSO4-, SO4=, NO3-, Cl-

# ---------------------------------------------------------------------------
# Pitzer interaction data (activity.f90:421-501)
# ---------------------------------------------------------------------------
BB = np.array([         # H-NO3
    3.895835e-3, -1.55571e-2, 1.703729e-2, -5.6173712e-3, 5.732047e-3,
    0.91622, 0.613523, -0.68489, 0.3038, -0.32888,
    7.6086113e-7, 7.2714678e-5, -1.0037e-4, 3.475e-5, -3.62927e-5,
    5.380465e-2, -2.2163e-2, -1.0166e-2, 6.5423e-3, -8.80248e-3,
    0.907342, -6.78428e-4, 9.576e-4, 0.0, 0.0, 7.769e-3, -5.819e-4])
B2 = np.array([         # H-Cl
    0.23378, -7.21238e-2, -1.7335667e-2, 5.760665e-3, -8.29279e-3,
    0.2897, 7.575434e-2, -1.1474e-3, 0.38038, -0.309442,
    -2.794885e-3, 2.309349e-4, 9.322982e-4, -2.398e-4, 2.85959e-4,
    -0.21154, 0.101481, 5.945618e-2, -0.107864, 8.81749e-2, 1.9916])
B3 = np.array([         # H-HSO4 (1-20,41) and H-SO4 (21-40,42)
    0.148843, -7.769e-2, 2.8062e-2, 4.7903e-4, 7.25e-4,
    0.17843, 0.678, 8.7381e-2, -0.57881, 7.58e-2,
    -9.878e-4, 5.447651e-4, -2.58798e-4, 1.8466527e-5, 1.23457e-5,
    0.37138, -9.24874e-2, -9.21372e-3, -1.065158e-2, 5.4987733e-2,
    0.2726312, -1.34824e-3, -0.24711, 1.25978e-2, 0.11919,
    0.7397, -3.01755, -4.5305, -3.1072, -0.8555842,
    9.2223e-4, -4.1694532e-3, 7.141266e-3, 2.32984e-3, -6.98191e-4,
    -2.242, 0.71925, 2.52, -0.7391, -1.548503, 1.5452, 2.0])
B5 = np.array([         # NH4-HSO4 (without Chan's data)
    -8.746e-4, -2.3125, -9.56785e-6, 2.58238, 2.38,
    -3.1314e-4, 1.6896e-2, -0.7351, 0.6883, 1.813e-3,
    -0.1012515, -2.66e-2, -2.86617e-3, 0.22925, 0.438188,
    2.522e-4, -2.90117e-5, 0.9014, 0.41774, -1035.9,
    0.0, -299.69, 0.0, -4.9687e-4, 0.0,
    1.21485e-2, 0.0, -1.0334e-3, 0.0, 8.48374e-2, 0.0])
B6 = np.array([         # NH4-SO4 (wt=1)
    -1.2058223e-2, 1.1043, 4.79018e-5, 2.14346e-2, 0.58,
    -2.9146e-2, 1.9631e-4, 1.1378, 0.9283, 1.28548e-4,
    1.684e-5, 2.6267e-2, -2.6e-4])
B7 = np.array([         # NH4-NO3
    -2.3275e-2, 0.15, 1.1634e-4, 1.62e-3, 0.43,
    8.78e-2, 0.2753645, -3.349e-4, -1.093e-2,
    -4.769e-2, 0.1776, 1.25e-4, 6.9751e-3])
B8 = np.array([         # NH4-Cl
    -6.333e-4, -3.99546e-4, 0.3155, 0.1414, -3.837e-5,
    1.08331e-4, 5.2436e-2, 1.6827e-2, 1.19])


def _poly4(c, dt, dt2, dt3, dt4):
    return c[0] + dt * c[1] + dt2 * c[2] + dt3 * c[3] + dt4 * c[4]


def calpar(tk):
    """Temperature-dependent Pitzer coefficients b0,b1,c0,c1,omega
    [3,4,...] and ternary parameters xs[11,...] (activity.f90:350-615;
    the Na+ row from activity.f90:271-295); tk a tensor of any shape."""
    dt = (tk - T1) / 100.0
    dt2, dt3, dt4 = dt * dt, dt ** 3, dt ** 4
    z = torch.zeros_like(tk)

    def p4(c0_):
        return _poly4(c0_, dt, dt2, dt3, dt4)

    # H+ row
    b0_h_hso4 = p4(B3[0:5]);  b1_h_hso4 = p4(B3[5:10])
    c0_h_hso4 = p4(B3[10:15]); c1_h_hso4 = p4(B3[15:20])
    b0_h_so4 = p4(B3[20:25]); b1_h_so4 = p4(B3[25:30])
    c0_h_so4 = p4(B3[30:35]); c1_h_so4 = p4(B3[35:40])
    b0_h_no3 = p4(BB[0:5]);   b1_h_no3 = p4(BB[5:10])
    c0_h_no3 = p4(BB[10:15]); c1_h_no3 = p4(BB[15:20])
    b0_h_cl = p4(B2[0:5]);    b1_h_cl = p4(B2[5:10])
    c0_h_cl = p4(B2[10:15]);  c1_h_cl = p4(B2[15:20])

    # NH4+ row (quadratic fits)
    b0_n_hso4 = B5[0] + B5[11] * dt + B5[12] * dt2
    b1_n_hso4 = B5[1] + B5[13] * dt + B5[14] * dt2
    c0_n_hso4 = B5[2] + B5[15] * dt + B5[16] * dt2
    c1_n_hso4 = B5[3] + B5[17] * dt + B5[18] * dt2
    b0_n_so4 = B6[0] + B6[5] * dt + B6[6] * dt2
    b1_n_so4 = B6[1] + B6[7] * dt + B6[8] * dt2
    c0_n_so4 = B6[2] + B6[9] * dt + B6[10] * dt2
    c1_n_so4 = B6[3] + B6[11] * dt + B6[12] * dt2
    b0_n_no3 = B7[0] + B7[5] * dt + B7[9] * dt2
    b1_n_no3 = B7[1] + B7[6] * dt + B7[10] * dt2
    c0_n_no3 = B7[2] + B7[7] * dt + B7[11] * dt2
    c1_n_no3 = B7[3] + B7[8] * dt + B7[12] * dt2
    b0_n_cl = B8[0] + B8[1] * dt + z
    b1_n_cl = B8[2] + B8[3] * dt + z
    c0_n_cl = B8[4] + B8[5] * dt + z
    c1_n_cl = B8[6] + B8[7] * dt + z

    # Na+ row (activity.f90:271-295)
    b0_na_hso4 = 0.0454 + z;  b1_na_hso4 = 0.398 + z
    c0_na_hso4 = z;           c1_na_hso4 = z
    b0_na_so4 = 0.0261 + (tk - T1) * 2.36e-3
    b1_na_so4 = 1.484 + (tk - T1) * 5.63e-3
    c0_na_so4 = 0.00938 - (tk - T1) * 0.172e-3
    c1_na_so4 = z
    b0_na_no3 = 0.0068 + (tk - T1) * 12.66e-4
    b1_na_no3 = 0.1783 + (tk - T1) * 20.6e-4
    c0_na_no3 = -0.00072 / 2.0 - (tk - T1) * 23.16e-5 / 2.0
    c1_na_no3 = z
    b0_na_cl = 0.0765 + (tk - T1) * 7.159e-4
    b1_na_cl = 0.2664 + (tk - T1) * 7.0e-4
    c0_na_cl = 0.00127 / 2.0 - (tk - T1) * 10.5e-5 / 2.0
    c1_na_cl = z

    def rows(h, nh4, na):
        return torch.stack([torch.stack(h), torch.stack(nh4),
                            torch.stack(na)])

    b0 = rows((b0_h_hso4, b0_h_so4, b0_h_no3, b0_h_cl),
              (b0_n_hso4, b0_n_so4, b0_n_no3, b0_n_cl),
              (b0_na_hso4, b0_na_so4, b0_na_no3, b0_na_cl))
    b1 = rows((b1_h_hso4, b1_h_so4, b1_h_no3, b1_h_cl),
              (b1_n_hso4, b1_n_so4, b1_n_no3, b1_n_cl),
              (b1_na_hso4, b1_na_so4, b1_na_no3, b1_na_cl))
    c0 = rows((c0_h_hso4, c0_h_so4, c0_h_no3, c0_h_cl),
              (c0_n_hso4, c0_n_so4, c0_n_no3, c0_n_cl),
              (c0_na_hso4, c0_na_so4, c0_na_no3, c0_na_cl))
    c1 = rows((c1_h_hso4, c1_h_so4, c1_h_no3, c1_h_cl),
              (c1_n_hso4, c1_n_so4, c1_n_no3, c1_n_cl),
              (c1_na_hso4, c1_na_so4, c1_na_no3, c1_na_cl))
    ones = torch.ones_like(tk)
    omega = torch.stack([
        torch.stack((B3[40] * ones, B3[41] * ones, BB[20] * ones,
                     B2[20] * ones)),
        torch.stack((B5[4] * ones, B6[4] * ones, B7[4] * ones,
                     B8[8] * ones)),
        torch.stack((2.0 * ones, 2.0 * ones, 2.0 * ones, 2.0 * ones))])

    xs = torch.stack([
        BB[21] + BB[22] * dt,                       # xs1  H,HSO4,NO3
        BB[23] + BB[24] * dt,                       # xs2  SO4,NO3
        BB[25] + BB[26] * dt,                       # xs3  H,SO4,NO3
        z, z, z,                                    # xs4-6 = 0
        B5[5] + B5[23] * dt + B5[24] * dt2,         # xs7
        B5[6] + B5[25] * dt + B5[26] * dt2,         # xs8
        B5[9] + B5[27] * dt + B5[28] * dt2,         # xs9
        B5[10] + B5[29] * dt + B5[30] * dt2,        # xs10
        4.75458e-4 - 4.0577e-3 * dt,                # xs11 NH4,SO4,NO3
    ])
    return b0, b1, c0, c1, omega, xs


def _efunc(aphi, xi):
    """Unsymmetrical mixing terms E, E' for charges (1,2)
    (activity.f90:848-897)."""
    xi_s = torch.clamp(xi, min=1e-30)
    sq = torch.sqrt(xi_s) * aphi
    xx = torch.stack([6.0 * 2.0 * sq, 6.0 * sq, 24.0 * sq])
    dum = -1.2e-2 * xx ** 0.528
    den = 4.0 + 4.581 * xx ** (-0.7238) * torch.exp(dum)
    j0 = xx / den
    j1 = (4.0 + 4.581 * xx ** (-0.7238) * torch.exp(dum)
          * (1.7238 - dum * 0.528)) / den ** 2
    e = 2.0 / (4.0 * xi_s) * (j0[0] - 0.5 * j0[1] - 0.5 * j0[2])
    ed = 2.0 / (8.0 * xi_s ** 2) * (xx[0] * j1[0] - 0.5 * xx[1] * j1[1]
                                    - 0.5 * xx[2] * j1[2]) - e / xi_s
    ok = xi > 1e-30
    return torch.where(ok, e, 0.0), torch.where(ok, ed, 0.0)


def _charges(z, like):
    """The charges z as a tensor [len(z), 1, ...] broadcasting against a
    species-first tensor of like's trailing shape."""
    return torch.as_tensor(z, dtype=like.dtype, device=like.device).reshape(
        (len(z),) + (1,) * like.dim())


def pitzer(tk, mc, ma):
    """Activity coefficients for the 3 cations / 4 anions and the water
    activity (activity.f90:48-346, 619-810, 901-1025).

    tk [...], mc [3, ...], ma [4, ...] molalities; returns
    (gam_c [3, ...], gam_a [4, ...], wact [...]).
    """
    zc = _charges(ZC, tk)
    za = _charges(ZA, tk)
    xi = 0.5 * (torch.sum(mc * zc ** 2, 0) + torch.sum(ma * za ** 2, 0))
    xi = torch.clamp(xi, min=1e-30)
    i2 = torch.sqrt(xi)
    zi = torch.sum(mc * zc, 0) + torch.sum(ma * za, 0)

    b0, b1, c0, c1, omega, xs = calpar(tk)

    # B, B', C, C' (gammann, activity.f90:689-715)
    x = i2 * ALPHA
    gg = 2.0 * (1.0 - (1.0 + x) * torch.exp(-x)) / x ** 2
    ggs = 2.0 * (-1.0 + (1.0 + x + x ** 2 / 2.0) * torch.exp(-x)) / x ** 2
    bmat = b0 + gg * b1
    bsmat = ggs * b1 / xi
    xo = omega * i2
    xo4 = torch.clamp(xo ** 4, min=1e-300)
    xhx = (6.0 - torch.exp(-xo) * (6.0 + 6.0 * xo + 3.0 * xo ** 2
                                   + xo ** 3)) / xo4
    xhxs = torch.exp(-xo) / 2.0 - 2.0 * xhx
    cmat = c0 + 4.0 * c1 * xhx
    csmat = c1 / xi * xhxs

    aphi = 0.377 + 4.684e-4 * (tk - T0) + 3.74e-6 * (tk - T0) ** 2
    f1 = -aphi * (i2 / (1.0 + 1.2 * i2)
                  + 2.0 / 1.2 * torch.log(1.0 + 1.2 * i2))
    f2 = torch.sum(mc[:, None] * ma[None, :]
                   * (bsmat + 2.0 * zi * csmat), dim=(0, 1))
    e, ed = _efunc(aphi, xi)
    # cation charges are all 1 -> no cation-pair term; anion pairs with
    # unequal charge all involve SO4= (index 1)
    f4 = ed * ma[1] * (ma[0] + ma[2] + ma[3])
    f = f1 + f2 + f4

    mcma_c = torch.sum(mc[:, None] * ma[None, :] * cmat, dim=(0, 1))

    # cations (all zc = 1; E-term vanishes between equal charges)
    a2c = torch.sum(ma[None, :] * (2.0 * bmat + zi * cmat), dim=1)
    gam_c = f[None] + a2c + mcma_c[None]

    # ternary mixing terms (pitzer, activity.f90:297-340)
    # xs is [11, ...]: index k means xs(k+1) in the reference
    rhmix_h = ma[0] * ma[2] * xs[0] + xs[2] * ma[1] * ma[2]
    mix_nh4 = (ma[1] * mc[0] * xs[7] + ma[0] * ma[1] * xs[6]
               + ma[0] * mc[0] * xs[8]) + 2.0 * mc[0] * xs[9]
    gam_c = torch.stack([gam_c[0] + rhmix_h, gam_c[1] + mix_nh4, gam_c[2]])

    # anions
    a2a = torch.sum(mc[:, None] * (2.0 * bmat + zi * cmat), dim=0)
    ea = torch.stack([e * ma[1],
                      e * (ma[0] + ma[2] + ma[3]),
                      e * ma[1],
                      e * ma[1]])
    gam_a = (za ** 2) * f[None] + a2a + za * mcma_c[None] + ea

    xu_hso4 = (mc[0] * ma[2] * xs[0] + mc[0] * ma[3] * xs[3]
               + ma[3] * xs[4] * 2.0) \
        + (ma[1] * mc[1] * xs[6] + mc[0] * mc[1] * xs[8])
    xu_so4 = (ma[2] * mc[0] * xs[2] + ma[2] * xs[1] * 2.0
              + ma[3] * mc[0] * xs[5]) \
        + (ma[0] * mc[1] * xs[6] + mc[0] * mc[1] * xs[7])
    mix_no3 = (ma[0] * mc[0] * xs[0] + 2.0 * ma[1] * xs[1]
               + ma[1] * mc[0] * xs[2] + mc[1] * ma[1] * xs[10])
    gam_a = torch.stack([gam_a[0] + xu_hso4, gam_a[1] + xu_so4,
                         gam_a[2] + mix_no3, gam_a[3]])

    gam_c = torch.exp(gam_c)
    gam_a = torch.exp(gam_a)

    # water activity (gammasn, activity.f90:901-1025)
    bphi = b0 + torch.exp(-x) * b1
    cphi = c0 + c1 * torch.exp(-xo)
    xmi = torch.sum(mc, 0) + torch.sum(ma, 0)
    fphi1 = -aphi * xi ** 1.5 / (1.0 + 1.2 * i2)
    xsum = torch.sum(mc[:, None] * ma[None, :]
                     * (zi * cphi + bphi), dim=(0, 1))
    pp = e + xi * ed
    f4w = pp * ma[1] * (ma[0] + ma[2] + ma[3])
    phix = fphi1 + xsum + f4w
    phi = 1.0 + phix * 2.0 / torch.clamp(xmi, min=1e-30)
    wact = torch.exp(-phi * M_WAT * xmi)
    return gam_c, gam_a, wact


# ---------------------------------------------------------------------------
# driver: sion1-numbered xgamma plane (SR activ, kpp.f90:5204-5404)
# ---------------------------------------------------------------------------

# reference j6 ion slots computed by the Pitzer core
PITZER_SLOTS = {1: ("c", 0), 2: ("c", 1), 19: ("a", 0), 8: ("a", 1),
                13: ("a", 2), 14: ("a", 3)}
# alias slots (kpp.f90:5353-5371): slot -> source slot
ALIASES = {3: 13, 5: 19, 6: 8, 7: 19, 9: 5, 11: 5, 12: 13, 15: 5,
           16: 5, 22: 14, 24: 14, 25: 5, 26: 24, 37: 5, 38: 5}
NGAM = 40

# conc [mol/m3] -> molality needs the Pitzer-ion species per bin
ION_SPECIES = {1: "Hp", 2: "NH4p", 19: "HSO4m", 8: "SO42m",
               13: "NO3m", 14: "Clm"}


def xgamma_field(te, conc, cm, cw, n2i, nf):
    """Activity-coefficient plane xgamma [B, NGAM, nkc, n] of B columns in
    the reference sion1 numbering (slot i stored at index i-1); slots not
    filled stay 1.  Also returns the water activity [B, nkc, n].

    te [B, n]; conc [B, nvar, n]; cm, cw [B, nkc, n] (nkc the full bin
    count: missing bins mask to gamma = 1); n2i the species index map.
    """
    B, nkc, n = cm.shape
    cm_s = torch.clamp(cm, min=1e-30)

    def molal(slot, b):
        sp = f"{ION_SPECIES[slot]}l{b}"
        if sp not in n2i:
            return torch.zeros_like(te)
        return torch.clamp(conc[:, n2i[sp]], min=0.0) * 1.0e-3 \
            / cm_s[:, b - 1]

    mc_list, ma_list = [], []
    for b in range(1, nkc + 1):
        mh, mnh4 = molal(1, b), molal(2, b)
        mhso4, mso4 = molal(19, b), molal(8, b)
        mno3, mcl = molal(13, b), molal(14, b)
        # Na+ from charge balance (see module docstring)
        mna = torch.clamp(mhso4 + 2.0 * mso4 + mno3 + mcl - mh - mnh4,
                          min=0.0)
        mc_list.append(torch.stack([mh, mnh4, mna]))
        ma_list.append(torch.stack([mhso4, mso4, mno3, mcl]))
    mc = torch.stack(mc_list, dim=2)          # [3, B, nkc, n]
    ma = torch.stack(ma_list, dim=2)          # [4, B, nkc, n]

    tk = te[:, None, :].expand(B, nkc, n)
    gam_c, gam_a, wact = pitzer(tk, mc, ma)

    # validity: cm > 0, Pitzer ionic strength in (0, 80] (activ)
    zc = _charges(ZC, tk)
    za = _charges(ZA, tk)
    xip = 0.5 * (torch.sum(mc * zc ** 2, 0) + torch.sum(ma * za ** 2, 0))
    lev = torch.arange(n, device=te.device)
    lev_ok = (lev >= 1) & (lev < nf)
    valid = (cm > 0.0) & (xip > 0.0) & (xip <= 80.0) & lev_ok

    # molality -> molarity conversion cm/cw (kpp.f90:5343-5348)
    conv = torch.where(cw > 0.0, cm / torch.clamp(cw, min=1e-300), 1.0)

    xg = [torch.ones_like(cm)] * NGAM
    for slot, (kind, idx) in PITZER_SLOTS.items():
        g = gam_c[idx] if kind == "c" else gam_a[idx]
        xg[slot - 1] = torch.where(valid, g * conv, 1.0)
    for slot, src in sorted(ALIASES.items()):
        xg[slot - 1] = xg[src - 1]
    wact = torch.where(valid, wact, 1.0)
    return torch.stack(xg, dim=1), wact
