# Frozen copy of mistra_tpu_torch/chemistry/aqueous.py (lines 1-411, commit b2518445).
"""Aqueous-phase support physics: the reference's "liq_parm stack", in
torch.

Port of ``mistra_tpu/chemistry/aqueous.py``, every function batched over a
leading column axis B (all kpp.f90):

- ``bin_masks``: the static (nkt, nka, nkc) membership of the 2-D
  particle spectrum in the 4 chemistry bins (host numpy, a copy);
- ``cw_rc`` (:2152-2420): per-bin LWC cw, mean radius rc, molality switch
  cm, conversion conv2, with deliquescence/crystallisation hysteresis;
- ``sticking_coefficients`` (``st_coeff_a/t``, :664-1044), ``mean_speeds``
  (``v_mean``, :1045-1263) and ``inverse_henry`` (``henry_a/t`` tail,
  :1676-2151);
- ``fast_k_mt`` (``fast_k_mt_a/t``, :2421-2953): Schwartz mass-transfer
  coefficients kmt and the bins' fall velocities vt;
- ``equil_constants`` (``equil_co_a/t``, :2954-3369): acid-base
  equilibrium rates xkef/xkeb;
- ``dry_aerosol_rates`` (``dry_cw_rc``/``dry_rates_g``, :4580-5203): het
  chemistry on dry aerosol.

The loops over the 2-D particle grid are einsums with the membership
masks; the species dimension is carried as named tables.  The JAX
package's ``lax.map`` over the exchange species (which bounds TPU
memory) is a Python loop here: one [B, nkt, nka, n] temporary at a time.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import CAL15, GAS_CONST, PI
from ..parallel.bins import BinShard
from .driver import henry_molar

# thresholds (cw_rc)
CWM = 1.0e-1    # aerosol bins 1-2 activity threshold [um3/cm3-ish units]
CWMD = 1.0e2    # droplet bins 3-4
XCRYSSULF = 0.4
XCRYSSS = 0.42
XDELISULF = 0.7
XDELISS = 0.75

# species exchanged between gas and aqueous phase (fast_k_mt lex list)
EXCHANGE_SPECIES = [
    "NO2", "HNO3", "NH3", "SO2", "H2SO4", "O3", "ACO2", "HCHO", "H2O2",
    "HONO", "HCl", "N2O5", "HNO4", "NO3", "OH", "HO2", "MO2", "CO2", "O2",
    "ROOH", "HOCl", "Cl2", "HBr", "HOBr", "Br2", "BrCl", "DMSO", "ClNO3",
    "BrNO3", "CH3SO3H", "DMS", "CH3SO2H", "DMSO2", "HOI", "IO", "I2",
    "ICl", "IBr", "OIO", "INO2", "INO3", "HI", "I2O2", "HIO3", "NO",
    "ACTA", "CH3OH", "C2H5OH", "XOR", "SOR"]

# molar masses [kg/mol] for vmean of species not in the gas CSV
EXTRA_MASS = {
    "OH": 17e-3, "HO2": 33e-3, "MO2": 47e-3, "OIO": 159e-3, "O1D": 16e-3,
    "O3P": 16e-3, "CO2": 44e-3, "ClNO3": 97.5e-3, "HIO3": 176e-3,
}

# equilibrium table keys (equil_co_t): name -> (kf_expr, kb_const,
# gamma indices).  kf is either a constant or (A, B) for funa(A,B) =
# A*exp(B*(1/T - 1/298)); kb couples to conv2 and activity coefficients.
EQUILIBRIA = {
    "H2O":      ((1.0e-5, -6716.0), 1.0e9, (1, 3)),
    "HO2":      (1.6e5, 1.0e10, (1, 11)),
    "ACO2":     (1.8e0, 1.0e4, (1, 16)),
    "CO2":      ((4.3e-2, -913.0), 1.0e5, (1, 9)),
    "HONO":     ((5.1e3, -1260.0), 1.0e7, (1, 12)),
    "HNO3":     ((1.54e10, 8700.0), 1.0e9, (1, 13)),
    "HNO4":     (2.0e3, 2.0e8, ()),
    "NH3":      ((1.7e5, -4325.0), 1.0e10, (3, 2)),
    "HSO3ml1":  ((6.0e2, 1120.0), 1.0e10, (1, 6)),      # kf x gamma(5)
    "H2SO4":    (1.0e12, 1.0e9, (1, 19)),
    "HSO4ml1":  ((1.02e6, 2720.0), 1.0e8, (1, 8)),      # kf x gamma(19)
    "SO2":      ((1.7e8, 2090.0), 1.0e10, (1, 5)),
    "HCHO":     ("conv2_1e10", 1.0e5, ()),               # special: kf~cv2
    "HCl":      ((1.7e10, 6896.0), 1.0e4, (1, 14)),
    "Cl2ml1":   (5.2e4, 1.0e10, ()),                     # kf x gamma(15); kb x gamma(14)
    "HOCl":     (3.2e2, 1.0e10, (1, 22)),
    "HBr":      (1.0e13, 1.0e4, (1, 24)),
    "Br2":      ((2.95e4, -4068.0), (1.17e10, -1812.0), ()),
    "HOBr":     ((2.3e1, -3091.0), 1.0e10, (1, 26)),
    "BrCl2ml1": ("kf_cv2", 1.3e9, ()),
    "Br2Clml1": ("kf_cv2_5e9", 2.8e5, ()),
    "Br2l1":    ("kf_cv2_5e9", 3.85e9, ()),
    "ICl":      ("kf_cv2_1e11", 1.3e9, ()),
    "IBr":      ("kf_cv2_1e11b", 3.5e8, ()),
    "IClBrml1": ("kf_cv2_5e9", 2.8e5, ()),
    "I2":       ("kf_cv2_5e9", 3.85e9, ()),
    "HIO3":     (1.57e4, 1.0e5, ()),
}

# the sticking coefficients' saturating T-dependence forms: species ->
# base of sig(base) (st_coeff_t)
_STICK_SIG = {"O2": 1.0e-2, "MO2": 1.0e-2, "CO2": 1.0e-2, "INO3": 1.0e-1,
              "I2": 1.0e-2, "IO": 5.0e-1, "I2O2": 1.0e-1, "INO2": 1.0e-1,
              "HIO3": 1.0e-2}
# constant sticking coefficients (default 0.1)
_STICK_CONST = {
    "H2SO4": 0.65, "O3P": 1.0e-6, "O1D": 1.0e-6, "O3": 2.0e-3, "OH": 1.0e-2,
    "HO2": 2.0e-1, "NO": 5.0e-5, "NO2": 1.5e-3, "NO3": 4.0e-2,
    "HONO": 4.0e-2, "HNO3": 5.0e-1, "NH3": 6.0e-2, "HCHO": 4.0e-2,
    "ACTA": 6.7e-2, "CH3OH": 5.6e-2, "C2H5OH": 4.8e-2, "HOBr": 6.0e-1,
    "HOCl": 6.0e-1, "BrNO3": 8.0e-1, "BrCl": 0.33, "SO2": 1.1e-1,
    "DMS": 1.0e-2, "CH3SO2H": 2.0e-4, "HOI": 6.0e-1, "OIO": 1.0,
    "XOR": 7.0e-2}
# 1/(exp(-a/t + b) + 1) forms
_STICK_T = {"HCl": (3.072e3, 1.283e1), "HBr": (3.94e3, 1.664e1),
            "HI": (4.13e3, 1.715e1)}
# 1/(exp(-h CoRT + s CoR) + 1) forms (enthalpy h, entropy s in cal)
_STICK_HS = {"ROOH": (6.5e3, 32.5), "ACO2": (7.9e3, 34.9),
             "Cl2": (1.3e4, 50.0), "Br2": (1.3e4, 50.0),
             "CH3SO3H": (3.50e3, 16.7), "DMSO": (5.12e3, 23.1),
             "DMSO2": (10.7e3, 43.0)}


def bin_masks(micro_grid):
    """Static (nkt, nka, nkc) membership tensor of the 4 chemistry bins,
    over the whole dry axis (its global index ia; a shard takes its
    columns)."""
    ka = micro_grid.ka
    kw = np.asarray(micro_grid.kw)
    nka = kw.shape[0]
    nkt = micro_grid.ew.shape[0]
    ia = np.arange(nka)[None, :]
    jt = np.arange(nkt)[:, None]
    small_a = ia < ka           # dry bins 1..ka (0-based < ka)
    small_t = jt < kw[None, :]  # water bins 1..kw(ia)
    masks = np.stack([
        small_a & small_t,            # bin 1: small aerosol
        (~small_a) & small_t,         # bin 2: large aerosol
        small_a & (~small_t),         # bin 3: small droplets
        (~small_a) & (~small_t),      # bin 4: large droplets
    ], axis=-1).astype(np.float64)
    return masks


def bin_sums(ff, weight, masks):
    """sum over the spectrum of ff * weight within each chemistry bin:
    ff [B, nkt, nka, n], weight broadcastable to [nkt, nka], masks [nkt,
    nka, nkc] -> [B, nkc, n]: over ff's own dry bins (a tp rank's partial
    sum, which its callers complete with ``BinShard.sum_bins``)."""
    w = torch.broadcast_to(weight, masks.shape[:2])
    return torch.einsum("btkn,tkc->bcn", ff, w[..., None] * masks)


def cw_rc(ff, feu, cloud, masks, rq, e, bins=None):
    """LWC/radius/molality switches per chemistry bin of B columns.

    ff [B, nkt, nka, n]; feu [B, n]; cloud [B, nkc, n] bool hysteresis
    state; masks [nkt, nka, nkc], rq [nkt, nka] and e [nkt] tensors of
    ff's dtype, over ff's dry bins; ``bins`` (a ``BinShard``, the whole
    axis by default) says which bins ff holds, and the bin sums take one
    all_reduce over the tp ranks.  Returns (cw, cm, rc, conv2) each [B,
    nkc, n] plus the new cloud flags.
    """
    dtype = ff.dtype
    vol = 4.0 / 3.0 * PI * rq ** 3                   # [nkt, nka] um3
    bins = BinShard(ff.shape[2]) if bins is None else bins
    cw_raw, rc_raw, cm_raw = bins.sum_bins(
        bin_sums(ff, vol, masks), bin_sums(ff, vol * rq, masks),
        bin_sums(ff, e[:, None], masks))

    rc = torch.where(cw_raw > 0.0,
                     rc_raw / torch.clamp(cw_raw, min=1e-300) * 1.0e-6, 0.0)
    cw = cw_raw * 1.0e-12                            # m3(aq)/m3(air)

    def col(vals):
        return torch.tensor(vals, dtype=dtype, device=ff.device)[:, None]

    thresh = col([CWM, CWM, CWMD, CWMD])
    crys = col([XCRYSSULF, XCRYSSS, 0.0, 0.0])
    deli = col([XDELISULF, XDELISS, 0.0, 0.0])
    f = feu[:, None, :]

    big = cw_raw >= thresh
    aero = torch.arange(4, device=ff.device)[:, None] < 2
    wet_ok = torch.where(aero, (cloud & (f >= crys)) | (f >= deli), True)
    both_dry = f < min(XCRYSSULF, XCRYSSS)
    active = big & wet_ok & ~(both_dry & aero)

    cm = torch.where(active, cm_raw * 1.0e-3, 0.0)
    conv2 = torch.where(active, 1.0e9 / torch.clamp(cw_raw, min=1e-300), 0.0)
    return cw, cm, rc, conv2, active


def sticking_coefficients(species, t, lp_buxmann=False):
    """alpha(T) per species: [B, nspec, n] given t [B, n]
    (st_coeff_t, kpp.f90:664-1044; default 0.1)."""
    tcorr = 1.0 / t - 1.0 / 298.15
    RT = GAS_CONST * t
    CoR = CAL15 / GAS_CONST
    CoRT = CAL15 / RT
    zexp2 = torch.exp(2000.0 * tcorr)

    def sig(base):
        # the reference's saturating T-dependence form
        return 1.0 / (1.0 + 1.0 / ((1.0 / (1.0 / base - 1.0)) * zexp2))

    def alpha(name):
        if name in ("ICl", "IBr") and lp_buxmann:
            return 1.8e-2
        if name in ("ICl", "IBr"):
            return sig(1.0e-2)
        if name in _STICK_SIG:
            return sig(_STICK_SIG[name])
        if name == "H2O2":
            return 1.0 / (torch.exp(-26.0e3 / RT + 107.8456 / GAS_CONST)
                          + 1.0)
        if name in _STICK_T:
            a, b = _STICK_T[name]
            return 1.0 / (torch.exp(-a / t + b) + 1.0)
        if name in _STICK_HS:
            h, s = _STICK_HS[name]
            return 1.0 / (torch.exp(-h * CoRT + s * CoR) + 1.0)
        return _STICK_CONST.get(name, 0.1)

    ones = torch.ones_like(t)
    return torch.stack([torch.clamp(alpha(name) * ones, max=1.0)
                        for name in species], dim=1)


def mean_speeds(species, masses, t):
    """vmean = sqrt(8RT/(pi M)) [m/s] per species: [B, nspec, n]."""
    return torch.stack(
        [torch.sqrt(8.0 * GAS_CONST * t
                    / (PI * masses.get(name, EXTRA_MASS.get(name, 0.1))))
         for name in species], dim=1)


def inverse_henry(species, t):
    """Dimensionless inverse Henry constants [B, nspec, n] (henry_a
    tail)."""
    fct = 0.0820577 * t
    rows = []
    for name in species:
        h = henry_molar(name, t)
        rows.append(torch.where(h > 0.0,
                                1.0 / (torch.clamp(h, min=1e-300) * fct),
                                0.0))
    return torch.stack(rows, dim=1)


def per_lwc(x, cw):
    """4 pi/3 x / cw where the LWC cw is a normal number, else 0.  The JAX
    package writes (4 pi/3 / max(cw, 1e-300)) x: in float32 the floor is 0,
    a subnormal cw (a bin with next to no water, as the production grid
    has) gives inf, and inf x 0 gives NaN.  In float64 the two agree to
    rounding."""
    return torch.where(cw > torch.finfo(cw.dtype).tiny,
                       4.0 * PI / 3.0 * x / cw, 0.0)


def fall_speed_sums(ff, t, p, masks, rq):
    """Each chemistry bin's volume-weighted fall velocity [B, nkc, n] over
    ff's own dry bins (the l == 1 branch of fast_k_mt): the bin's
    LWC-weighted fall velocity vt once summed over the whole axis and
    divided by the LWC (``per_lwc``)."""
    from ..physics.sedimentation import vterm
    rqm = rq * 1.0e-6                                    # [nkt, nka] m
    xvs = vterm(rqm[None, :, :, None], t[:, None, None, :],
                p[:, None, None, :])
    return bin_sums(ff * xvs, rqm ** 3 * 1.0e6, masks)


def fast_k_mt(ff, t, p, alpha, vmean, cw, cm, masks, rq, freep, bins=None):
    """Schwartz mass-transfer coefficients and bin fall velocities of B
    columns.

    alpha/vmean: [B, nexch, n]; ff [B, nkt, nka, n]; cw/cm [B, nkc, n];
    t, p, freep [B, n]; ``bins`` as ``cw_rc``'s (every bin sum of the
    call in one all_reduce).  Returns xkmt [B, nexch, nkc, n], vt [B,
    nkc, n].
    """
    z4pi3 = 4.0 * PI / 3.0
    rqm = rq * 1.0e-6
    r_over_l = rqm[None, :, :, None] / freep[:, None, None, :]
    weight = rqm ** 2 * 1.0e6
    ok = (cw > 0.0) & (cm > 0.0)
    inv_cw = z4pi3 / torch.clamp(cw, min=1e-300)
    xk1 = []
    for l in range(alpha.shape[1]):
        a_l, v_l = alpha[:, l], vmean[:, l]             # [B, n]
        x1 = torch.where(a_l > 0.0,
                         4.0 / (3.0 * torch.clamp(a_l, min=1e-300)), 0.0)
        x2 = v_l[:, None, None, :] / (r_over_l + x1[:, None, None, :])
        xk1.append(bin_sums(ff * x2, weight, masks))
    bins = BinShard(ff.shape[2]) if bins is None else bins
    xk1, vt = bins.sum_bins(torch.stack(xk1, dim=1),
                            fall_speed_sums(ff, t, p, masks, rq))
    return torch.where(ok[:, None], inv_cw[:, None] * xk1, 0.0), \
        per_lwc(vt, cw)


def equil_constants(t, conv2, xgamma):
    """Acid-base equilibrium forward/backward rates.

    t [B, n]; conv2 [B, nkc, n]; xgamma [B, NGAM, nkc, n] activity
    coefficients (or None: all 1).  Returns dicts key -> [B, nkc, n].
    """
    def funa(a0, b0):
        return a0 * torch.exp(b0 * (1.0 / t - 3.354e-3))[:, None, :]

    def gam(i):
        return xgamma[:, i - 1] if xgamma is not None else 1.0

    ones = torch.ones_like(conv2)
    kef, keb = {}, {}
    for key, (kf, kb, gidx) in EQUILIBRIA.items():
        # forward
        if kf == "conv2_1e10":
            f = 1.0e10 * conv2
        elif kf == "kf_cv2":
            f = funa(5.0e9, 1143.0) * conv2 * gam(14)
        elif kf == "kf_cv2_5e9":
            f = 5.0e9 * conv2
        elif kf == "kf_cv2_1e11":
            f = 1.0e11 * conv2 * gam(14)
        elif kf == "kf_cv2_1e11b":
            f = 1.0e11 * conv2 * gam(24)
        elif isinstance(kf, tuple):
            f = funa(*kf) * ones
        else:
            f = kf * ones
        if key == "HSO3ml1":
            f = f * gam(5)
        elif key == "HSO4ml1":
            f = f * gam(19)
        elif key == "Cl2ml1":
            f = f * gam(15)
        elif key == "Br2":
            f = f * gam(25)
        # backward
        if isinstance(kb, tuple):
            b = funa(*kb) * conv2 * gam(24)
        elif key == "HCHO":
            b = kb * ones
        elif key == "BrCl2ml1":
            b = kb * gam(28) * ones
        elif key == "ICl":
            b = kb * gam(37) * ones
        elif key == "IBr":
            b = kb * gam(38) * ones
        elif key in ("HIO3", "HNO4"):
            b = kb * conv2
        elif key in ("Br2Clml1", "Br2l1", "IClBrml1", "I2"):
            b = kb * ones
        elif key == "Cl2ml1":
            b = kb * conv2 * gam(14)
        else:
            g = 1.0
            for i in gidx:
                g = g * gam(i)
            b = kb * conv2 * g
        active = conv2 > 0.0
        kef[key] = torch.where(active, f, 0.0)
        keb[key] = torch.where(active, b, 0.0)
    return kef, keb


def dry_aerosol_rates(ff, t, masks, rq, freep, bins=None, lwc=None):
    """Het-on-dry-aerosol stack of B columns (dry_cw_rc + dry_rates_g).

    ff [B, nkt, nka, n]; t, freep [B, n]; masks [nkt, nka, nkc] and rq
    [nkt, nka] tensors of ff's dtype, over ff's dry bins; ``bins`` (a
    ``parallel.bins.BinShard``, the whole axis by default) says which
    bins ff holds, and the bin sums take one all_reduce over the tp
    ranks.  ``lwc``, where given, is (cw, rc) of ``cw_rc`` for the same
    ff: dry_cw_rc's LWC and radius of the aerosol bins are the same sums,
    taken from there with no sum over the bins.  Returns dict with xkmtd
    (species -> [B, 2, n]) for HNO3/N2O5/NH3/H2SO4, henry_dry (species ->
    [B, n]), xeq_hno3 [B, n] and the dry LWC/radius cwd, rcd [B, 2, n]
    of the two aerosol bins.
    """
    if lwc is not None:
        cwd, rcd = lwc[0][:, :2], lwc[1][:, :2]
    else:
        m = masks[:, :, :2]                          # aerosol bins only
        vol = 4.0 / 3.0 * PI * rq ** 3
        bins = BinShard(ff.shape[2]) if bins is None else bins
        cwd_raw, rcd_raw = bins.sum_bins(bin_sums(ff, vol, m),
                                         bin_sums(ff, vol * rq, m))
        rcd = torch.where(cwd_raw > 0.0, rcd_raw
                          / torch.clamp(cwd_raw, min=1e-300) * 1.0e-6, 0.0)
        cwd = cwd_raw * 1.0e-12

    zgamma = {"HNO3": 0.02, "N2O5": 0.02, "NH3": 0.05, "H2SO4": 0.1}
    vmean_c = {"HNO3": 6.3e-2, "N2O5": 1.08e-1, "NH3": 1.7e-2,
               "H2SO4": 9.8e-2}
    xkmtd = {}
    for name in ("HNO3", "N2O5", "NH3", "H2SO4"):
        zv = torch.sqrt(t / vmean_c[name]) * 4.60138
        g = zgamma[name]
        x1 = torch.where(rcd > 0.0,
                         1.0 / (torch.clamp(rcd, min=1e-300)
                                * (rcd / freep[:, None, :]
                                   + 4.0 / (3.0 * g))),
                         0.0)
        xkmtd[name] = zv[:, None, :] * x1            # [B, 2, n]

    xeq_hno3 = 1.54e1 * torch.exp(8700.0 * (1.0 / t - 3.354e-3))
    fct = 0.0820577 * t
    h_hno3_molar = (2.5e6 / torch.clamp(xeq_hno3, min=1e-300)) \
        * torch.exp(8694.0 * (1.0 / t - 3.3557e-3))
    henry_dry = {"HNO3": 1.0 / (h_hno3_molar * fct)}
    for name in ("N2O5", "NH3", "H2SO4"):
        h = henry_molar(name, t)
        henry_dry[name] = torch.where(h > 0.0,
                                      1.0 / (torch.clamp(h, min=1e-300)
                                             * fct), 0.0)
    return {"xkmtd": xkmtd, "henry_dry": henry_dry, "xeq_hno3": xeq_hno3,
            "cwd": cwd, "rcd": rcd}
