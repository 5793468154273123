# Frozen copy of mistra_tpu_torch/radiation/solver.py (lines 1-766, commit b2518445).
"""PIFM2 delta-two-stream radiative transfer solver, in torch.

Counterpart of ``mistra_tpu.radiation.solver`` (the reference's ``nstrahl``
subroutines, nrad.f90:55-3043): 18 spectral bands (6 solar + 12 IR) with
correlated-k gas absorption over 121 (band, quadrature) pairs.

Every profile argument carries a leading column axis ``B``; the 121 pairs
are batched as in the JAX package, so the per-layer transfer coefficients
are one elementwise block over (column, pair, cloud part, layer).  The
layer recurrences (``kurzw_propagate``'s top-down propagation, ``jeanfr``'s
elimination and back-substitution) are Python loops over the L layers on
``[B, P]`` slices: L is static, so the loops never wait for the device.
Each loop step writes its results into one slab of a preallocated
layer-major buffer ``[L, k, B, P]``.

All arrays here are indexed TOP-DOWN like the reference solver; the driver
flips at the interface.  Constant tables are host numpy (``PairTables``)
and become tensors once per dtype and device (``PairTables.tensor``).
"""

from __future__ import annotations

import numpy as np
import torch

from .tables import KG, MB, MBIR, MBS, Pifm2Tables

# IR band wavelength boundaries [um] for the Planck integration
WVL = np.array([2200.0, 1900.0, 1700.0, 1400.0, 1250.0, 1100.0,
                980.0, 800.0, 670.0, 540.0, 400.0, 280.0, 0.0])

# trace gas concentrations (reference nstrahl:192-195)
UMCO2 = 330.0
UMCH4 = 1.6
UMN2O = 0.28

U0MIN = 1.0e-2

STANP_S = np.array([1000., 1580., 2510., 3980., 6310., 10000., 15800.,
                    25100., 39800., 63100., 100000.])
STANP_I = np.array([25.1, 39.8, 63.1, 100., 158., 251., 398., 631., 1000.,
                    1580., 2510., 3980., 6310., 10000., 15800., 25100.,
                    39800., 63100., 100000.])

# central wavenumbers of the H2O continuum bands 11-17 (1-based)
VV_CONT = np.array([1175.0, 1040.0, 890.0, 735.0, 605.0, 470.0, 340.0])


# --------------------------------------------------------------------------
# correlated-k absorption coefficient interpolation (qks/qki/qkio3)
# --------------------------------------------------------------------------

def interp_k(coef, stanp, p, t, tref):
    """Vectorized Fu (1991) k-coefficient interpolation.

    coef: [*K, 3, np] ln-k polynomial coefficients at the np standard
    pressures stanp [np]; p, t: [B, nrlev]; tref: a number or [*K, 1].
    Returns fkg [B, *K, nrlev].
    """
    npp = stanp.shape[0]
    B, nrlev = p.shape
    pk = p.reshape((B,) + (1,) * (coef.dim() - 2) + (nrlev,))
    ztf = (t.reshape(pk.shape) - tref).unsqueeze(-2)   # [B, *K, 1, nrlev]
    ztf2 = ztf * ztf
    # k at all standard pressures: [B, *K, np, nrlev]
    lnk = (coef[..., 0, :, None] + coef[..., 1, :, None] * ztf
           + coef[..., 2, :, None] * ztf2)
    kk = torch.exp(lnk)

    iph = torch.clamp(torch.searchsorted(stanp, p), 1, npp - 1)
    idx = iph.reshape(pk.shape).unsqueeze(-2).expand(
        kk.shape[:-2] + (1, nrlev))
    x1 = torch.gather(kk, -2, idx - 1).squeeze(-2)
    x2 = torch.gather(kk, -2, idx).squeeze(-2)
    frac = ((p - stanp[iph - 1]) / (stanp[iph] - stanp[iph - 1])).reshape(
        pk.shape)
    fkg_mid = x1 + (x2 - x1) * frac

    # below the lowest tabulated pressure: scale linearly from zero
    low = pk <= stanp[0]
    fkg_low = kk[..., 0, :] * pk / stanp[0]
    # above the highest: extrapolate the last interval's slope
    high = pk >= stanp[-1]
    slope = (kk[..., npp - 1, :] - kk[..., npp - 2, :]) \
        / (stanp[npp - 1] - stanp[npp - 2])
    fkg_high = kk[..., npp - 2, :] + slope * (pk - stanp[npp - 2])

    return torch.where(low, fkg_low, torch.where(high, fkg_high, fkg_mid))


def _qop_pair(f, w, p, const):
    """Generic layer optical depth: tg[l] = (f*w)[l] + (f*w)[l+1] scaled.

    f: [B, *K, nrlev]; w broadcasts against f; p: [B, nrlev]."""
    fw = f * w
    dp = p[:, 1:] - p[:, :-1]
    dp = dp.reshape((dp.shape[0],) + (1,) * (fw.dim() - 2) + dp.shape[1:])
    return (fw[..., :-1] + fw[..., 1:]) * dp * const


class PairTables:
    """Per-(band, ig) packed coefficient arrays built once from the pifm2
    tables (host-side numpy), and their tensors per dtype and device."""

    def __init__(self, tb: Pifm2Tables):
        self.kg = KG
        self.npairs = int(KG.sum())
        band_of_pair = np.concatenate(
            [np.full(KG[b], b) for b in range(MB)])  # 0-based band index
        self.band_of_pair = band_of_pair
        self.solar_pair = band_of_pair < MBS
        # quadrature weights: solar pairs scaled by band solar energy
        hk = np.concatenate([tb.hk[b + 1] for b in range(MB)])
        hk_energy = hk.copy()
        for b in range(MBS):
            sel = band_of_pair == b
            hk_energy[sel] = tb.s0b[b] * hk[sel]
        self.hk = hk_energy
        self.tb = tb

        # stacked coefficient tables
        self.fk1o3 = tb.cgas["fk1o3"]                       # [10]
        self.cs_solar = np.concatenate(
            [np.moveaxis(tb.cgas[f"c{b}h2o"], -1, 0) for b in
             range(2, 7)])                                  # [44, 3, 11]
        ir_bands = list(range(7, 19))
        self.ci_h2o = np.concatenate([
            np.moveaxis(tb.cgas[
                {12: "c12o3", 14: "c14hca", 15: "c15hca"}.get(
                    b, f"c{b}h2o")], -1, 0)
            for b in ir_bands])                             # [67, 3, 19]
        # NOTE: for band 12 the stacked per-ig table is c12o3 (O3 via qkio3);
        # for 14/15 it is the CO2-scaled hca tables; handled in gas_tau.
        self.c10ch4 = tb.cgas["c10ch4"]
        self.c10n2o = tb.cgas["c10n2o"]
        self.c11ch4 = tb.cgas["c11ch4"]
        self.c11n2o = tb.cgas["c11n2o"]
        self.c12h2o = tb.cgas["c12h2o"]
        self.c14hcb = np.moveaxis(tb.cgas["c14hcb"], -1, 0)  # [10, 3, 19]
        self.c15hcb = np.moveaxis(tb.cgas["c15hcb"], -1, 0)  # [12, 3, 19]

        # index bookkeeping
        self.n_band1 = KG[0]
        self.n_solar_k = int(KG[1:6].sum())
        ir_count = KG[6:].astype(int)
        self.ir_band_of = np.concatenate(
            [np.full(c, 6 + i) for i, c in enumerate(ir_count)])  # 0-based

        # per-IR-pair selectors of gas_tau: band 12 weights O3, bands 14/15
        # the CO2/H2O combination, the others H2O
        ir_band = self.ir_band_of
        self.tref_i = np.where(ir_band == 11, 250.0, 245.0)
        self.is_b12 = (ir_band == 11)[:, None]
        self.is_b1415 = ((ir_band == 13) | (ir_band == 14))[:, None]
        self.const_i = np.where(ir_band == 11, 2.3808,
                                np.where(self.is_b1415[:, 0], 0.005,
                                         6.349205))
        # one-hot band maps of the solar and IR pairs for the band sums
        n_solar = int(self.solar_pair.sum())
        self.onehot_s = (band_of_pair[:n_solar, None]
                         == np.arange(MBS)[None, :])
        self.onehot_i = (band_of_pair[n_solar:, None] - MBS
                         == np.arange(MBIR)[None, :])
        self.stanp_s = STANP_S
        self.stanp_i = STANP_I
        self.wvl = WVL
        self.vv_cont = VV_CONT
        self._tensors = {}

    def tensor(self, name: str, dtype, device) -> torch.Tensor:
        """Table ``name`` (an attribute of this object, else of its
        Pifm2Tables) as a tensor of dtype on device, made once per dtype
        and device so that a call copies nothing from the host."""
        key = (name, dtype, torch.device(device))
        out = self._tensors.get(key)
        if out is None:
            src = getattr(self, name) if hasattr(self, name) \
                else getattr(self.tb, name)
            out = torch.as_tensor(np.asarray(src), dtype=dtype,
                                  device=device)
            self._tensors[key] = out
        return out


def gas_tau(pt: PairTables, p, t, xm1, qmo3):
    """Optical depths tg [B, npairs, nrlay] and weights hk [npairs].

    p, t, xm1, qmo3: [B, nrlev]."""
    dt, dev = p.dtype, p.device

    def c(name, dtype=dt):
        return pt.tensor(name, dtype, dev)

    dp = p[:, 1:] - p[:, :-1]                                # [B, nrlay]

    # band 1: ozone, solar
    fq = 2.3808 * c("fk1o3")                                 # [10]
    tg_b1 = fq[None, :, None] * (qmo3[:, :-1] + qmo3[:, 1:])[:, None, :] \
        * dp[:, None, :]

    # solar H2O bands 2-6
    fkg_s = interp_k(c("cs_solar"), c("stanp_s"), p, t, 245.0)
    tg_s = _qop_pair(fkg_s, xm1[:, None, :], p, 6.349205)

    # IR pairs: base per-ig table via qki (or qkio3 for band 12)
    stanp_i = c("stanp_i")
    fkg_i = interp_k(c("ci_h2o"), stanp_i, p, t, c("tref_i")[:, None])
    # per-pair weight for the base table: H2O bands weight xm1; band 12 O3
    # weights qmo3; bands 14/15 use the CO2/H2O combination below
    base_w = torch.where(c("is_b12", torch.bool), qmo3[:, None, :],
                         torch.where(c("is_b1415", torch.bool), 1.0,
                                     xm1[:, None, :]))

    # CO2/H2O overlap bands 14, 15 (approach two of Fu): fkg combination
    pq = torch.where(p >= 6310.0, xm1, 0.0)[:, None, :]
    fkg_b14b = interp_k(c("c14hcb"), stanp_i, p, t, 245.0)
    fkg_b15b = interp_k(c("c15hcb"), stanp_i, p, t, 245.0)
    off14 = int(np.searchsorted(pt.ir_band_of, 13))
    off15 = int(np.searchsorted(pt.ir_band_of, 14))
    n14, n15 = int(KG[13]), int(KG[14])
    fkg_i[:, off14:off14 + n14] = \
        fkg_i[:, off14:off14 + n14] / 330.0 * UMCO2 + pq * fkg_b14b
    fkg_i[:, off15:off15 + n15] = \
        fkg_i[:, off15:off15 + n15] / 330.0 * UMCO2 + pq * fkg_b15b

    tg_i = fkg_i * base_w
    tg_i = (tg_i[..., :-1] + tg_i[..., 1:]) * dp[:, None, :] \
        * c("const_i")[:, None]

    # band 10/11 CH4 + N2O extra terms (same for all igs of the band)
    def extra(coef_ch4, coef_n2o):
        f_ch4 = interp_k(c(coef_ch4), stanp_i, p, t, 245.0)
        f_n2o = interp_k(c(coef_n2o), stanp_i, p, t, 245.0)
        tg_ch4 = _qop_pair(f_ch4, 1.0, p, 6.3119e-6)
        tg_n2o = _qop_pair(f_n2o, 1.0, p, 1.10459e-6)
        return tg_ch4 / 1.6 * UMCH4 + tg_n2o / 0.28 * UMN2O

    ex10 = extra("c10ch4", "c10n2o")
    ex11 = extra("c11ch4", "c11n2o")
    off10 = int(np.searchsorted(pt.ir_band_of, 9))
    off11 = int(np.searchsorted(pt.ir_band_of, 10))
    tg_i[:, off10:off10 + int(KG[9])] += ex10[:, None, :]
    tg_i[:, off11:off11 + int(KG[10])] += ex11[:, None, :]

    # band 12 H2O extra term (same for all igs)
    f12 = interp_k(c("c12h2o"), stanp_i, p, t, 245.0)
    tg12 = _qop_pair(f12, xm1, p, 6.349205)
    off12 = int(np.searchsorted(pt.ir_band_of, 11))
    tg_i[:, off12:off12 + int(KG[11])] += tg12[:, None, :]

    tg = torch.cat([tg_b1, tg_s, tg_i], dim=1)
    return tg, c("hk")


# --------------------------------------------------------------------------
# cloud overlap, droplet optics, continuum, Planck
# --------------------------------------------------------------------------

def frr(frac):
    """Geleyn & Hollingsworth random-overlap continuity factors.

    frac: [B, nrlay] (top-down).  Returns bb [B, 4, nrlay]; cc = 1 - bb.
    """
    nrlay = frac.shape[-1]
    fm = torch.cat([frac[:, :1] * 0.0, frac[:, :-1]], dim=1)  # frac(j-1)
    fp = torch.cat([frac[:, 1:], frac[:, -1:] * 0.0], dim=1)  # frac(j+1)
    j = torch.arange(nrlay, device=frac.device)

    def updown(fnb, is_edge):
        b_a = torch.where(
            fnb < 1.0,
            torch.where(fnb < frac,
                        (1.0 - frac) / torch.clamp(1.0 - fnb, min=1e-300),
                        1.0),
            1.0)
        b_b = torch.where(
            fnb > 0.0,
            torch.where(fnb < 1.0,
                        torch.where(fnb < frac, 1.0,
                                    frac / torch.clamp(fnb, min=1e-300)),
                        frac),
            1.0)
        b1 = torch.where(fnb > 0.0, b_a, 1.0 - frac)
        b1 = torch.where(is_edge, 1.0, b1)
        b3 = torch.where(is_edge, 1.0, b_b)
        return b1, b3

    b1, b3 = updown(fm, j == 0)
    b2, b4 = updown(fp, j == nrlay - 1)
    bb = torch.stack([b1, b2, b3, b4], dim=1)
    return bb, 1.0 - bb


def water_optics(pt: PairTables, frac, rew, rho2w, thk):
    """Droplet optics per band: t2w, w2w [B, mb, nrlay], pl2w
    [B, mb, 2, nrlay].  frac, rew, rho2w, thk: [B, nrlay]."""
    dt, dev = rew.dtype, rew.device
    ret = pt.tensor("ret", dt, dev)    # tabulated effective radii [m]
    b2wt = pt.tensor("b2wt", dt, dev)  # [ncw, mb]
    w2wt = pt.tensor("w2wt", dt, dev)
    g2wt = pt.tensor("g2wt", dt, dev)
    ncw = ret.shape[0]

    k = torch.clamp(torch.searchsorted(ret, rew) - 1, 0, ncw - 2)  # [B, L]
    below = (rew <= ret[0])[..., None]
    above = (rew >= ret[-1])[..., None]

    bofr = b2wt / pt.tensor("r2wt", dt, dev)[:, None]       # [ncw, mb]
    b_lo, b_hi = bofr[k], bofr[k + 1]                       # [B, L, mb]
    inv_interp = (b_hi - b_lo) / (1.0 / ret[k + 1] - 1.0 / ret[k])[..., None]
    b_int = b_lo + inv_interp * (1.0 / rew - 1.0 / ret[k])[..., None]
    b_val = torch.where(below, bofr[0], torch.where(above, bofr[-1], b_int))

    lin = ((rew - ret[k]) / (ret[k + 1] - ret[k]))[..., None]
    w_val = torch.where(below, w2wt[0],
                        torch.where(above, w2wt[-1],
                                    w2wt[k] + (w2wt[k + 1] - w2wt[k]) * lin))
    g_val = torch.where(below, g2wt[0],
                        torch.where(above, g2wt[-1],
                                    g2wt[k] + (g2wt[k + 1] - g2wt[k]) * lin))

    cloud = (rho2w >= 1.0e-5)[..., None]
    t2w = torch.where(cloud, thk[..., None] * rho2w[..., None] * b_val,
                      0.0).transpose(1, 2)                  # [B, mb, L]
    w2w = torch.where(cloud, w_val, 0.0).transpose(1, 2)
    g = torch.where(cloud, g_val, 0.0).transpose(1, 2)
    pl2w = torch.stack([3.0 * g, 5.0 * g * g], dim=2)        # [B, mb, 2, L]
    return t2w, w2w, pl2w


def qopcon(vv, t, p, xm1):
    """H2O continuum optical depth for central wavenumbers vv; all
    arguments broadcast, the level axis last."""
    s = (418.0 + 557780.0 * torch.exp(-0.00787 * vv)) / 101325.0
    p1 = p * xm1 / (0.622 + 0.378 * xm1)
    w = torch.exp(1800.0 / t - 6.08108)
    ff = s * (p1 / 100.0 + 2.0e-5 * p) * w
    return (ff[..., :-1] * xm1[..., :-1] + ff[..., 1:] * xm1[..., 1:]) \
        * (p[..., 1:] - p[..., :-1]) * 0.00509892


_PLANCK_A = [1.0 / 3, -1.0 / 8, 1.0 / 60, -1.0 / 5040, 1.0 / 272160,
             -1.0 / 13305600]
# series split points, decreasing: term jm >= 2 of the exponential series
# is taken where v < VCP[jm - 2]
PLANCK_VCP = (10.25, 5.7, 3.9, 2.9, 2.3, 1.9, 0.0)


def _planck_series(v):
    """Power and exponential series of the band integral at v = c2 nu / T
    (nrad.f90:1035-1160): (power, exponential, v < 1.5)."""
    conc = 15.0 / np.pi ** 4
    a = _PLANCK_A
    vsq = v * v
    p = conc * vsq * v * (a[0] + v * (a[1] + v * (
        a[2] + vsq * (a[3] + vsq * (a[4] + vsq * a[5])))))
    # mmax = 1 + number of VCP entries strictly above v (the JAX package's
    # searchsorted(-vcp, -v, side="left") + 1), so term jm >= 2 is taken
    # iff v < VCP[jm - 2]
    ex = torch.exp(-torch.clamp(v, max=80.0))
    d = torch.zeros_like(v)
    exm = torch.ones_like(v)
    for jm in range(1, 8):
        mv = jm * v
        exm = exm * ex
        term = exm * (6.0 + mv * (6.0 + mv * (3.0 + mv))) / jm ** 4
        d = d + (term if jm == 1
                 else torch.where(v < PLANCK_VCP[jm - 2], term, 0.0))
    return p, conc * d, v < 1.5


def plkavg(wnumlo, wnumhi, t):
    """Band-integrated Planck function [W/m2/sr * pi]; the arguments
    broadcast (band wavenumbers against temperatures).

    Matches the reference power/exponential series split (nrad.f90:
    1035-1160).
    """
    c2 = 1.438786
    sigdpi = 5.67032e-8 / np.pi
    # c2 [K cm] times wavenumber [cm^-1] over T [K] is dimensionless
    p1, d1, small1 = _planck_series(c2 * wnumlo / t)
    p2, d2, small2 = _planck_series(c2 * wnumhi / t)
    res = torch.where(small1 & small2, p2 - p1,
                      torch.where(small1 & ~small2, 1.0 - p1 - d2, d1 - d2))
    out = sigdpi * t ** 4 * res
    return torch.where(t < 1.0e-4, 0.0, out)


# --------------------------------------------------------------------------
# total optical properties per (column, pair, cloud-part, layer)
# --------------------------------------------------------------------------

def total_tau(dtaur, taer, waer, plaer, tgcon, tg, t2w, w2w, pl2w):
    """Combine Rayleigh/aerosol/continuum/gas/droplet optics (SR tau).

    Shapes: dtaur/taer/waer/tgcon/t2w/w2w/tg [B, P, nrlay]; plaer/pl2w
    [B, P, 2, nrlay].  Returns dtau/om [B, P, 2, nrlay] and pl
    [B, P, 2, 2, nrlay] with axis 2 = (cloud-free, cloudy).
    """
    dtau_f = dtaur + taer + tgcon + tg
    dtau_w = dtau_f + t2w
    zx1 = taer * waer
    zsum1 = dtaur + zx1
    zsum2 = zsum1 + t2w * w2w
    om_f = torch.where(dtau_f > 1.0e-20, zsum1 / dtau_f, 0.0)
    om_w = torch.where(dtau_f > 1.0e-20, zsum2 / dtau_w, 0.0)

    zf = torch.stack([dtaur * 0.0, dtaur * 0.5], dim=2) \
        + zx1[:, :, None, :] * plaer
    good = (zsum1 >= 1.0e-20)[:, :, None, :]
    pl_f = torch.where(good, zf / zsum1[:, :, None, :], 0.0)
    pl_w = torch.where(good, (zf + (t2w * w2w)[:, :, None, :] * pl2w)
                       / zsum2[:, :, None, :], 0.0)
    dtau = torch.stack([dtau_f, dtau_w], dim=2)
    om = torch.stack([om_f, om_w], dim=2)
    pl = torch.stack([pl_f, pl_w], dim=2)   # [B, P, 2(jc), 2(jl), L]
    return dtau, om, pl


# --------------------------------------------------------------------------
# solar transfer coefficients + downward propagation (kurzw)
# --------------------------------------------------------------------------

def kurzw_coefficients(dtau, om, pl, u0):
    """Zdunkowski delta-Eddington coefficients a1..a6.

    dtau/om [B, P, 2, L]; pl [B, P, 2, 2, L]; u0 [B].
    Returns a1..a6 each [B, P, 2, L].
    """
    u = 2.0
    u0s = torch.clamp(u0, min=1.0e-4).reshape(-1, 1, 1, 1)
    u0kw = 1.0 / u0s

    dtu0 = dtau * u0kw
    a6 = torch.exp(-torch.clamp(dtu0, max=75.0))
    dtu = dtau * u

    ak = 1.0 - om
    p1 = pl[..., 0, :]
    f = pl[..., 1, :] / 5.0
    emf = 1.0 - f
    emfkw = 1.0 / emf
    ray = p1 >= 0.1
    b0 = torch.where(ray, (3.0 - p1) / 8.0, 0.5)
    bu0 = torch.where(ray, 0.5 - u0s / 4.0 * (p1 - 3.0 * f) * emfkw, 0.5)

    # --- case 4: absorption and scattering --------------------------------
    alph2 = u * b0 * om
    alph1 = u * ak + alph2
    alph3 = bu0 * om
    alph4 = om - alph3
    eps2 = alph1 ** 2 - alph2 ** 2
    eps = torch.sqrt(torch.clamp(eps2, min=1e-300))
    omf = om * f
    emomf = 1.0 - omf

    # resonance correction: reduce u0 where |emomf^2 - u0^2 eps2| ~ 0, a
    # fixed 8 masked passes
    emomf2 = emomf ** 2
    u0red = u0s.expand_as(dtau)
    for _ in range(8):
        emu = emomf2 - u0red ** 2 * eps2
        u0red = torch.where(emu.abs() <= 0.1e-6, u0red - 0.001, u0red)
    u02 = u0red ** 2
    emu = emomf2 - u02 * eps2

    a1_4 = torch.exp(-torch.clamp(dtu0 * emomf, max=75.0))
    e = torch.exp(-torch.clamp(dtau * eps, max=75.0))
    m = alph2 / (alph1 + eps)
    e2, m2 = e * e, m * m
    ouf = 1.0 / (1.0 - e2 * m2)
    a4_4 = e * (1.0 - m2) * ouf
    a5_4 = m * (1.0 - e2) * ouf
    te = emf / emu
    u0a1 = u0red * alph1
    u0a2 = u0red * alph2
    gam1 = (alph3 * (emomf - u0a1) - u0a2 * alph4) * te
    gam2 = -(alph4 * (emomf + u0a1) + u0a2 * alph3) * te
    g1a1 = gam1 * a1_4
    da = a1_4 - a4_4
    a2_4 = gam2 * da - a5_4 * g1a1
    a3_4 = -gam2 * a5_4 - a4_4 * g1a1 + gam1

    # --- case 3: pure scattering (ak < 1e-3) ------------------------------
    alph1_3 = u * b0
    alph3_3 = bu0
    gam1_3 = alph3_3 - alph1_3 * u0s * emfkw
    a1_3 = torch.exp(-torch.clamp(dtu0 * emf, max=75.0))
    a4_3 = 1.0 / (1.0 + alph1_3 * dtau)
    a2_3 = a4_3 * (1.0 - gam1_3 * (1.0 - a1_3)) - a1_3
    a3_3 = 1.0 - a1_3 - a2_3
    a5_3 = 1.0 - a4_3

    # --- case 2: no scattering (om < 0.03) --------------------------------
    a4_2 = torch.exp(-torch.clamp(dtu, max=75.0))

    # --- select -----------------------------------------------------------
    no_ext = dtau <= 1.0e-7
    no_scat = om < 0.03
    no_abs = ak < 0.001

    def sel(v4, v3, v2, v1):
        out = torch.where(no_abs, v3, v4)
        out = torch.where(no_scat, v2, out)
        return torch.where(no_ext, v1, out)

    a1 = sel(a1_4, a1_3, a6, 1.0)
    a2 = sel(a2_4, a2_3, 0.0, 0.0)
    a3 = sel(a3_4, a3_3, 0.0, 0.0)
    a4 = sel(a4_4, a4_3, a4_2, 1.0)
    a5 = sel(a5_4, a5_3, 0.0, 0.0)
    a6 = torch.where(no_ext, 1.0, a6)
    return a1, a2, a3, a4, a5, a6


def _layers(x):
    """[B, P, 2, L] -> the L cloud-free and the L cloudy [B, P] slices, each
    a contiguous block (lists: the loops then index no tensor)."""
    x = x.permute(2, 3, 0, 1).contiguous()                   # [2, L, B, P]
    return x[0].unbind(0), x[1].unbind(0)


def _factor_layers(x, k):
    """[B, 4, L] -> the L [B, 1] columns of factor k."""
    return x[:, k].t().unsqueeze(-1).unbind(0)


def kurzw_propagate(a1, a2, a3, a6, bb, cc, u0, albedo_pair):
    """Top-down propagation of parallel fluxes (kurzw, nrad.f90:2638-2688).

    a-coefficients [B, P, 2, L]; bb/cc [B, 4, L]; u0 [B]; albedo_pair [P].
    Returns sf, sw, ssf, ssw, f1f, f1w, f2f, f2w, each [B, P, L+1].
    """
    B, P, _, L = a1.shape
    (a1f, a1w), (a2f, a2w), (a3f, a3w), (a6f, a6w) = (
        _layers(x) for x in (a1, a2, a3, a6))
    bb1, cc3 = _factor_layers(bb, 0), _factor_layers(cc, 2)

    u0p = u0[:, None].expand(B, P)
    zero = torch.zeros_like(u0p)
    ssf, ssw, sf, sw = u0p, zero, u0p, zero
    # per layer j: ssf, ssw, sf, sw, f2f, f2w at level j+1; f1f, f1w at j
    out = a1.new_empty((L, 8, B, P))
    out_l = out.unbind(0)
    # NB first layer: the reference uses ua (from ssf) also for the direct
    # flux sf(2); since sf(1)=ssf(1)=u0 the unified formula is identical.
    for j in range(L):
        ua = bb1[j] * ssf
        ub = ssf - ua
        uc = bb1[j] * sf
        ud = sf - uc
        va = cc3[j] * ssw
        vb = ssw - va
        vc = cc3[j] * sw
        vd = sw - vc
        wa, wb, wc, wd = ua + va, ub + vb, uc + vc, ud + vd
        ssf = a1f[j] * wa
        ssw = a1w[j] * wb
        sf = a6f[j] * wc
        sw = a6w[j] * wd
        torch.stack([ssf, ssw, sf, sw, a2f[j] * wa, a2w[j] * wb,
                     a3f[j] * wa, a3w[j] * wb], out=out_l[j])

    top = torch.stack([u0p, zero, u0p, zero, zero, zero])[None]
    levels = torch.cat([top, out[:, :6]]).permute(1, 2, 3, 0)  # [6,B,P,L+1]
    ssf, ssw, sf, sw, f2f, f2w = levels.unbind(0)
    sfc = albedo_pair * torch.stack([ssf[..., L], ssw[..., L]])
    f1 = torch.cat([out[:, 6:], sfc[None]]).permute(1, 2, 3, 0)
    f1f, f1w = f1.unbind(0)
    return sf, sw, ssf, ssw, f1f, f1w, f2f, f2w


# --------------------------------------------------------------------------
# IR transfer coefficients + right-hand side (langw)
# --------------------------------------------------------------------------

def langw_coefficients(dtau, om, pl):
    """IR two-stream coefficients a4, a5, a6 [B, P, 2, L]."""
    u = 1.66
    dtu = dtau * u
    ak = 1.0 - om
    b0 = (3.0 - pl[..., 0, :]) / 8.0
    alph1 = u * (1.0 - (1.0 - b0) * om)
    alph2 = u * b0 * om

    # case 4: absorption and scattering
    eps = torch.sqrt(torch.clamp(alph1 ** 2 - alph2 ** 2, min=1e-300))
    epstau = eps * dtau
    e = torch.where(epstau < 87.0, torch.exp(-torch.clamp(epstau, max=87.0)),
                    0.0)
    rm = alph2 / (alph1 + eps)
    eq, rmq = e * e, rm * rm
    rn = 1.0 - eq * rmq
    a4_4 = e * (1.0 - rmq) / rn
    a5_4 = rm * (1.0 - eq) / rn
    denom = (alph1 + alph2) * dtau
    a6_4 = torch.where((alph1 + alph2).abs() >= 1e-300,
                       (1.0 - a4_4 - a5_4) / torch.clamp(denom, min=1e-300),
                       1.0)

    # case 3: no absorption
    at = alph1 * dtau
    a4_3 = 1.0 / (1.0 + at)
    a5_3 = a4_3 * at

    # case 2: no scattering
    a4_2 = torch.exp(-torch.clamp(dtu, max=75.0))
    a6_2 = (1.0 - a4_2) / dtu

    no_ext = dtau <= 1.0e-7
    no_scat = om <= 1.0e-7
    no_abs = ak <= 1.0e-7

    a4 = torch.where(no_abs, a4_3, a4_4)
    a5 = torch.where(no_abs, a5_3, a5_4)
    a6 = torch.where(no_abs, 0.0, a6_4)
    a4 = torch.where(no_scat, a4_2, a4)
    a5 = torch.where(no_scat, 0.0, a5)
    a6 = torch.where(no_scat, a6_2, a6)
    a4 = torch.where(no_ext, 1.0, a4)
    a5 = torch.where(no_ext, 0.0, a5)
    a6 = torch.where(no_ext, 1.0, a6)
    return a4, a5, a6


def langw_rhs(a4, a5, a6, pib, pibs, frac, emis_pair, bb):
    """Right-hand side of the IR diffuse system (langw, nrad.f90:2851-2886).

    pib [B, P, L+1]; pibs [B, P]; frac [B, L]; emis_pair [P]; bb [B, 4, L].
    Returns f1f, f1w, f2f, f2w [B, P, L+1].
    """
    B, P, _, L = a4.shape
    db = pib[..., :-1] - pib[..., 1:]                        # [B, P, L]
    f1f = (1.0 - frac)[:, None, :] * a6[:, :, 0, :] * db
    f1w = frac[:, None, :] * a6[:, :, 1, :] * db
    f2f = torch.cat([pib[..., :1], -f1f], dim=-1)            # [B, P, L+1]
    f2w = torch.cat([pib.new_zeros((B, P, 1)), -f1w], dim=-1)

    agdb = emis_pair * (pib[..., L] - pibs) \
        + (1.0 - emis_pair) ** 2 * (pib[..., L] - pib[..., L - 1]) \
        * a6[:, :, 0, L - 1] * (1.0 - frac[:, L - 1:L])
    f1w_sfc = agdb * frac[:, L - 1:L]
    f1f_sfc = agdb - f1w_sfc
    f1f = torch.cat([f1f, f1f_sfc[..., None]], dim=-1)
    f1w = torch.cat([f1w, f1w_sfc[..., None]], dim=-1)

    # upper boundary condition folded into the first interior equations
    ha = bb[:, 0, 0:1] * f2f[..., 0]
    hb = f2f[..., 0] - ha
    f2f[..., 1] += a4[:, :, 0, 0] * ha
    f1f[..., 0] += a5[:, :, 0, 0] * ha
    f2w[..., 1] += a4[:, :, 1, 0] * hb
    f1w[..., 0] += a5[:, :, 1, 0] * hb
    return f1f, f1w, f2f, f2w


# --------------------------------------------------------------------------
# block-tridiagonal elimination + back-substitution (jeanfr)
# --------------------------------------------------------------------------

def jeanfr(a4, a5, bb, cc, f1f, f1w, f2f, f2w, ae_pair):
    """Solve the diffuse-flux system (jeanfr, nrad.f90:2887-3043).

    a4/a5 [B, P, 2, L]; bb/cc [B, 4, L]; flux right-hand sides
    [B, P, L+1]; ae_pair [P] albedo (solar) or 1-emissivity (IR).
    Returns updated f1f, f1w, f2f, f2w.
    """
    B, P, _, L = a4.shape
    (a4f_l, a4w_l), (a5f_l, a5w_l) = _layers(a4), _layers(a5)
    bb1_l, bb2_l, bb4_l = (_factor_layers(bb, k) for k in (0, 1, 3))
    cc1_l, cc3_l, cc4_l = (_factor_layers(cc, k) for k in (1, 2, 3))
    # right-hand sides per level: f1f, f1w, f2f, f2w
    rhs = torch.stack([f1f, f1w, f2f, f2w]).permute(3, 0, 1, 2) \
        .contiguous().unbind(0)                              # L+1 x [4,B,P]

    # per layer j: tu1..tu9 of layer j, then f1f, f1w at level j and f2f,
    # f2w at level j+1 after the forward elimination; layer 0 holds the
    # first-layer upper-diagonal elements and the unchanged right-hand side
    fw = a4.new_empty((L, 13, B, P))
    fw_l = fw.unbind(0)
    a4f, a4w, a5f, a5w = a4f_l[0], a4w_l[0], a5f_l[0], a5w_l[0]
    bb2, bb4, cc2, cc4 = bb2_l[0], bb4_l[0], cc1_l[0], cc4_l[0]
    tu6, tu7, tu8, tu9 = a5f * bb2, a5f * cc4, a5w * cc2, a5w * bb4
    torch.stack([torch.zeros_like(a4f), a4f * bb2, a4f * cc4, a4w * cc2,
                 a4w * bb4, tu6, tu7, tu8, tu9, *rhs[0][:2], *rhs[1][2:]],
                out=fw_l[0])

    f2f_j, f2w_j = rhs[1][2], rhs[1][3]
    for j in range(1, L):
        a4f, a4w, a5f, a5w = a4f_l[j], a4w_l[j], a5f_l[j], a5w_l[j]
        bb1, bb2, bb4 = bb1_l[j], bb2_l[j], bb4_l[j]
        cc1, cc3, cc4 = cc1_l[j], cc3_l[j], cc4_l[j]
        f1f_j, f1w_j, _, _ = rhs[j].unbind(0)
        _, _, f2f_jp, f2w_jp = rhs[j + 1].unbind(0)
        ga = bb1 * tu6
        gb = tu6 - ga
        gc = cc3 * tu8
        gd = tu8 - gc
        ha = ga + gc
        hc = gb + gd
        ga = bb1 * tu7
        gb = tu7 - ga
        gc = cc3 * tu9
        gd = tu9 - gc
        hb = ga + gc
        hd = gb + gd
        ga = bb1 * f2f_j
        ge = f2f_j - ga
        gc = cc3 * f2w_j
        gf = f2w_j - gc
        gb = ga + gc
        gd = ge + gf
        td1 = 1.0 / (1.0 - a5f * ha)
        f1f_o = td1 * (f1f_j + a5f * gb)
        tu1 = td1 * a5f * hb
        fa = td1 * a4f
        tu2 = fa * bb2
        tu3 = fa * cc4
        td2 = a5w * hc
        td3 = 1.0 / (1.0 - a5w * hd - td2 * tu1)
        f1w_o = td3 * (f1w_j + a5w * gd + td2 * f1f_o)
        td4 = a4f * ha
        td5 = a4f * hb + td4 * tu1
        f2f_j = f2f_jp + a4f * gb + td4 * f1f_o + td5 * f1w_o
        tu4 = td3 * (a4w * cc1 + td2 * tu2)
        tu5 = td3 * (a4w * bb4 + td2 * tu3)
        tu6 = a5f * bb2 + td4 * tu2 + td5 * tu4
        tu7 = a5f * cc4 + td4 * tu3 + td5 * tu5
        td6 = a4w * hc
        td7 = a4w * hd + td6 * tu1
        f2w_j = f2w_jp + a4w * gd + td6 * f1f_o + td7 * f1w_o
        tu8 = a5w * cc1 + td6 * tu2 + td7 * tu4
        tu9 = a5w * bb4 + td6 * tu3 + td7 * tu5
        torch.stack([tu1, tu2, tu3, tu4, tu5, tu6, tu7, tu8, tu9,
                     f1f_o, f1w_o, f2f_j, f2w_j], out=fw_l[j])

    # surface elimination (tu6..tu9 and f2f_j, f2w_j of the last layer;
    # f2f, f2w at level L)
    tds1 = 1.0 / (1.0 - ae_pair * tu6)
    f1f_s = tds1 * (rhs[L][0] + ae_pair * f2f_j)
    tus1 = tds1 * ae_pair * tu7
    tds2 = ae_pair * tu8
    tds3 = 1.0 / (1.0 - ae_pair * tu9 - tds2 * tus1)
    f1w_s = tds3 * (rhs[L][1] + ae_pair * f2w_j + tds2 * f1f_s)
    f1f_s = f1f_s + tus1 * f1w_s

    # back-substitution bottom-up: per layer j, f1f, f1w at level j and
    # f2f, f2w at level j+1
    bw = a4.new_empty((L, 4, B, P))
    bw_l = bw.unbind(0)
    f1f_jp, f1w_jp = f1f_s, f1w_s
    for j in range(L - 1, -1, -1):
        tu = fw_l[j].unbind(0)
        f2w_o = tu[12] + tu[7] * f1f_jp + tu[8] * f1w_jp
        f2f_o = tu[11] + tu[5] * f1f_jp + tu[6] * f1w_jp
        f1w_o = tu[10] + tu[3] * f1f_jp + tu[4] * f1w_jp
        f1f_o = tu[9] + tu[1] * f1f_jp + tu[2] * f1w_jp + tu[0] * f1w_o
        torch.stack([f1f_o, f1w_o, f2f_o, f2w_o], out=bw_l[j])
        f1f_jp, f1w_jp = f1f_o, f1w_o

    f1 = torch.cat([bw[:, :2], torch.stack([f1f_s, f1w_s])[None]])
    f2 = torch.cat([rhs[0][None, 2:], bw[:, 2:]])
    f1f, f1w = f1.permute(1, 2, 3, 0).unbind(0)
    f2f, f2w = f2.permute(1, 2, 3, 0).unbind(0)
    return f1f, f1w, f2f, f2w
