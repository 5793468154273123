# Frozen copy of mistra_tpu_torch/photolysis/jrates.py (lines 1-268, commit b2518445).
"""Photolysis driver: profiles -> optical depths -> actinic fluxes -> the
47 J-rates of the mechanism (reference photol, jrate.f:95-399), in torch.

Port of ``mistra_tpu/photolysis/jrates.py``, batched over columns.  The
J-rate indexing (1-based slots of photol_j) follows the reference's copy
loop (jrate.f:330-395).  Each rate is the direct spectral integral
J(k) = sum_l sigma(l, T_k) * qy(l, T_k) * F_act(l, k) over the 176
intervals, evaluated with the same cross-section tables.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from . import solver as S
from .tables import CT_TOP, MAXWAV, PhotolysisTables, load_photolysis_tables

NPHRXN = 47

# photol_j slot (1-based) -> cross-section recipe:
#   ("cs", name)            single-T cross section
#   ("cst", name)           T-interpolated cross section
# optional quantum-yield channel and scale factor applied afterwards.
J_RECIPES = {
    1: ("cst", "NO2", "NO2", 1.0),
    2: ("cst", "NO3", "NOO2", 1.0),
    4: ("cs", "HONO", None, 1.0),
    5: ("cs", "HNO3", "T_HNO3", 1.0),
    6: ("cs", "H2O2", None, 1.0),
    7: ("cs", "HNO4", None, 2.0 / 3.0),
    8: ("cst", "CH2O", "CHOH", 1.0),
    9: ("cst", "CH2O", "COH2", 1.0),
    10: ("cst", "NO3", "NO2O", 1.0),
    11: ("cs", "HNO4", None, 1.0 / 3.0),
    12: ("cs", "N2O5", None, 1.0),
    13: ("cs", "HOCl", None, 1.0),
    14: ("cst", "ClONO2", None, 1.0),
    15: ("cs", "BrNO3", None, 1.0),
    16: ("cs", "Cl2O2", None, 1.0),
    17: ("cs", "CH3OOH", None, 1.0),
    18: ("cs", "ClNO2", None, 1.0),
    19: ("cs", "Cl2_noT", None, 1.0),
    20: ("cs", "HOBr", None, 1.0),
    21: ("cs", "BrNO2", None, 1.0),
    22: ("cs", "Br2", None, 1.0),
    23: ("cs", "BrCl_noT", None, 1.0),
    24: ("cs", "BrO_noT", None, 1.0),
    25: ("cs", "IO", None, 1.0),
    26: ("cs", "HOI_Jen91", None, 1.0),
    27: ("cs", "I2", None, 1.0),
    28: ("cs", "ICl", None, 1.0),
    29: ("cs", "IBr", None, 1.0),
    30: ("cs", "INO3", None, 1.0),
    31: ("cs", "CH3I", None, 1.0),
    32: ("cs", "C3H7I", None, 1.0),
    33: ("cs", "CH2ClI", None, 1.0),
    34: ("cs", "CH2I2", None, 1.0),
    35: ("cs", "OClO_noT", None, 1.0),
    37: ("cs", "INO2", None, 1.0),
    38: ("cs", "NO2m", None, 1.0),
    39: ("cs", "NO3n", "QYNO3n", 1.0),
    41: ("cs", "dumm24", None, 1.0),
    42: ("cs", "dumm25", None, 1.0),
    43: ("cs", "dumm26", None, 1.0),
}
# derived slots: 3 (O1D), 47 (O3P), 36 (I2O2 = 9 x J16),
# 40 (OIO = J35), 44 (CH2BrI = J34/17), 46 (C2H5I = J31), 45 unused.


class TableTensors:
    """The photolysis tables as tensors of one dtype on one device."""

    def __init__(self, tb: PhotolysisTables, dtype, device):
        def t(x):
            return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

        self.cs = {k: t(v) for k, v in tb.cs.items()}
        self.cs_t = {k: (t(a), tuple(float(x) for x in temps))
                     for k, (a, temps) in tb.cs_t.items()}
        self.qy = {k: t(v) for k, v in tb.qy.items()}
        self.coeff_hno3 = t(tb.coeff_hno3)
        self.cheb_a, self.cheb_b = t(tb.cheb_a), t(tb.cheb_b)
        self.cs_ray = t(tb.cs_ray)
        self.flux = t(tb.flux)
        self.ct_top = t(CT_TOP)
        base, a, b, hi = S.o1d_tables(tb.wave)
        self.o1d = (t(base), t(a), t(b),
                    torch.as_tensor(hi, dtype=torch.bool, device=device))


def compute_jrates(tt: TableTensors, press_pa, temp, qmo3, u0, taer_s,
                   taer_a, ga_pl, albedo, scaleo3):
    """Full photolysis calculation on the radiation grid (top-down) of B
    columns.

    Args:
      tt: the tables as tensors (``TableTensors``).
      press_pa, temp, qmo3: [B, nrlev] level values (top-down, level 0 =
        the uppermost model level; the virtual "infinity" level is added
        here).
      u0 [B]: cosine of the solar zenith angle.
      taer_s/taer_a/ga_pl: [B, nrlay] aerosol optics from the radiation
        code.
      albedo: scalar shortwave albedo.  scaleo3: O3 column [DU].

    Returns photol_j [B, NPHRXN, nrlay+1] (top-down levels incl. the
    virtual top).
    """
    B, nrlev = press_pa.shape
    L = nrlev - 1  # nrlay

    # virtual level 0 (reference read_data:507-516): it replaces index 0
    press = press_pa / 100.0
    p0 = 0.37 * press[:, :1]
    dp = press[:, 1:2] - press[:, :1]
    t0 = (temp[:, 1:2] - temp[:, :1]) / dp * (-0.63) * press[:, :1] \
        + temp[:, :1]
    o30 = (qmo3[:, 1:2] - qmo3[:, :1]) / dp * (-0.63) * press[:, :1] \
        + qmo3[:, :1]
    press_l = torch.cat([p0, press[:, 1:]], dim=1)
    temp_l = torch.cat([t0, temp[:, 1:]], dim=1)
    o3_l = torch.cat([o30, qmo3[:, 1:]], dim=1)

    cols = S.column_densities(press_l, temp_l, o3_l, u0, scaleo3)
    v2s, dv2, dv3 = cols["v2s"], cols["dv2"], cols["dv3"]

    # cross sections on levels
    cst_o3 = S.interp_t(*tt.cs_t["O3"], temp_l)        # [B, L+1, 176]
    sro2 = S.sr_o2_km(tt.cheb_a, tt.cheb_b, v2s, temp_l)   # [B, 13, L+1]
    cst_o2 = torch.cat([sro2.transpose(1, 2),
                        tt.cs["O2"][13:].expand(B, L + 1, MAXWAV - 13)],
                       dim=-1)
    qyo1d = S.qy_o1d(*tt.o1d, temp_l)                  # [B, L+1, 176]

    # ---- optical depths per layer and wavelength -------------------------
    ta_o2 = 0.5 * (cst_o2[:, :-1] + cst_o2[:, 1:]) * dv2[..., None]
    # top layer Schumann-Runge handled by the fitted TOA polynomial
    dlv2s = torch.log(torch.clamp(v2s[:, :1], min=1.0))        # [B, 1]
    ct = tt.ct_top                                             # [13, 4]
    toa_poly = u0[:, None] * torch.exp(
        ct[:, 0] + (ct[:, 1] + (ct[:, 2] + ct[:, 3] * dlv2s) * dlv2s)
        * dlv2s)                                               # [B, 13]
    ta_o2 = torch.cat([
        torch.cat([toa_poly[:, None, :], ta_o2[:, :1, 13:]], dim=-1),
        ta_o2[:, 1:]], dim=1)
    ta_o3 = 0.5 * (cst_o3[:, :-1] + cst_o3[:, 1:]) * dv3[..., None]
    taua_clr = (ta_o2 + ta_o3).transpose(1, 2)                 # [B, 176, L]
    taus_clr = (tt.cs_ray / 0.21 * dv2[..., None]).transpose(1, 2)
    # SR band: absorption only
    taus_clr = torch.cat([torch.zeros_like(taus_clr[:, :13]),
                          taus_clr[:, 13:]], dim=1)

    taua = taua_clr + taer_a[:, None, :]
    taus = taus_clr + taer_s[:, None, :]

    # phase function moments: Rayleigh (2nd moment 0.1) + aerosol H-G
    wsca = torch.clamp(taus, min=1e-30)
    g = ga_pl[:, None, :]
    ts = taer_s[:, None, :]
    ww1 = 3.0 * g * ts / wsca
    ww2 = (5.0 * g ** 2 * ts + 0.1 * taus_clr) / wsca
    ww3 = 7.0 * g ** 3 * ts / wsca
    ww4 = 9.0 * g ** 4 * ts / wsca

    alb = torch.full_like(tt.flux, albedo)
    fact = S.four_stream(taus, taua, ww1, ww2, ww3, ww4, alb, tt.flux, u0)
    fact = torch.where((u0 > 0.0)[:, None, None], fact, 0.0)  # [B, 176, L+1]

    # ---- spectral J integrals -------------------------------------------
    def spectral_j(sigma):
        # sigma [176] or [B, L+1, 176] -> J [B, L+1]
        if sigma.dim() == 1:
            return torch.einsum("bwl,w->bl", fact, sigma)
        return torch.einsum("blw,bwl->bl", sigma, fact)

    jr = [None] * NPHRXN
    for slot, (kind, name, qy, scale) in J_RECIPES.items():
        if kind == "cs":
            sig = tt.cs[name]
        else:
            sig = S.interp_t(*tt.cs_t[name], temp_l)
        if qy == "T_HNO3":
            sig = sig * torch.exp(tt.coeff_hno3 * (temp_l[..., None] - 298.0))
        elif qy == "QYNO3n":
            qyno3 = 1.7e-2 * torch.exp(1800.0 * (1.0 / 298.0 - 1.0 / temp_l))
            sig = sig * qyno3[..., None]
        elif qy is not None:
            sig = sig * tt.qy[qy]
        jr[slot - 1] = scale * spectral_j(sig)

    # O3 channels with the Michelsen quantum yield
    jr[2] = spectral_j(cst_o3 * qyo1d)          # slot 3
    jr[46] = spectral_j(cst_o3 * (1.0 - qyo1d))  # slot 47
    # derived slots
    jr[35] = 9.0 * jr[15]                       # I2O2 = 9 x Cl2O2
    jr[39] = jr[34]                             # OIO = OClO
    jr[43] = jr[33] / 17.0                      # CH2BrI = CH2I2/17
    jr[45] = jr[30]                             # C2H5I = CH3I
    jr[44] = torch.zeros_like(jr[0])            # unused
    return torch.clamp(torch.stack(jr, dim=1), min=0.0)


class PhotolysisDriver:
    """Model-facing driver: profiles from the radiation stack -> photol_j
    [B, NPHRXN, n] on the model grid (bottom-up) for every column.

    Reads ``photolys/`` under ``cfg.inpdir`` (raises if the files are
    missing) and the radiation driver's profiles (``load_profile``), ozone
    and layer thicknesses, which exist once the radiation driver has made
    its first call.

    The calculation runs in float64 whatever the model's dtype, and the
    J-rates come back in the model's dtype.  In float32 the clip of the
    single-scattering albedo at 1 - 1e-11 rounds to 1, and a layer with
    no absorption (the virtual top layer in the Schumann-Runge band) turns
    the four-stream coefficients into NaN; the JAX package's float32 path
    gives the same NaN."""

    # the dtype of the calculation (see the class docstring)
    dtype = torch.float64

    def __init__(self, model, rad_driver):
        cfg = model.cfg
        self.model = model
        self.rad = rad_driver
        self.tb = load_photolysis_tables(os.path.join(cfg.inpdir,
                                                      "photolys/"))
        self.albedo = float(rad_driver.albedo[0])
        self.scaleo3 = cfg.scaleo3_m
        self._tensors = {}

    def tensors(self, device) -> TableTensors:
        """The tables on device, made once per device."""
        key = torch.device(device)
        if key not in self._tensors:
            self._tensors[key] = TableTensors(self.tb, self.dtype, key)
        return self._tensors[key]

    def __call__(self, state):
        """photol_j [B, NPHRXN, n] (bottom-up model levels)."""
        gp = self.model.cfg.grid
        n, nrlay = gp.n, gp.nrlay
        if not self.rad._static_built:
            self.rad.build_static(state)
        tx, px, rhox, xm1x, ts, bea, baa, ga = self.rad.load_profile(state)
        B = tx.shape[0]
        c = self.rad._consts(tx.device)

        # top-down level arrays in the calculation's dtype
        def td(x):
            return x.flip(-1).to(self.dtype)

        thk_td = c["thk_td"].to(self.dtype)
        bea_td, baa_td = td(bea[:, 0]), td(baa[:, 0])
        taer_s = (bea_td - baa_td) * thk_td
        taer_a = baa_td * thk_td

        jr = compute_jrates(self.tensors(tx.device), td(px), td(tx),
                            c["qmo3_td"].to(self.dtype).expand(B, -1),
                            state.rad.u0.to(self.dtype), taer_s, taer_a,
                            td(ga[:, 0]), self.albedo,
                            self.scaleo3)               # [B, 47, nrlay+1]
        # map to model levels: model level j (0-based) <-> rad level L - j
        idx = nrlay - torch.arange(n, device=jr.device)
        return jr[:, :, idx].to(state.met.t.dtype)
