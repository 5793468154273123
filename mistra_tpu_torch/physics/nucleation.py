"""Aerosol nucleation: Napari ternary, Lovejoy OIO, Kerminen-Kulmala
apparent rate, over a column batch (torch counterpart of
``mistra_tpu.physics.nucleation``).

Every quantity is a [B, n] tensor: the scheme is one elementwise
evaluation per level plus two small contractions over the particle grid,
with no per-level control flow.

Parity map: mod_nuc/nuc_init nuc.f90:47-334 (default vapor list: OIO,
non-volatile), appnucl :427-1009, appnucl2 :335-426, dmean :1015-1077,
ternucl :1078-1247, oionucl :1248-1385, J_nuc (Napari 2002 polynomial)
:1386-1485.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import CONV1, PI, RHO3, RHOW
from .microphysics import rgl

# Napari et al. 2002 polynomial table fpd[20, 4] (nuc.f90:1436-1457)
FPD = np.array([
    [-0.355297, -3.38448e+1, 0.34536, -8.24007e-4],
    [3.13735, -0.772861, 5.61204e-3, -9.74576e-6],
    [1.90359e+1, -0.170957, 4.79808e-4, -4.14699e-7],
    [1.07605, 1.48932, -7.96052e-3, 7.61229e-6],
    [6.0916, -1.25378, 9.39836e-3, -1.74927e-5],
    [0.31176, 1.64009, -3.43852e-3, -1.09753e-5],
    [-2.00735e-2, -0.752115, 5.25813e-3, -8.98038e-6],
    [0.165536, 3.26623, -4.89703e-2, 1.46967e-4],
    [6.52645, -0.258002, 1.43456e-3, -2.02036e-6],
    [3.68024, -0.204098, 1.06259e-3, -1.26560e-6],
    [-6.6514e-2, -7.82382, 1.22938e-2, 6.18554e-5],
    [0.65874, 0.190542, -1.65718e-3, 3.41744e-6],
    [5.99321e-2, 5.96475, -3.62432e-2, 4.93337e-5],
    [-0.732731, -1.84179e-2, 1.47186e-4, -2.37711e-7],
    [0.728429, 3.64736, -2.7422e-2, 4.93478e-5],
    [4.13016e+1, -0.35752, 9.04383e-4, -5.73788e-7],
    [-0.160336, 8.89881e-3, -5.39514e-5, 8.39522e-8],
    [8.57868, -0.112358, 4.72626e-4, -6.48365e-7],
    [5.301767e-2, -1.98815, 1.57827e-2, -2.93564e-5],
    [-2.32736, 2.34646e-2, -7.6519e-5, 8.0459e-8],
])

# default vapor list (nuc_init, nuc.f90:186-216): OIO, plus the H2SO4/NH3
# handles of the Napari path; (name, molar mass [kg/mol])
VAPORS = (("OIO", 0.1589), ("H2SO4", 0.09808), ("NH3", 0.017))


def j_nuc_napari(rh, nh3_ppt, h2so4, temp):
    """Ternary H2SO4-H2O-NH3 nucleation rate [1/cm3/s] (nuc.f90:1386-
    1485); valid H2SO4 1e4-1e9 /cm3, NH3 0.1-100 ppt.  Computed in
    float64 for every dtype and returned in temp's: the cubic-in-T
    coefficients cancel to ~1e-2 of their terms, and in float32 the
    rate's exponent then carries ~1e-2 of rounding."""
    dtype = temp.dtype
    rh, nh3_ppt, h2so4, temp = (x.double() for x in (rh, nh3_ppt, h2so4,
                                                      temp))
    lnc = torch.log(torch.clamp(h2so4, min=1.0))
    lns = torch.log(torch.clamp(nh3_ppt, min=1e-30))
    lnrh = torch.log(torch.clamp(rh, min=1e-30))
    f = [FPD[i, 0] + FPD[i, 1] * temp + FPD[i, 2] * temp ** 2
         + FPD[i, 3] * temp ** 3 for i in range(20)]
    expo = (-84.7551 + f[0] / lnc + f[1] * lnc + f[2] * lnc ** 2
            + f[3] * lns + f[4] * lns ** 2 + f[5] * rh + f[6] * lnrh
            + f[7] * lns / lnc + f[8] * lns * lnc + f[9] * rh * lnc
            + f[10] * rh / lnc + f[11] * rh * lns + f[12] * lnrh / lnc
            + f[13] * lnrh * lns + f[14] * lns ** 2 / lnc
            + f[15] * lnc * lns ** 2 + f[16] * lnc ** 2 * lns
            + f[17] * rh * lns ** 2 + f[18] * rh * lns / lnc
            + f[19] * lnc ** 2 * lns ** 2)
    return torch.exp(torch.clamp(expo, max=700.0)).to(dtype)


def ternucl(rh, nh3_ppt, h2so4_cm3, temp):
    """Napari critical-cluster rate + composition (nuc.f90:1078-1247).
    Returns (Jn [1/cm3/s], nh, nn, dc [nm]) per level, computed in float64
    (as ``j_nuc_napari``) and returned in temp's dtype."""
    dtype = temp.dtype
    rh, nh3_ppt, h2so4_cm3, temp = (x.double() for x in (
        rh, nh3_ppt, h2so4_cm3, temp))
    nh3c = torch.clamp(nh3_ppt, max=100.0)
    jn = torch.clamp(j_nuc_napari(rh, nh3c, h2so4_cm3, temp), max=1.0e6)
    jn = torch.where(h2so4_cm3 > 1.0e4, jn, 0.0)
    lnj = torch.log(torch.clamp(jn, min=1e-30))
    nh = (38.1645 + 0.774106 * lnj + 2.98879e-3 * lnj ** 2
          - 0.357605 * temp - 3.66358e-3 * lnj * temp
          + 8.553e-4 * temp ** 2)
    nn = (26.8982 + 0.682905 * lnj + 3.57521e-3 * lnj ** 2
          - 0.265748 * temp - 3.41895e-3 * lnj * temp
          + 6.73454e-4 * temp ** 2)
    rc = (0.141027 - 1.22625e-3 * lnj - 7.82211e-6 * lnj ** 2
          - 1.56727e-3 * temp - 3.076e-5 * lnj * temp
          + 1.08375e-5 * temp ** 2)
    active = jn >= 0.01
    nh = torch.where(active, torch.clamp(nh, min=0.0), 0.0)
    nn = torch.where(active, torch.clamp(nn, min=0.0), 0.0)
    dc = torch.where(active, 2.0 * rc, 2.0)
    jn = torch.where(active, jn, 0.0)
    return tuple(x.to(dtype) for x in (jn, nh, nn, dc))


def oionucl(oio_ppt, temp):
    """Lovejoy/Burkholder homogeneous OIO nucleation (nuc.f90:1248-
    1385): J = oio^(0.030657 T - 4.4471) exp(-0.30947 T + 81.097),
    capped at 1e4; 34 OIO molecules per 2-nm cluster."""
    j2_ = torch.where(
        oio_ppt > 0.01,
        torch.clamp(torch.clamp(oio_ppt, min=1e-30)
                    ** (0.030657 * temp - 4.4471)
                    * torch.exp(-0.30947 * temp + 81.097), max=1.0e4),
        0.0)
    jnio = torch.where(j2_ >= 0.01, j2_, 0.0)
    return jnio, torch.full_like(temp, 2.0)


def background_membership(micro_grid):
    """The static membership matrix [nkt, nkt, nka] of background_spectrum:
    entry (j, t, k) is 1 where bin (t, k) counts into total-diameter class
    j of the first dry bin (appnucl, nuc.f90:688-719)."""
    rq = np.asarray(micro_grid.rq)            # [nkt, nka]
    rw1 = np.asarray(micro_grid.rw)[:, 0]     # [nkt] class bounds, ia=1
    rn = np.asarray(micro_grid.rn)
    lower = np.concatenate([[-np.inf], rw1[:-1]])
    member = ((rq[None, :, :] <= rw1[:, None, None])
              & (rq[None, :, :] > lower[:, None, None])
              & (rn[None, None, :] <= rw1[:, None, None]))
    return member.astype(np.float64)


def background_spectrum(ff, member):
    """1-D particle number Np [B, nkt, n] on the total-diameter grid of the
    first dry bin; ff [B, nkt, nka, n], member from
    ``background_membership`` as a tensor of ff's dtype."""
    return torch.einsum("jtk,btkn->bjn", member, ff)


class NucleationDriver:
    """Apparent-nucleation step (appnucl, nuc.f90:427-1009) of a Model
    whose chemistry driver is installed: the vapors are looked up in the
    driver's concentration field (``conc_n2i``).

    Over the model's dry bins (``model.bins``): the background spectrum
    and the new fsum are sums over the bins (one all_reduce each over the
    tp ranks), the new particles go to global dry bin 0 (on the rank
    that holds it), and everything else, the vapor consumption included,
    is computed from replicated quantities on every rank."""

    def __init__(self, model):
        self.model = model
        cfg = model.cfg
        self.napari = cfg.napari
        self.lovejoy = cfg.lovejoy
        self.ifeed = cfg.ifeed
        self.alphaa = 1.0
        drv = model._chemistry
        self.n2i = drv.conc_n2i
        self.conc_name = drv.conc_name
        self.vapors = [(name, self.n2i[name], mass) for name, mass in VAPORS
                       if name in self.n2i]
        self.dtype = drv.dtype
        mg = model.grids.micro

        def t(x):
            return torch.as_tensor(np.asarray(x), dtype=self.dtype,
                                   device=model.device)

        self._member = model.bins.take(t(background_membership(mg)), 2)
        self._zdp = t(np.asarray(mg.rq)[:, 0] * 2000.0)       # [nkt]
        self._rw1 = t(np.ascontiguousarray(np.asarray(mg.rw)[:, 0]))
        self._zdpmin = float(np.asarray(mg.rn)[0] * 2000.0)

    def __call__(self, state, dt):
        """Apparent-nucleation step; returns (state, diagnostics), each
        diagnostic [B, n].  With both mechanisms enabled the reference
        runs the apparent-nucleation machinery once per real mechanism
        and combines (appnucl2, nuc.f90:335-426): rates add, growth rates
        average, cluster concentrations follow the larger-rate
        mechanism."""
        if self.napari and self.lovejoy:
            state, d1 = self._appnucl(state, dt, napari=True, lovejoy=False)
            state, d2 = self._appnucl(state, dt, napari=False, lovejoy=True)
            xn = d1["xn_app"] + d2["xn_app"]
            num = torch.where(
                d2["concnuc"] >= d1["concnuc"],
                torch.where(xn - d1["xn_app"] > 0.01,
                            d2["concnuc"] * xn
                            / torch.clamp(xn - d1["xn_app"], min=1e-30),
                            d2["concnuc"]),
                d1["concnuc"] * xn / torch.clamp(d1["xn_app"], min=1e-30))
            diag = {"xn_app": xn,
                    "grorate": 0.5 * (d1["grorate"] + d2["grorate"]),
                    "dnucv": d1["dnucv"] + d2["dnucv"],
                    "concnuc": num,
                    "j_real": d1["j_real"] + d2["j_real"]}
            return state, diag
        return self._appnucl(state, dt, napari=self.napari,
                             lovejoy=self.lovejoy)

    def _condensing(self, napari):
        """The vapors that condense on the nuclei of one mechanism: H2SO4
        and NH3 for Napari, the others (OIO) for Lovejoy."""
        return [v for v in self.vapors
                if (napari and v[0] != "OIO")
                or (not napari and v[0] not in ("H2SO4", "NH3"))]

    def _appnucl(self, state, dt, napari, lovejoy):
        m = self.model
        met, chem, micro = state.met, state.chem, state.micro
        B, n = met.t.shape
        dev = met.t.device
        drv = m._chemistry

        temp = met.t
        press = met.p
        rh = torch.clamp(met.feu, max=0.999)
        am3 = drv.am3
        conc = getattr(chem, self.conc_name)
        get = {nm: torch.clamp(conc[:, idx], min=0.0)
               for nm, idx, _ in self.vapors}

        # "real" nucleation rate + initial cluster size
        if napari and "H2SO4" in get:
            nh3 = get.get("NH3", torch.zeros_like(temp))
            jn, nhp, nnp, dc = ternucl(rh, nh3 / am3 * 1e12,
                                       get["H2SO4"] * CONV1, temp)
            j_real, d_nucini = jn, dc
        elif lovejoy and "OIO" in get:
            j_real, d_nucini = oionucl(get["OIO"] / am3 * 1e12, temp)
        else:
            j_real = torch.full_like(temp, 1000.0)
            d_nucini = torch.full_like(temp, 1.0)

        # background spectrum and condensation sink
        lam = 2.28e-5 * temp / press
        np_1d = m.bins.sum_bins(background_spectrum(micro.ff,
                                                    self._member))
        zdp = self._zdp[:, None]
        kn = 2.0e9 * lam[:, None, :] / zdp
        beta = (1.0 + kn) / (1.0 + 0.377 * kn
                             + 1.33 * kn * (1.0 + kn) / self.alphaa)
        cs = torch.sum(0.5 * zdp * 1.0e-7 * beta * np_1d, dim=1)

        nges = torch.sum(np_1d, dim=1)
        d_mean = torch.where(nges > 0.0,
                             torch.sum(zdp * np_1d, dim=1)
                             / torch.clamp(nges, min=1e-30), 1.0)

        # nuclei growth rate by condensation (non-volatile vapors)
        condensing = self._condensing(napari)
        gr = torch.zeros_like(temp)
        m_wsum = torch.zeros_like(temp)
        for nm, _, mass in condensing:
            vmean = torch.sqrt(temp / mass) * 4.60138
            gr = gr + vmean * mass * (get[nm] * CONV1)
            m_wsum = m_wsum + mass * torch.ones_like(temp)
        m_vapmean = m_wsum / max(1, len(condensing))
        knnuc = 2.0e9 * lam / d_nucini
        betanuc = (1.0 + knnuc) / (1.0 + 0.377 * knnuc + 1.33 * knnuc
                                   * (1.0 + knnuc) / self.alphaa)
        gr = gr * 7969.45 * lam * betanuc / d_nucini / RHO3   # [nm/h]

        # equilibrium size of the smallest dry bin at ambient RH
        zdpmin = self._zdpmin
        a0mn = 152200.0 / (461.51 * RHO3)
        b0mn = 0.018 / torch.clamp(m_vapmean, min=1e-3)
        rg = rgl(torch.full_like(temp, zdpmin / 2000.0), a0mn / temp,
                 b0mn * RHO3 / RHOW, rh)
        nkt = self._rw1.shape[0]
        jts = torch.clamp(torch.searchsorted(self._rw1, rg), 0,
                          nkt - 1)                            # [B, n]
        zdpmint = self._zdp[jts]
        gr = gr * zdpmint / zdpmin

        gamma = (2300.0 * d_nucini ** 0.2 * (zdpmint / 3.0) ** 0.075
                 * (d_mean / 150.0) ** 0.048 * (RHO3 / 1000.0) ** (-0.33)
                 * (temp / 293.0) ** (-0.75))
        eta = gamma * cs / torch.clamp(gr, min=1e-30)
        j_app = j_real * torch.exp(torch.clamp(eta / zdpmint - eta / d_nucini,
                                               -700.0, 0.0))
        j_app = torch.where((gr > 1e-2) & (j_real > 0.01), j_app, 0.0)
        lev = torch.arange(n, device=dev)
        j_app = torch.where((lev >= 1) & (lev <= n - 2), j_app, 0.0)
        active = j_app > 0.1

        # feedback: new particles into the smallest dry bin at class jts
        # (global bin 0: the rank whose bins start there adds them)
        if self.ifeed != 0:
            ff = micro.ff
            if m.bins.lo == 0:
                onehot = (torch.arange(nkt, device=dev)[None, :, None]
                          == jts[:, None, :]).to(self.dtype)  # [B, nkt, n]
                add = torch.where(active, j_app * dt, 0.0)
                ff = ff.clone()
                ff[:, :, 0, :] = ff[:, :, 0, :] + onehot * add[:, None, :]
            micro = micro.replace(ff=ff, fsum=m.bins.sum_bins(
                torch.sum(ff, dim=(1, 2))))

        # vapor consumption: new dry mass [mol/m3]
        deltax = torch.where(active,
                             j_app * dt * PI / 6.0
                             * (zdpmin ** 3 - d_nucini ** 3)
                             * RHO3 / torch.clamp(m_vapmean, min=1e-3)
                             * 1e-21, 0.0)
        conc = conc.clone()
        for nm, idx, _ in condensing:
            old = conc[:, idx].clone()
            new = torch.clamp(old - deltax / max(1, len(condensing)),
                              min=0.0)
            conc[:, idx] = new
            # mass-conserving transfer to the aqueous phase (OIO ->
            # unreactive; H2SO4 -> H2SO4l1; nuc.f90:964-971)
            sink = self.n2i.get(f"{nm}l1")
            if sink is not None:
                conc[:, sink] = conc[:, sink] + (old - new)

        # Napari consumes cluster H2SO4/NH3 as well (ternucl)
        if napari and "H2SO4" in get:
            use = torch.where(jn >= 0.01, jn * dt, 0.0)
            for nm, nmol in (("H2SO4", nhp), ("NH3", nnp)):
                idx = self.n2i.get(nm)
                if idx is not None:
                    conc[:, idx] = torch.clamp(
                        conc[:, idx] - use * nmol / CONV1, min=0.0)

        chem = chem.replace(**{self.conc_name: conc})
        # diagnostics (nucout1/2 channel set, nuc.f90:1492-1687)
        diag = {"xn_app": j_app, "grorate": gr, "dnucv": deltax,
                "concnuc": torch.where(active, j_real * dt, 0.0),
                "j_real": j_real}
        return state.replace(micro=micro, chem=chem), diag
