"""Box and chamber model modes, over a batch of B boxes (torch counterpart
of ``mistra_tpu.boxmodel``).

The reference can collapse the 1-D column to a single well-mixed box
(``box=.true.``, str.f90:6613-7104) or a smog chamber
(``chamber=.true.``, str.f90:7699-7950): dynamics, microphysics and
radiation are frozen after initialisation and only chemistry (plus
deposition and sea-salt emission) runs at one level ``n_bl``.

The state keeps its leading column axis: B boxes step together, the
counterpart of the JAX package's vmapped box ensemble.  Every step runs
the column model's chemistry drivers, so the box shares their kernels.

Parity map: box_init/box_update str.f90:6613-6883, sedc_box
str.f90:6890-7014, box_partdep str.f90:7021-7104, get_n_box
str.f90:7229-7268, chamb_init/chamb_update str.f90:7699-7950,
photol_chamber kpp.f90:8606-8687, ave_j kpp.f90:6291-6343.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from .constants import AVOGADRO
from .model import Model, solar_zenith
from .physics import microphysics
from .physics.sedimentation import partdep
from .physics.thermo import p21

# gas deposition-velocity overrides for box runs (sedc_box,
# str.f90:6961-6990): name -> fixed value [m/s] or the species whose vg
# is copied
VG_FIXED = {"NH3": 0.27e-2, "DMS": 0.0, "CH3I": 0.0, "CH2I2": 0.0,
            "CH2ClI": 0.0, "C3H7I": 0.0, "CH2BrI": 0.0, "CHBr2I": 0.0,
            "C2H5I": 0.0}
VG_COPY = {"N2O5": "HCl", "HOCl": "HCl", "HOBr": "HCl", "CH3SO3H": "HCl",
           "I2O2": "HOI", "INO2": "HOI"}

N_BL = 1          # 0-based box level (reference n_bl = 2)
# the chamber's lights: on 15 min after the start, off after 2 h
# (chamb_update schedule)
LIGHTS_ON_S = 15.0 * 60.0
LIGHTS_OFF_S = 2.0 * 3600.0


def get_n_box(atm_grid, z_box):
    """Snap the box top to the nearest full-level boundary
    (str.f90:7229-7268)."""
    etw = np.asarray(atm_grid.etw)
    nz = int(np.argmin(np.abs(etw - z_box)))
    return nz, float(etw[nz])


def read_chamber_dat(path):
    """chamber.dat: t0 [K], rh0 [%], then measured J slots
    '<slot> <value> <name>' (photol_chamber, kpp.f90:8644-8661)."""
    with open(path) as f:
        lines = f.readlines()
    t0 = float(lines[0].split()[0])
    rh0 = float(lines[1].split()[0])
    jmeas = {}
    for line in lines[4:]:
        parts = line.split()
        if len(parts) >= 2:
            try:
                jmeas[int(parts[0])] = float(parts[1])
            except ValueError:
                continue
    return t0, rh0, jmeas


def write_synthetic_chamber_dat(dirpath) -> str:
    """Write a stand-in ``chamber.dat`` into dirpath and return its path.

    Not the reference's measurements: a file in ``read_chamber_dat``'s
    format (t0 288.23 K, rh0 70.35 %, two header lines, then measured J
    values of the slots of NO2, O3 -> O1D, HONO, NO3 and HCHO), for runs
    and tests where the reference's input files are absent.  Both
    packages read it.
    """
    lines = ["288.23   t0 [K]", "70.35    rh0 [%]",
             "measured photolysis frequencies [1/s]",
             "slot  value  reaction",
             "1  6.3e-3  NO2", "2  1.2e-5  O3->O1D", "7  1.1e-3  HONO",
             "8  1.6e-1  NO3", "12  2.4e-5  HCHO"]
    path = os.path.join(str(dirpath), "chamber.dat")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def chamber_dat_path(cfg) -> str:
    """Where ``BoxModel`` reads chamber.dat: ``cfg.cinpdir_phot`` when the
    configuration carries that attribute, else ``<cfg.inpdir>/photolys``."""
    base = getattr(cfg, "cinpdir_phot", None) \
        or os.path.join(cfg.inpdir, "photolys")
    return os.path.join(base, "chamber.dat")


class BoxModel:
    """Single-level (box / chamber) run of B boxes, reusing the column
    model's drivers.

    Args:
      cfg: a configuration with box=True or chamber=True.
      device: the ``Model`` the box owns runs there (the card by default;
        "cpu" runs the plain versions).
      bins: the model's dry bins (``Model``'s argument, the whole axis
        by default): with part of the axis, one rank of the ensemble
        mesh's "tp" axis, every sum over the bins takes an all_reduce
        over the tp ranks.
    """

    def __init__(self, cfg, device="cuda", bins=None):
        if not (cfg.box or cfg.chamber):
            raise ValueError("BoxModel requires cfg.box or cfg.chamber")
        self.cfg = cfg
        self.model = Model(cfg, device=device, bins=bins)
        self.device = self.model.device
        self.bins = self.model.bins
        if cfg.chamber:
            # chamber runs start at midday with fixed declination
            # (initm, str.f90:1075,1095)
            self.model.astro = dataclasses.replace(self.model.astro,
                                                   declin=18.0)
        self.nz_box, self.z_box = get_n_box(self.model.grids.atm,
                                            cfg.z_box)
        self.chamber_dat = read_chamber_dat(chamber_dat_path(cfg)) \
            if cfg.chamber else None

    # ------------------------------------------------------------------
    def init_state(self, B: int = 1):
        """Initial state of B identical boxes on the model's device: the
        column model's init, then the box level's temperature and humidity
        (box: level nlevbox; bl_box: the boundary-layer mean; chamber:
        chamber.dat), the particles re-equilibrated there (mic=True), and
        the frozen deposition velocities."""
        m = self.model
        cfg = self.cfg
        state = m.init_state(B)
        met = state.met
        p_bl = met.p[:, N_BL]

        def box_feu(xm1, t):
            return xm1 * p_bl / ((0.62198 + 0.37802 * xm1) * p21(t))

        if cfg.chamber:
            t0, rh0, _ = self.chamber_dat
            feu0 = rh0 * 1.0e-2
            t_bl = torch.full_like(p_bl, t0)
            zp21 = p21(t_bl)
            xm1_bl = (0.62198 * feu0 * zp21) / (p_bl - 0.37802 * feu0 * zp21)
            feu_bl = torch.full_like(p_bl, feu0)
        elif cfg.bl_box:
            # arithmetic average over the boundary layer (box_init)
            t_bl = met.t[:, 1:self.nz_box + 1].mean(dim=1)
            xm1_bl = met.xm1[:, 1:self.nz_box + 1].mean(dim=1)
            feu_bl = box_feu(xm1_bl, t_bl)
        else:
            t_bl = met.t[:, cfg.nlevbox - 1]
            xm1_bl = met.xm1[:, cfg.nlevbox - 1]
            feu_bl = box_feu(xm1_bl, t_bl)

        def at_box(x, v):
            x = x.clone()
            x[:, N_BL] = v
            return x

        met = met.replace(t=at_box(met.t, t_bl), xm1=at_box(met.xm1, xm1_bl),
                          feu=at_box(met.feu, feu_bl))
        if cfg.mic:
            # re-equilibrate the particle spectrum at the box level with
            # the overridden humidity (box_update/chamb_update both call
            # equil(1, n_bl) after resetting T/rh, str.f90:6846/7897)
            met, micro = microphysics.equil(
                met, state.micro, m.micro, m.consts["a0m"], m.b0m, 1,
                cfg.grid.nf, level=N_BL, bins=m.bins)
            state = state.replace(micro=micro)
        tim = state.tim.replace(kinv=torch.full_like(state.tim.kinv,
                                                     cfg.grid.nf))
        if cfg.chamber:
            tim = tim.replace(lst=torch.full_like(tim.lst, 12))
        state = state.replace(met=met, tim=tim)

        # particle deposition velocities once (frozen meteorology)
        vd, xra = partdep(m, state)
        return state.replace(micro=state.micro.replace(vd=vd, xra=xra))

    # ------------------------------------------------------------------
    def _sedc_box(self, state, dt):
        """Gas dry deposition + emission over the box depth
        (str.f90:6890-7014)."""
        drv = self.model._chemistry
        n2i = drv.conc_n2i
        vg = drv.gasdrydep(state)                          # [B, nvar]
        for sp, val in VG_FIXED.items():
            if sp in n2i:
                vg[:, n2i[sp]] = val
        for sp, src in VG_COPY.items():
            if sp in n2i and src in n2i:
                vg[:, n2i[sp]] = vg[:, n2i[src]]
        conc = getattr(state.chem, drv.conc_name)
        dep = torch.where(vg >= 1.0e-5, torch.exp(-dt / self.z_box * vg),
                          1.0)
        s_old = conc[:, :, N_BL]
        s_new = s_old * dep
        conc = conc.clone()
        conc[:, :, 0] = conc[:, :, 0] + (s_old - s_new) * self.z_box
        # emissions [molec/cm2/s] -> mol/m3
        conc[:, :, N_BL] = s_new + drv.conc_es * dt * 1.0e4 \
            / (self.z_box * AVOGADRO)
        return state.replace(chem=state.chem.replace(
            **{drv.conc_name: conc}))

    # ------------------------------------------------------------------
    def _box_partdep(self, state, dt):
        """Deposit particles and, with the multiphase driver, the dissolved
        species from the box (str.f90:7021-7104)."""
        micro = state.micro
        ff_old = micro.ff[..., N_BL]
        ff_new = ff_old * torch.exp(-dt / self.z_box * micro.vd)
        ff = micro.ff.clone()
        ff[..., N_BL] = ff_new
        ff[..., 0] = ff[..., 0] + (ff_old - ff_new) * self.z_box
        micro = micro.replace(ff=ff, fsum=self.model.bins.sum_bins(
            torch.sum(ff, dim=(1, 2))))
        state = state.replace(micro=micro)
        return self.model._chemistry.box_dissolved_deposition(
            state, dt, N_BL, self.z_box)

    # ------------------------------------------------------------------
    def _chamber_photolysis(self, state):
        """Measured J values, with unmeasured slots scaled by the jNO2
        ratio (photol_chamber); lights on 15 min after the start, off after
        2 h (chamb_update schedule).  Returns photol_j [B, nph, n], the box
        level's values on every level.  The model's J-rates are computed
        only when the lights are on in some box (one host check)."""
        _, _, jmeas = self.chamber_dat
        pj0 = state.chem.photol_j
        B, nph, n = pj0.shape
        t = state.tim.time
        lights = (t >= LIGHTS_ON_S) & (t < LIGHTS_OFF_S)
        if not bool(lights.any()):
            return torch.zeros_like(pj0)
        pj_model = self.model._photolysis(state)[:, :, N_BL]    # [B, nph]
        jratio = jmeas.get(1, 0.0) / torch.clamp(pj_model[:, 0], min=1e-30)
        pj = pj_model * jratio[:, None]
        meas = np.zeros(nph)
        have = np.zeros(nph, bool)
        for slot, val in jmeas.items():
            if 1 <= slot <= nph:
                meas[slot - 1] = val
                have[slot - 1] = True
        pj = torch.where(torch.as_tensor(have, device=pj.device),
                         torch.as_tensor(meas, dtype=pj.dtype,
                                         device=pj.device), pj)
        pj = torch.where(lights[:, None], pj, 0.0)
        return pj[:, :, None].expand(B, nph, n).clone()

    # ------------------------------------------------------------------
    def substep(self, state, dd: float):
        """One 10-s chemistry substep at the box level: the sea-salt
        source (box, mic=True, iaertyp=3, multiphase), surface exchange and
        particle deposition over the box depth, then the stiff solve (the
        multiphase driver's tot solve at the box level; the gas-phase
        driver solves the whole column, as the JAX package does)."""
        drv = self.model._chemistry
        if self.cfg.box:
            state = drv.sea_salt_source(state, dd, k_in=N_BL, d_z=self.z_box)
        state = self._sedc_box(state, dd)
        state = self._box_partdep(state, dd)
        chem = drv.integrate_box(state, dd, N_BL)
        return state.replace(chem=chem,
                             tim=state.tim.replace(time=state.tim.time + dd))

    def minute_step(self, state):
        """One outer minute: clock, 6 chemistry substeps, photolysis (the
        chamber's measured J; else the model's J-rates on even minutes when
        the sun is up, averaged over the boundary layer for bl_box)."""
        m = self.model
        cfg = self.cfg
        tim = state.tim
        lmin = tim.lmin + 1
        lst = tim.lst + lmin // 60
        lmin = lmin % 60
        lday = tim.lday + lst // 24
        lst = lst % 24
        state = state.replace(tim=tim.replace(lmin=lmin, lst=lst, lday=lday))

        for _ in range(6):
            state = self.substep(state, 10.0)

        u0 = solar_zenith(state.tim.lst, state.tim.lmin, m.astro.alat,
                          m.astro.declin, m.dtype)
        state = state.replace(rad=state.rad.replace(u0=u0))
        if cfg.chamber:
            pj = self._chamber_photolysis(state)
            return state.replace(chem=state.chem.replace(photol_j=pj))
        if m._photolysis is not None:
            due = (u0 > m._chemistry.u0min) & (state.tim.lmin % 2 == 0)
            state = m.photolysis_step(state, due)
            if cfg.bl_box:
                # average J over the boundary layer (ave_j)
                pj = state.chem.photol_j.clone()
                pj[:, :, N_BL] = pj[:, :, 1:self.nz_box + 1].mean(dim=2)
                state = state.replace(chem=state.chem.replace(photol_j=pj))
        return state
