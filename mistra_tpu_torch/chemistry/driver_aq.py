"""Multiphase chemistry driver: the tot mechanism with the aqueous support
stack (reference ``stem_kpp`` -> ``liq_parm`` -> ``kpp_driver`` chain,
str.f90:5797-6136 / kpp.f90:516-657, 4168-4481), in torch.

Port of ``mistra_tpu/chemistry/driver_aq.py``, batched over columns.
Mechanism routing: the tot mechanism runs for every layer below the
chemistry top (nf) with per-layer xliq/xhet switches masking inactive
aqueous bins, and the pure-gas kernel covers the layers above, where no
liquid can exist.  All B x (nf - 1) tot cells are one Ros3 batch on the
float64 tot ``GasKernel`` (``chem_f64``), whose block-arrow stage solver
sends every step through the batched inverse (``csrc/lu.cu`` on a card)
twice: the [cells * 4, ma, ma] aqueous blocks and the [cells, mg, mg] gas
core; the layers above are one batch of the gas kernel in the model's
dtype.  Cells are flattened column-major (cell = column * nlev + j).

The couplers to the microphysics:
- ``konc``: aqueous species follow the particles that crossed the
  aerosol/droplet threshold in kon (kpp.f90:3370-3590); the JAX
  ``lax.scan`` over dry bins is a fixed-count Python loop;
- ``sedl``: wet deposition of the aqueous species (str.f90:2627-2792)
  with the JAX package's fixed 8 Courant sub-iterations, one kernel
  launch on a card (``sedimentation.advsed1_splits``; the residual it
  drops is matched, a known defect; ROADMAP.md);
- ``aerosol_mass_feedback``: particles move along the dry-mass grid when
  chemistry changes their soluble mass (str.f90:5975-6134).  The JAX
  package's one-hot scatter matrix W stays: a batched matrix product is
  deterministic on the card, where an atomic scatter-add is not.

Like the JAX package, the float64 tot solve is cast back into the
model-dtype ``conc`` (a known defect, matched; ROADMAP.md).
"""

from __future__ import annotations

import re

import numpy as np
import torch

from ..constants import PI
from ..state import MultiphaseChemState
from ..utils.profiling import count, span
from . import aqueous as aq
from .activity import xgamma_field
from .driver import ChemistryDriver, henry_molar
from .gas_kernel import GasKernel
from .mech import load_multiphase_mechanism
from .rates import RateEnv
from .sources import aer_source, apply_initial_ions, ion_loading_table

# sion1 slots defining aerosol mass (lj2, str.f90:5884) with molar masses
# [g/mol]; HCO3- counts 44 (water stays when CO2 degasses); Na+ is inert
# here (no chemistry changes it between the two snapshots), so it drops out
# of the difference and is omitted.
MASS_IONS = (("Hp", 1.0), ("NH4p", 18.0), ("SO42m", 96.0),
             ("HCO3m", 44.0), ("NO3m", 62.0), ("Clm", 35.5),
             ("HSO4m", 97.0), ("CH3SO3m", 95.0))
# sedl's fixed Courant split: vterm tops out near 9 m/s and deta >= 10 m,
# so 8 sub-iterations cover dt = 10 s with a wide margin; iterations
# beyond the needed split are masked no-ops (the JAX package's bound)
SEDL_SPLITS = 8
# cuBLAS sums the dry bins of fewer than ~16k rows (columns x levels) in a
# split-K SGEMM, whose float32 rounding differs (~1e-7 of a sum) from the
# kernel it takes for whole columns; over a minute the box's tot solve
# carries that to 3e-5-8e-5 of a species' scale (H100, 1,024 boxes:
# 12,288 rows took the split-K kernel, 16,384 did not).  liq_parm repeats
# a short level set to this many rows, never to more cells than the
# columns hold, so that each level's sums round as the whole column's
GEMM_ROWS = 16384


def _eq_key(name: str) -> str:
    """Equilibrium-table key for a ykef/ykeb reference: bin-suffixed ion
    names keep their bin-1 table key (ind_HSO3ml1 etc.)."""
    if name in aq.EQUILIBRIA:
        return name
    base = re.sub(r"l[1-4]$", "l1", name)
    if base in aq.EQUILIBRIA:
        return base
    base2 = re.sub(r"l[1-4]$", "", name)
    if base2 in aq.EQUILIBRIA:
        return base2
    raise KeyError(f"no equilibrium table entry for {name}")


def _first_levels(lp, k):
    """liq_parm's dict with every tensor cut to its first k levels."""
    return {key: _first_levels(v, k) if isinstance(v, dict) else v[..., :k]
            for key, v in lp.items()}


def _pair_indices(n2i, b_src, b_dst):
    """Species index pairs (i_src, i_dst) [np, 2] matching bin b_src to
    b_dst by name."""
    pairs = []
    for name, i in n2i.items():
        if re.search(rf"l{b_src}$", name):
            other = re.sub(rf"l{b_src}$", f"l{b_dst}", name)
            if other in n2i:
                pairs.append((i, n2i[other]))
    return np.array(pairs, dtype=np.int64).reshape(-1, 2)


class MultiphaseDriver(ChemistryDriver):
    """Extends the gas driver with the aer/tot multiphase machinery: reads
    ``cfg.mechdir``'s ``master_gas.eqn``, ``tot_eqn12.head``,
    ``tot_eqn34.head`` and ``master_aqueous.eqn`` besides the gas
    driver's files, and builds the tot ``GasKernel`` on the model's
    device in float64 (``cfg.chem_f64``, else the model's dtype)."""

    conc_name = "conc"

    def __init__(self, model):
        super().__init__(model)
        cfg = model.cfg
        nkc = min(cfg.nkc_l, 4)
        self.nkc = nkc
        self.tot = load_multiphase_mechanism(
            cfg.mechdir, bins=tuple(range(1, nkc + 1)), name="tot")
        self.tot_dtype = torch.float64 if cfg.chem_f64 else self.dtype
        self.tot_kernel = GasKernel(self.tot, dtype=self.tot_dtype,
                                    device=self.device)
        self.tot_n2i = {s: i for i, s in enumerate(self.tot.species)}
        self.conc_n2i = self.tot_n2i
        # gas-mechanism species embedded in tot (same names)
        self.gas_in_tot = np.array(
            [self.tot_n2i[s] for s in self.mech.species], dtype=np.int64)
        self._gas_idx = torch.as_tensor(self.gas_in_tot, device=self.device)
        # exchange species present in tot
        self.exch = [s for s in aq.EXCHANGE_SPECIES if s in self.tot_n2i]
        self.exch_idx = {s: i for i, s in enumerate(self.exch)}
        self.masses = {s["name"]: s["mass"] for s in self.csv}
        self.sa1_table = ion_loading_table(
            cfg, model.grids, model.consts["fcs"], model.consts["xmol3"])
        es = np.zeros(self.tot.nvar)
        for s in self.csv_in_mech:
            es[self.tot_n2i[s["name"]]] = s["emission"]
        self.conc_es = torch.as_tensor(es, dtype=self.dtype,
                                       device=self.device)
        sb = np.asarray(self.tot.species_bin)
        self._bin_idx = {kc: np.nonzero(sb == kc)[0]
                         for kc in range(1, nkc + 1)}
        # konc's aerosol -> droplet pairs (bins 1 -> 3 and 2 -> 4)
        none = np.zeros((0, 2), np.int64)
        self.pairs13 = _pair_indices(self.tot_n2i, 1, 3) if nkc >= 3 \
            else none
        self.pairs24 = _pair_indices(self.tot_n2i, 2, 4) if nkc >= 4 \
            else none
        # the mass feedback's pairs between every two bins, and the ions
        # that define each bin's aerosol mass
        self._pairs = {(kc, kkc): _pair_indices(self.tot_n2i, kc, kkc)
                       for kc in range(1, nkc + 1)
                       for kkc in range(1, nkc + 1) if kc != kkc}
        self._mass_ions = {
            kc: [(self.tot_n2i[f"{nm}l{kc}"], mm) for nm, mm in MASS_IONS
                 if f"{nm}l{kc}" in self.tot_n2i]
            for kc in range(1, nkc + 1)}
        # the model's dry bins' water masses and dry masses; the mass
        # feedback's targets range over the whole axis: its dry masses and
        # chemistry-bin masks by global bin index
        mg = model.micro
        self._e = mg.e
        self._en = mg.en
        self._en_all = torch.as_tensor(model.grids.micro.en, dtype=self.dtype,
                                       device=self.device)
        self._masks_all = torch.as_tensor(self.masks, dtype=self.dtype,
                                          device=self.device)
        self.last_gas_info = None   # the Ros3 info of the layers above nf
        # cw_rc's thresholds of the hysteresis flags, per chemistry bin
        self._cloud_thresh, self._cloud_crys, self._cloud_deli = (
            torch.tensor(v, dtype=self.dtype, device=self.device)[:, None]
            for v in ([aq.CWM, aq.CWM, aq.CWMD, aq.CWMD],
                      [aq.XCRYSSULF, aq.XCRYSSS, 0.0, 0.0],
                      [aq.XDELISULF, aq.XDELISS, 0.0, 0.0]))

    # ------------------------------------------------------------------
    def init_chem_state(self, state) -> MultiphaseChemState:
        """initc for the gas species of the one-column host state, the
        initial aerosol ion loading (init_konc, kpp.f90:3591-3715) of bins
        1-2, and every bin's hysteresis flag set."""
        gas = super().init_chem_state(state)
        n = self.model.cfg.grid.n
        dev = state.met.t.device
        conc = torch.zeros((1, self.tot.nvar, n), dtype=self.dtype,
                           device=dev)
        gidx = torch.as_tensor(self.gas_in_tot, device=dev)
        conc[:, gidx] = gas.sgas
        conc = apply_initial_ions(conc, self.sa1_table, state.micro.ff,
                                  self.tot_n2i, self.model.grids.micro.ka,
                                  self.nkc)
        vg = torch.zeros((1, self.tot.nvar), dtype=self.dtype, device=dev)
        vg[:, gidx] = gas.vg
        return MultiphaseChemState(
            conc=conc, vg=vg, photol_j=gas.photol_j,
            cloud=torch.ones((1, 4, n), dtype=torch.bool, device=dev),
            nonconv=gas.nonconv)

    # ------------------------------------------------------------------
    def gasdrydep(self, state):
        vg_gas = super().gasdrydep(state)
        vg = vg_gas.new_zeros((vg_gas.shape[0], self.tot.nvar))
        vg[:, self._gas_idx] = vg_gas
        return vg

    def sea_salt_source(self, state, dt, k_in=1, d_z=None):
        """aer_source (kpp.f90:3810-4063) when iaertyp = 3."""
        if self.model.cfg.iaertyp != 3:
            return state
        return aer_source(self.model, state, dt, k_in=k_in, d_z=d_z)

    def box_dissolved_deposition(self, state, dt, n_bl, z_box):
        """Deposit the dissolved species of the box level n_bl with their
        bins' particle deposition velocities into the ground layer
        (box_partdep, str.f90:7070-7104)."""
        micro = state.micro
        ff = micro.ff[..., n_bl]
        cw = self._cw_rc(state)[0][:, :, n_bl]                # [B, nkc]
        rq3 = self._rq ** 3 * 1.0e-18
        xx1 = self.model.bins.sum_bins(torch.einsum(
            "btk,btk,tkc->bc", micro.vd * rq3 * 1.0e6, ff, self._masks))
        vdm = aq.per_lwc(xx1, cw)                             # [B, nkc]
        sb = np.asarray(self.tot.species_bin)
        kc_of = torch.as_tensor(np.maximum(sb, 1) - 1, device=vdm.device)
        is_aq = torch.as_tensor(sb > 0, device=vdm.device)
        depf = torch.where(is_aq, torch.exp(-dt / z_box * vdm[:, kc_of]),
                           1.0)
        s_old = state.chem.conc[:, :, n_bl]
        s_new = s_old * depf
        conc = state.chem.conc.clone()
        conc[:, :, n_bl] = s_new
        conc[:, :, 0] = conc[:, :, 0] + (s_old - s_new) * z_box
        return state.replace(chem=state.chem.replace(conc=conc))

    # ------------------------------------------------------------------
    def _cw_rc(self, state):
        return aq.cw_rc(state.micro.ff, state.met.feu, state.chem.cloud,
                        self._masks, self._rq, self._e, self.model.bins)

    def liq_parm(self, state, lev=None):
        """The aqueous support stack of B columns on the levels ``lev`` (a
        long tensor of level numbers; every level by default); returns a
        dict of tensors [B, ..., len(lev)].  No stage couples two levels,
        so each level's entries are those of the call over every level:
        every per-level input is taken on lev (repeated to ``GEMM_ROWS``
        rows) before any arithmetic.  Its sums over the dry bins take two
        all_reduce calls over the tp ranks: cw_rc's, then fast_k_mt's (the
        dry-aerosol rates take cw_rc's LWC and radius)."""
        cfg = self.model.cfg
        gp = cfg.grid
        met = state.met
        ff, t, p, feu = state.micro.ff, met.t, met.p, met.feu
        conc, cloud = state.chem.conc, state.chem.cloud
        if lev is None:
            levels = torch.arange(gp.n, device=t.device)
        else:
            k = lev.numel()
            levels = lev.repeat(max(1, min(-(-GEMM_ROWS // (t.shape[0] * k)),
                                           gp.n // k)))
            ff, t, p, feu, conc, cloud = (
                x[..., levels] for x in (ff, t, p, feu, conc, cloud))
        count("liq_parm.cells", t.shape[0] * levels.numel())
        freep = 2.28e-5 * t / p

        cw, cm, rc, conv2, cloud = aq.cw_rc(ff, feu, cloud, self._masks,
                                            self._rq, self._e,
                                            self.model.bins)
        # aqueous activity only below the chemistry top nf
        lev_ok = levels < gp.nf
        cm = torch.where(lev_ok, cm, 0.0)
        conv2 = torch.where(lev_ok, conv2, 0.0)

        alpha = aq.sticking_coefficients(self.exch, t, cfg.lp_buxmann15alph)
        vmean = aq.mean_speeds(self.exch, self.masses, t)
        xkmt, vt = aq.fast_k_mt(ff, t, p, alpha, vmean, cw, cm, self._masks,
                                self._rq, freep, self.model.bins)
        # Pitzer ion activity coefficients (SR activ, kpp.f90:5204-5404)
        # and the equilibrium rates, in the tot solve's dtype: the backward
        # rates (kb ~1e10 x conv2 ~1e10 x two activity coefficients)
        # overflow float32 where a bin's LWC is just above its threshold
        td = self.tot_dtype
        xgamma, _ = xgamma_field(
            t.to(td), torch.clamp(conc, min=0.0).to(td),
            cm.to(td), cw.to(td), self.tot_n2i, gp.nf, levels)
        kef, keb = aq.equil_constants(t.to(td), conv2.to(td), xgamma)
        dry = aq.dry_aerosol_rates(ff, t, self._masks, self._rq, freep,
                                   lwc=(cw, rc))
        lp = {"cw": cw, "cm": cm, "rc": rc, "conv2": conv2, "cloud": cloud,
              "xkmt": xkmt, "vt": vt, "kef": kef, "keb": keb, "dry": dry}
        return lp if lev is None else _first_levels(lp, lev.numel())

    def _cloud_flags(self, state):
        """cw_rc's hysteresis flags at every level [B, nkc, n] from one sum
        over the dry bins (the LWC), as cw_rc sets them: the same sum, the
        same thresholds, the same rule."""
        ff, feu = state.micro.ff, state.met.feu
        vol = 4.0 / 3.0 * PI * self._rq ** 3
        cw_raw = self.model.bins.sum_bins(aq.bin_sums(ff, vol, self._masks))
        f = feu[:, None, :]
        big = cw_raw >= self._cloud_thresh
        aero = torch.arange(4, device=ff.device)[:, None] < 2
        wet_ok = torch.where(
            aero, (state.chem.cloud & (f >= self._cloud_crys))
            | (f >= self._cloud_deli), True)
        both_dry = f < min(aq.XCRYSSULF, aq.XCRYSSS)
        return big & wet_ok & ~(both_dry & aero)

    # ------------------------------------------------------------------
    def _extras(self, lp, at, y0, te):
        """Rate-evaluation namespace extras for the cells of lp's levels
        ``at`` (positions on lp's level axis) of every column (flattened as
        y0 [cells, nvar] is; te [cells]).  y0 holds the initial
        concentrations (frozen during the step, matching Update_RCONST
        semantics)."""
        nkc = self.nkc

        def cells(x):
            """[B, k, n] -> [k, cells]; [B, n] -> [cells]."""
            x = x[..., at]
            if x.dim() == 3:
                return x.transpose(0, 1).reshape(x.shape[1], -1)
            return x.reshape(-1)

        conv2 = cells(lp["conv2"])             # [nkc, cells]
        cm = cells(lp["cm"])
        cw = cells(lp["cw"])
        xkmt = lp["xkmt"][..., at].permute(1, 2, 0, 3)
        xkmt = xkmt.reshape(xkmt.shape[0], xkmt.shape[1], -1)
        kef = {k: cells(v) for k, v in lp["kef"].items()}
        keb = {k: cells(v) for k, v in lp["keb"].items()}
        dry = lp["dry"]
        xkmtd = {k: cells(v) for k, v in dry["xkmtd"].items()}   # [2, C]
        hdry = {k: cells(v) for k, v in dry["henry_dry"].items()}
        cwd = cells(dry["cwd"])                # [2, cells]
        xeq_hno3 = cells(dry["xeq_hno3"])

        ns = {}
        xliq = []
        zero = torch.zeros_like(conv2[0])
        for b in range(1, 5):
            active = (cm[b - 1] > 0.0).to(conv2.dtype) if b <= nkc \
                else zero
            xliq.append(active)
            ns[f"xliq{b}"] = active
            ns[f"cvv{b}"] = conv2[b - 1] if b <= nkc else zero
        ns["xhet1"] = 1.0 - xliq[0]
        ns["xhet2"] = 1.0 - xliq[1]

        n2i = self.tot_n2i
        tot = self.tot
        for name, i in n2i.items():
            ns[f"ind_{name.lower()}"] = i
        for fi, name in enumerate(tot.fixed):
            ext = tot.nvar + 1 + fi
            ns[f"indf_{name.lower()}"] = ext
            # fixed species also carry an ind_ alias (KPP keeps FIX species
            # inside the NSPEC index space)
            ns.setdefault(f"ind_{name.lower()}", ext)

        ns["c"] = lambda i: y0[:, i]

        def key_name(ind):
            if ind < tot.nvar:
                return tot.species[ind]
            return tot.fixed[ind - tot.nvar - 1]

        def ykef(ind, b):
            return kef[_eq_key(key_name(ind))][b - 1]

        def ykeb(ind, b):
            return keb[_eq_key(key_name(ind))][b - 1]

        def yxkmt(ind, b):
            li = self.exch_idx.get(key_name(ind))
            if li is None:
                return zero
            return xkmt[li, b - 1]

        def ycw(b):
            return cw[b - 1]

        hinv_cache = {}

        def yhenry(ind):
            name = key_name(ind)
            if name not in hinv_cache:
                h = henry_molar(name, te)
                hinv_cache[name] = torch.where(
                    h > 0.0,
                    1.0 / (torch.clamp(h, min=1e-300) * (0.0820577 * te)),
                    0.0)
            return hinv_cache[name]

        ns.update(ykef=ykef, ykeb=ykeb, yxkmt=yxkmt, ycw=ycw, yhenry=yhenry)

        # het functions on dry aerosol (fdhetg/a/t, kpp.f90:8198-8349)
        def fdhet(na, nb):
            names = {1: "HNO3", 2: "N2O5", 3: "NH3", 4: "H2SO4"}
            if nb == 1:
                x1 = xkmtd["HNO3"][na - 1] * cwd[na - 1]
                caq = (y0[:, n2i[f"HNO3l{na}"]]
                       + y0[:, n2i.get(f"NO3ml{na}", n2i[f"HNO3l{na}"])]) \
                    * 1.0e-2 / (xeq_hno3 + 1.0e-2)
                hno3 = y0[:, n2i["HNO3"]]
                hh = hdry["HNO3"]
                x2 = torch.where((hno3 > 0.0) & (hh > 0.0),
                                 -xkmtd["HNO3"][na - 1]
                                 / torch.clamp(hno3 * hh, min=1e-300) * caq,
                                 0.0)
                return torch.clamp(x1 + x2, min=0.0)
            return xkmtd[names[nb]][na - 1] * cwd[na - 1]

        ns.update(fdhetg=fdhet, fdheta=fdhet, fdhett=fdhet)
        halo = self.model.cfg.halo

        def fhet_da(xliq_b, xhet_b, a0, b0, c0):
            if (c0 in (2, 3) or b0 in (2, 3)) and not halo:
                return zero
            cn = {1: "N2O5", 2: "ClNO3", 3: "BrNO3"}[c0]
            li = self.exch_idx.get(cn)
            xtr_l = xkmt[li, a0 - 1] if li is not None else 0.0
            # FIX(indf_H2Ol{a0}) = 55.55 / cvv (aer.f drive)
            h2oa_l = torch.where(conv2[a0 - 1] > 0.0,
                                 55.55 / torch.clamp(conv2[a0 - 1],
                                                     min=1e-300), 0.0)
            h2oa_d = 55.55 * cwd[a0 - 1] * 1.0e3
            clm = y0[:, n2i[f"Clml{a0}"]]
            brm = y0[:, n2i[f"Brml{a0}"]]
            xhal = 1.0 if halo else 0.0
            het_l = h2oa_l + xhal * (5.0e2 * clm + 3.0e5 * brm)
            het_d = h2oa_d + xhal * (5.0e2 * clm + 3.0e5 * brm)
            xbr_l = {1: h2oa_l, 2: 5.0e2, 3: 3.0e5}[b0]
            xbr_d = {1: h2oa_d, 2: 5.0e2, 3: 3.0e5}[b0]
            # liquid branch (xhet = 0)
            out_l = torch.where(het_l > 0.0,
                                xtr_l * cw[a0 - 1] * xbr_l
                                / torch.clamp(het_l, min=1e-300), 0.0)
            # dry branch (xhet = 1): only HNO3-family xkmtd tabulated; for
            # ClNO3/BrNO3 on dry aerosol reuse the N2O5 transfer rate
            out_d = torch.where(het_d > 0.0,
                                xkmtd["N2O5"][a0 - 1] * cwd[a0 - 1] * xbr_d
                                / torch.clamp(het_d, min=1e-300), 0.0)
            return xliq_b * out_l + xhet_b * out_d

        ns.update(fhet_da=fhet_da, fhet_dt=fhet_da)
        ns["fhet_t"] = lambda a0, b0, c0: fhet_da(xliq[a0 - 1], 0.0, a0, b0,
                                                  c0)
        return ns

    # ------------------------------------------------------------------
    def _cells(self, x, lev):
        """[B, n] -> [B * nlev] values of the layers lev."""
        return x[..., lev].reshape(-1)

    def _photol_cells(self, state, lev):
        """Layer-mean photolysis rates [cells, nphrxn], zeroed where the
        sun is low."""
        pj = state.chem.photol_j
        phj = 0.5 * (pj[..., lev - 1] + pj[..., lev])
        phj = torch.where((state.rad.u0 >= self.u0min)[:, None, None], phj,
                          0.0)
        return phj.transpose(1, 2).reshape(-1, phj.shape[1])

    def _tot_env(self, state, lp, lev, y0, at=None):
        """Rate constants + fixed-species columns for the tot mechanism at
        the cells of layers ``lev`` (kpp_driver per-layer scalars,
        kpp.f90:4315-4438).  ``at`` gives the positions of lev on lp's
        level axis: lev itself (the default) where lp is liq_parm's over
        every level, ``slice(None)`` where lp is ``liq_parm(state, lev)``
        (already sliced)."""
        at = lev if at is None else at
        cfg = self.model.cfg
        met = state.met
        B = met.t.shape[0]
        te = self._cells(met.t, lev)
        air_cc = self.cm3[lev].expand(B, -1).reshape(-1)
        air = self.am3[lev].expand(B, -1).reshape(-1)
        xm1, rho = self._cells(met.xm1, lev), self._cells(met.rho, lev)
        h2o = xm1 * rho / 1.8e-2
        h2o_cc = xm1 * (6.022e20 / 18.0) * rho
        h2oppm = h2o_cc * 1.0e6 / air_cc
        env = RateEnv(te=te, aircc=air_cc, h2oppm=h2oppm,
                      pk=self._cells(met.p, lev),
                      ph_rat=self._photol_cells(state, lev),
                      xhal=1.0 if cfg.halo else 0.0,
                      xiod=1.0 if (cfg.halo and cfg.iod) else 0.0,
                      extras=self._extras(lp, at, y0, te))

        # fixed species: O2/N2/H2O gas + aqueous water 55.55/cvv per bin
        conv2 = lp["conv2"][..., at]                       # [B, nkc, nlev]
        fix_cols = {"O2": 0.21 * air, "N2": 0.79 * air, "H2O": h2o}
        for b in range(1, self.nkc + 1):
            cv = conv2[:, b - 1].reshape(-1)
            fix_cols[f"H2Ol{b}"] = torch.where(
                cv > 0.0, 55.55 / torch.clamp(cv, min=1e-300), 0.0)
        zero = torch.zeros_like(air)
        fix = torch.stack([fix_cols.get(s, zero) for s in self.tot.fixed],
                          dim=-1)
        return self.tot_kernel.rate_constants(env, fix=fix), fix

    def _integrate_tot(self, state, conc, lp, lev, dt, at=None):
        """The tot solve of the cells of layers lev (a [nlev] index) of
        every column, lp indexed at ``at`` (``_tot_env``'s); returns
        (conc, failed cells per column [B])."""
        B, nvar, _ = conc.shape
        nlev = lev.shape[0]
        y0 = conc[..., lev].transpose(1, 2).reshape(-1, nvar) \
            .to(self.tot_dtype)
        k, fix = self._tot_env(state, lp, lev, y0, at)
        with span("ros3_tot"):
            y, info = self.tot_kernel.integrate(
                y0, k.to(self.tot_dtype), fix.to(self.tot_dtype), dt)
        self.last_info = info
        y = torch.clamp(y, min=0.0).to(conc.dtype)
        conc = conc.clone()
        conc[..., lev] = y.reshape(B, nlev, nvar).transpose(1, 2)
        return conc, info["failed"].reshape(B, nlev).sum(1,
                                                         dtype=torch.int32)

    def _integrate_gas_above(self, state, conc, lev, dt):
        """The gas mechanism on the layers lev above nf (no liquid there,
        and no het rates: the JAX package binds no aerosol environment)."""
        cfg = self.model.cfg
        met = state.met
        B = met.t.shape[0]
        air = self.am3[lev].expand(B, -1).reshape(-1)
        air_cc = self.cm3[lev].expand(B, -1).reshape(-1)
        xm1, rho = self._cells(met.xm1, lev), self._cells(met.rho, lev)
        env = RateEnv(
            te=self._cells(met.t, lev), aircc=air_cc,
            h2oppm=xm1 * (6.022e20 / 18.0) * rho * 1.0e6 / air_cc,
            pk=self._cells(met.p, lev),
            ph_rat=self._photol_cells(state, lev),
            xhal=1.0 if cfg.halo else 0.0,
            xiod=1.0 if (cfg.halo and cfg.iod) else 0.0)
        fix = torch.stack([0.21 * air, 0.79 * air, xm1 * rho / 1.8e-2],
                          dim=-1)
        count("sync.gas_above")         # the index list copied to the device
        fix = fix[:, [["O2", "N2", "H2O"].index(s) for s in self.mech.fixed]]
        k = self.kernel.rate_constants(env, fix=fix)
        gidx = self._gas_idx
        ng, nlev = gidx.shape[0], lev.shape[0]
        y0 = conc[:, gidx][..., lev].transpose(1, 2).reshape(-1, ng)
        with span("ros3_gas"):
            y, self.last_gas_info = self.kernel.integrate(y0, k, fix, dt)
        y = torch.clamp(y, min=0.0).reshape(B, nlev, ng).transpose(1, 2)
        conc = conc.clone()
        conc[:, gidx[:, None], lev[None, :]] = y
        return conc

    def integrate_column(self, state, dt) -> MultiphaseChemState:
        """One chemistry substep: the tot mechanism for layers 1..nf-1, the
        gas mechanism above.  ``nonconv`` adds each column's failed tot
        cells; ``last_info`` and ``last_gas_info`` keep the two Ros3
        infos."""
        gp = self.model.cfg.grid
        chem = state.chem
        dev = chem.conc.device
        conc = torch.clamp(chem.conc, min=0.0)
        with span("liq_parm"):
            lp = self.liq_parm(state)
        conc, nfail = self._integrate_tot(
            state, conc, lp, torch.arange(1, gp.nf, device=dev), dt)
        conc = self._integrate_gas_above(
            state, conc, torch.arange(gp.nf, gp.n - 1, device=dev), dt)
        return chem.replace(conc=conc, cloud=lp["cloud"],
                            nonconv=chem.nonconv + nfail)

    def integrate_box(self, state, dt, n_bl=1) -> MultiphaseChemState:
        """Box/chamber mode: the tot mechanism at the single level n_bl of
        every column (reference kpp_driver box branch,
        kpp.f90:4440-4470), with liq_parm on that level alone; the
        hysteresis flags of every level are cw_rc's (``_cloud_flags``)."""
        chem = state.chem
        conc = torch.clamp(chem.conc, min=0.0)
        lev = torch.tensor([n_bl], device=conc.device)
        with span("liq_parm"):
            lp = self.liq_parm(state, lev)
            cloud = self._cloud_flags(state)
        conc, nfail = self._integrate_tot(state, conc, lp, lev, dt,
                                          at=slice(None))
        return chem.replace(conc=conc, cloud=cloud,
                            nonconv=chem.nonconv + nfail)

    def reaction_rates_at(self, state, levels):
        """Instantaneous per-reaction tot-mechanism rates [B * len(levels),
        nrxn] [mol/(m3 s)] at ``levels`` of every column (budget
        diagnostics C33; bud_t.f / bud_s_t.f), liq_parm on those levels
        alone."""
        lev = torch.as_tensor(np.asarray(levels), device=state.met.t.device)
        conc = torch.clamp(state.chem.conc, min=0.0)
        lp = self.liq_parm(state, lev)
        y0 = conc[..., lev].transpose(1, 2).reshape(-1, self.tot.nvar)
        k, fix = self._tot_env(state, lp, lev, y0, at=slice(None))
        return self.tot_kernel.reaction_rates(y0, k, fix)

    # ------------------------------------------------------------------
    def konc(self, chem, ff_before, ff_after):
        """Shift aqueous species between aerosol and droplet bins in
        proportion to the particles that crossed the kw threshold;
        ff_before/ff_after [B, nkt, nka, n] around kon (the model's dry
        bins).

        The loop over the dry bins ia is sequential (each bin's transfer
        is clamped against what the bins before it left), so each rank
        runs it over the whole axis: the per-(ia, level) counts are
        gathered from the tp ranks (one all_reduce, exact) and every rank
        computes the same conc.  Each bin's old liquid volume is the sum
        of its dry bins' counts."""
        if self.pairs13.size == 0 and self.pairs24.size == 0:
            return chem
        mg = self.model.micro
        nkt = ff_before.shape[1]
        nka, ka = self.model.bins.nka, mg.ka
        vol = 4.0 / 3.0 * PI * mg.rq ** 3
        jt = torch.arange(nkt, device=vol.device)[:, None]
        aero_m = (jt < mg.kw[None, :]).to(vol.dtype)[None, :, :, None]
        vol = vol[None, :, :, None]

        # per-(ia, level) particle counts and volumes, aerosol vs droplet
        # [6, B, nka, n], the sums over the water bins of each dry bin
        counts = torch.stack([
            (ff_before * aero_m).sum(dim=1),
            (ff_before * (1.0 - aero_m)).sum(dim=1),
            (ff_before * (vol * aero_m)).sum(dim=1),
            (ff_before * (vol * (1.0 - aero_m))).sum(dim=1),
            (ff_after * aero_m).sum(dim=1),
            (ff_after * (1.0 - aero_m)).sum(dim=1)])
        pa_o, pd_o, va_o, vd_o, pa_n, pd_n = \
            self.model.bins.gather_bins(counts, 2)
        # the old liquid volume of each chemistry bin [B, n]
        vol2 = {1: va_o[:, :ka].sum(dim=1), 2: va_o[:, ka:].sum(dim=1),
                3: vd_o[:, :ka].sum(dim=1), 4: vd_o[:, ka:].sum(dim=1)}

        conc = chem.conc.clone()
        for pairs, ias, va2, vd2 in (
                (self.pairs13, range(0, ka), vol2[1], vol2[3]),
                (self.pairs24, range(ka, nka), vol2[2], vol2[4])):
            if pairs.size == 0:
                continue
            count("sync.konc", 2)       # the pairs copied to the device
            src = torch.as_tensor(pairs[:, 0], device=conc.device)
            dst = torch.as_tensor(pairs[:, 1], device=conc.device)
            A, D = conc[:, src], conc[:, dst]         # [B, np, n]
            for ia in ias:
                dp_a = pa_o[:, ia] - pa_n[:, ia]        # [B, n]
                dp_d = pd_o[:, ia] - pd_n[:, ia]
                to_drop = dp_a >= 1.0e-10               # aerosol lost some
                xs = (torch.abs(dp_a) >= 1.0e-10).to(A.dtype)
                delta_ad = torch.where(
                    (va2 > 0.0) & (pa_o[:, ia] > 0.0),
                    va_o[:, ia] / torch.clamp(va2, min=1e-300)
                    * dp_a / torch.clamp(pa_o[:, ia], min=1e-300) * xs, 0.0)
                delta_da = torch.where(
                    (vd2 > 0.0) & (pd_o[:, ia] > 0.0),
                    vd_o[:, ia] / torch.clamp(vd2, min=1e-300)
                    * dp_d / torch.clamp(pd_o[:, ia], min=1e-300) * xs, 0.0)
                delta = torch.where(to_drop, delta_ad, delta_da)
                delta = torch.where((delta > 0.0) & (delta <= 1.0), delta,
                                    0.0)[:, None]
                # transfer direction
                dA = torch.where(to_drop[:, None], A * delta, -D * delta)
                A = torch.clamp(A - dA, min=0.0)
                D = torch.clamp(D + dA, min=0.0)
            conc[:, src] = A
            conc[:, dst] = D
        return chem.replace(conc=conc)

    # ------------------------------------------------------------------
    def sedl(self, state, dt):
        """Wet deposition of aqueous species (str.f90:2627-2792): each bin's
        species settle at the bin's fall velocity through levels 1..nf-1
        into the surface reservoir (level 0, mol/m2), every bin's rows in
        one batch of the Bott advection."""
        from ..physics.sedimentation import advsed1_splits, vterm
        nf = self.model.cfg.grid.nf
        met = state.met
        chem = state.chem
        micro = state.micro
        deta, detw = self.model.atm.deta, self.model.atm.detw

        cw, _, rc, _, _ = self._cw_rc(state)
        # the bins' fall velocities, and vdm: the LWC-weighted particle
        # deposition velocity per bin (partdep); their sums over the dry
        # bins in one all_reduce
        rq3 = self._rq ** 3 * 1.0e-18
        vt, xx1 = self.model.bins.sum_bins(
            aq.fall_speed_sums(micro.ff, met.t, met.p, self._masks,
                               self._rq),
            torch.einsum("btk,tkc->bc",
                         micro.vd * rq3 * 1.0e6 * micro.ff[..., 1],
                         self._masks))
        vt = aq.per_lwc(vt, cw)
        vdm = aq.per_lwc(xx1, cw[..., 1])

        rows, ccs = [], []
        for kc in range(1, self.nkc + 1):
            idx = self._bin_idx[kc]
            if idx.size == 0:
                continue
            x4 = torch.clamp(1.0e6 * rc[:, kc - 1], min=0.01) * 1.0e-6
            cc = -vterm(x4, met.t, met.p) / deta            # [B, n]
            cc = torch.minimum(cc, -vt[:, kc - 1] / deta)
            cc1 = torch.minimum(cc[:, 1], -vdm[:, kc - 1] / deta[1])
            cc = torch.cat([cc[:, :1], cc1[:, None], cc[:, 2:]], dim=1)
            rows.append(idx)
            ccs.append(cc[:, None, :nf].expand(-1, idx.size, -1))
        if not rows:
            return chem
        count("sync.sedl")              # the rows copied to the device
        idx = torch.as_tensor(np.concatenate(rows), device=met.t.device)
        cc = torch.cat(ccs, dim=1)                  # [B, rows, nf]
        # time splitting bound from the bottom Courant number
        xxxt = -0.999 / cc[..., 1]                  # [B, rows]

        conc = chem.conc.clone()
        sk = conc[:, idx, 1:nf] * detw[1:nf]
        psi = torch.cat([sk[..., :1], sk], dim=-1)  # ghost level
        # Courant numbers per second on the advection's levels: level 1's
        # on the ghost level too, none at the top
        cc = torch.cat([cc[..., 1:2], cc[..., 1:nf - 1],
                        torch.zeros_like(cc[..., :1])], dim=-1)
        psi, ground = advsed1_splits(cc, psi, xxxt, torch.full_like(xxxt, dt),
                                     SEDL_SPLITS)
        conc[:, idx, 1:nf - 1] = psi[..., 1:nf - 1] / detw[1:nf - 1]
        # level 0 is the surface reservoir in column-integral units
        # [mol/m2] (sedc's convention): psi = conc*detw is mol/m2
        conc[:, idx, 0] = conc[:, idx, 0] + ground
        return chem.replace(conc=conc)

    # ------------------------------------------------------------------
    def aerosol_mass_feedback(self, state, conc_before):
        """Shift particles to new dry-mass bins after chemistry changed
        their soluble mass; carry dissolved species across chemistry-bin
        boundaries with the displaced volume (str.f90:5975-6134).

        Each dry bin maps independently to its two bracketing target bins:
        one weight matrix W [B, source ia, target ia, n] per chemistry bin
        and a batched product, mass-conserving by construction.  The
        sources are the model's dry bins and the targets the whole axis:
        a rank's particles can land in another rank's bins, so each rank
        forms its sources' contribution to the whole axis and
        ``BinShard.reduce_home`` brings every target's share home (one
        all_reduce per chemistry bin, which must see the previous bin's
        moves).
        """
        gp = self.model.cfg.grid
        mg = self.model.micro
        bins = self.model.bins
        chem, micro = state.chem, state.micro
        nf, n = gp.nf, gp.n
        en, masks = self._en, self._masks
        en_all = self._en_all
        nka = bins.nka
        dev, dtype = en.device, en.dtype
        lev = torch.arange(n, device=dev)
        lev_ok = (lev >= 1) & (lev < nf)

        cw, cm, _, _, _ = self._cw_rc(state)
        ff = micro.ff
        conc = chem.conc
        B = ff.shape[0]
        vc = torch.zeros((B, 4, 4, n), dtype=dtype, device=dev)  # [to, from]
        # chemistry-bin id (0..3) of each (jt, target-ia) cell
        dest_bin = torch.nn.functional.one_hot(
            torch.argmax(self._masks_all, dim=2), 4).to(dtype)   # [t, d, 4]
        vol_q = 4.0 / 3.0 * PI * mg.rq ** 3
        dests = torch.arange(nka, device=dev)[None, None, :, None]
        # the global index of each of the model's dry bins
        home = bins.lo + torch.arange(bins.width, device=dev)

        for kc in range(1, self.nkc + 1):
            ion_idx = self._mass_ions[kc]
            if not ion_idx:
                continue
            mkc = masks[:, :, kc - 1]                  # [nkt, nka]
            # per-level totals over this bin
            sap, smp = bins.sum_bins(
                torch.einsum("tk,btkn->bn", mkc, ff),
                torch.einsum("tk,btkn->bn", mkc * en, ff))
            dion = torch.zeros_like(sap)
            for i, mm in ion_idx:
                dion = dion + (conc[:, i] - conc_before[:, i]) * mm
            # den: new aerosol mass per particle [mg]
            den = torch.where(sap > 1.0e-6,
                              dion * 1.0e-6 / torch.clamp(sap, min=1e-30)
                              * 1000.0, 0.0)
            active = ((sap > 1.0e-6) & (cm[:, kc - 1] > 0.0)
                      & lev_ok)[:, None, :]            # [B, 1, n]

            # target dry mass for every source bin: x0 [B, nka, n], and
            # the target bins on the whole axis
            x0 = en[None, :, None] + den[:, None, :] * en[None, :, None] \
                / torch.clamp(smp[:, None, :], min=1e-30) * sap[:, None, :]
            ix = torch.clamp(torch.searchsorted(en_all, x0, right=True) - 1,
                             0, nka - 2)
            enl = en_all[ix]
            enr = en_all[torch.clamp(ix + 1, max=nka - 1)]
            c0 = (enr - x0) / torch.clamp(enr - enl, min=1e-300)
            c0 = torch.clamp(c0, 0.0, 1.0)
            c0 = torch.where(x0 < en_all[0], 1.0, c0)
            c0 = torch.where(x0 >= en_all[-1], 0.0, c0)
            # no move where inactive
            ix = torch.where(active, ix, home[None, :, None])
            c0 = torch.where(active, c0, 1.0)

            # weight matrix W [B, source ia, dest ia, n]
            w = (dests == ix[:, :, None, :]).to(dtype) * c0[:, :, None, :] \
                + (dests == torch.clamp(ix + 1, max=nka - 1)[:, :, None, :]
                   ).to(dtype) * (1.0 - c0[:, :, None, :])
            moved = ff * mkc[None, :, :, None]         # [B, nkt, nka, n]
            ff = ff - moved + bins.reduce_home(
                torch.einsum("btan,badn->btdn", moved, w), 2)

            # volume landing in a different chemistry bin (this rank's
            # sources: their sum over the ranks below)
            landed = torch.einsum("btan,badn->btdn",
                                  moved * vol_q[None, :, :, None], w)
            vmoved = torch.einsum("btdn,tdc->bcn", landed, dest_bin)
            for b in range(4):
                if b + 1 != kc:
                    vc[:, b, kc - 1] = vc[:, b, kc - 1] + vmoved[:, b]
            del w, moved, landed

        vc, fsum = bins.sum_bins(vc, torch.sum(ff, dim=(1, 2)))
        micro = micro.replace(ff=ff, fsum=fsum)

        # move dissolved species with the displaced volume
        conc = conc.clone()
        for kc in range(1, self.nkc + 1):
            if self._bin_idx[kc].size == 0:
                continue
            for kkc in range(1, self.nkc + 1):
                if kkc == kc or self._pairs[kc, kkc].size == 0:
                    continue
                count("sync.feedback")  # the pairs copied to the device
                prs = torch.as_tensor(self._pairs[kc, kkc], device=dev)
                vol_ch = vc[:, kkc - 1, kc - 1] * 1.0e-12
                cw_kc = cw[:, kc - 1]
                xfact = torch.where(cw_kc > 0.0,
                                    vol_ch / torch.clamp(cw_kc, min=1e-300),
                                    0.0)
                xfact = torch.clamp(xfact, 0.0, 1.0)[:, None, :]
                xch = conc[:, prs[:, 0]] * xfact
                conc[:, prs[:, 0]] = conc[:, prs[:, 0]] - xch
                conc[:, prs[:, 1]] = conc[:, prs[:, 1]] + xch
        return state.replace(micro=micro, chem=chem.replace(conc=conc))
