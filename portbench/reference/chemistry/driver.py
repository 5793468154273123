# Frozen copy of mistra_tpu_torch/chemistry/driver.py (lines 1-493, commit b2518445).
"""Chemistry driver: species registry, initial profiles, dry deposition,
emission, and the per-substep integration over all layers, in torch.

Port of ``mistra_tpu/chemistry/driver.py`` (the gas-phase driver, which
the JAX model picks when mic=False or nkc_l == 0), batched over columns.
Parity map (gas-phase stage):
- species registry / index maps: ``mk_interface`` (utils.f90:20-166)
- initial concentration profiles: ``initc`` (kpp.f90:33-515)
- Henry-law table: ``henry_a`` (kpp.f90:1676-2151, gas-relevant subset)
- dry deposition velocities: ``gasdrydep`` (kpp.f90:5449-5899)
- surface exchange: ``sedc`` (str.f90:2417-2626)
- per-layer environment + mechanism dispatch: ``kpp_driver``
  (kpp.f90:4168-4481); the gas mechanism runs for every interior layer of
  every column as one batch of cells, flattened column-major
  (cell = column * (n - 2) + layer - 1).

The stiff solve is the port's ``GasKernel`` on the model's device: with a
binned mechanism (gas.eqn's het products) its block-arrow stage solver
sends every Ros3 step through the batched inverse (``csrc/lu.cu`` on a
card).
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import AVOGADRO, GAS_CONST, M_AIR, PI
from ..state import GasChemState
from .gas_kernel import GasKernel, load_species_csv
from .mech import load_gas_mechanism
from .rates import RateEnv

__all__ = ["HENRY_TABLE", "INFINITE_SOLUBILITY", "F0_BY_INDEX",
           "U0MIN_DEFAULT", "U0MIN_BUYS", "NPHRXN", "GasChemState",
           "henry_molar", "surface_exchange", "ChemistryDriver"]

NPHRXN = 47

# Henry's-law constants: species -> (A, B) for A*exp(B*(1/T - 1/298.15))
# [mol/(L atm)], or a plain number for T-independent values
# (transcribed from henry_a, kpp.f90:1723-1921)
HENRY_TABLE = {
    "H2SO4": 1.0e16, "CH4": 1.3e-3, "C2H6": 2.0e-3, "ETHE": 4.9e-3,
    "HI": 0.0, "I2O2": 0.0, "INO2": 0.0, "INO3": 0.0, "C3H7I": 1.1e-1,
    "NO": (1.9e-3, 1480.0), "NO2": (6.4e-3, 2500.0),
    "HNO3": (2.5e6 / 15.0, 8694.0), "HNO4": (1.2e4, 6900.0),
    "NH3": (58.0, 4085.0), "SO2": (1.2, 3120.0), "O3": (1.2e-2, 2560.0),
    "ACO2": (3.7e3, 5700.0), "ACTA": (4.1e3, 6300.0),
    "HCHO": (7.0e3, 6425.0), "ALD2": (13.0, 5700.0),
    "H2O2": (1.0e5, 6338.0), "ROOH": (3.0e2, 5322.0),
    "HONO": (49.0, 4780.0), "PAN": (2.8, 6500.0),
    "HCl": (2.0 / 1.7, 9001.0), "NO3": (2.0, 2000.0),
    "DMS": (4.8e-1, 3100.0), "DMSO": (5.0e4, 6425.0), "DMSO2": 1.0e16,
    "CH3SO2H": 1.0e16, "CH3SO3H": 1.0e16, "HOCl": (6.7e2, 5862.0),
    "Cl2": (9.1e-2, 2500.0), "HBr": (1.3, 10239.0), "Br2": (7.6e-1, 4094.0),
    "BrCl": (9.4e-1, 5600.0), "HOBr": (93.0, 5862.0), "I2": (3.0, 4431.0),
    "HOI": (4.5e2, 5862.0), "ICl": (1.1e2, 5600.0), "IBr": (24.0, 5600.0),
    "CH3I": (1.4e-1, 4300.0), "CH2I2": (2.3, 5000.0),
    "CH2ClI": (8.9e-1, 4300.0), "OH": (30.0, 4300.0),
    "HO2": (3.9e3, 5900.0), "MO2": (6.0, 5600.0), "IO": (4.5e2, 5862.0),
    "CO2": (3.1e-2, 2423.0), "CO": (9.9e-4, 1300.0), "O2": (1.3e-3, 1500.0),
    "ClONO": 4.6e-2, "CH3OH": (1.6e2, 5600.0), "C2H5OH": (1.5e2, 6400.0),
    "H2": (7.8e-4, 500.0), "XOR": (1.5e2, 6400.0),
}

# species treated as infinitely soluble in gasdrydep (hs = -1 sentinel)
INFINITE_SOLUBILITY = ("N2O5", "ClNO3", "BrNO3", "HI", "INO3")

# f0 reactivity values by MISTRA gas index (gasdrydep; default 0.1)
F0_BY_INDEX = {1: 0.0, 3: 0.0, 4: 0.0, 5: 0.0, 7: 1.0, 8: 0.0, 9: 0.0,
               10: 0.0, 11: 0.0, 14: 0.0, 15: 0.0, 16: 0.0, 17: 0.0,
               19: 1.0, 20: 1.0, 30: 0.0, 35: 0.0, 36: 1.0, 42: 0.0}

U0MIN_DEFAULT = 3.48e-2
U0MIN_BUYS = 1.75e-2

# initc: halogens are well mixed below the inversion and zero above it
_HALOGENS = {"HCl", "HBr", "HI", "Cl2", "Br2", "I2", "CH3I", "CH2I2",
             "CH2ClI", "C3H7I", "CH2BrI", "C2H5I", "DMS"}
# the sedc preamble's fixed deposition velocities (str.f90:2459-2500):
# (species, value or source species), applied in this order after the
# computed velocities
_FIXED_VG = (("NH3", 0.27e-2), ("N2O5", "HCl"), ("DMS", 0.0),
             ("HOCl", "HCl"), ("HOBr", "HCl"), ("I2O2", "HOI"),
             ("INO2", "HOI"), ("CH3I", 0.0), ("CH2I2", 0.0), ("CH2ClI", 0.0),
             ("C3H7I", 0.0), ("CH2BrI", 0.0), ("CHBr2I", 0.0),
             ("C2H5I", 0.0), ("CH3SO3H", "HCl"))


def henry_molar(name, t):
    """Henry constant [mol/(L atm)] at temperature t (a tensor)."""
    val = HENRY_TABLE.get(name)
    if val is None:
        return torch.zeros_like(t)
    if isinstance(val, tuple):
        a0, b0 = val
        return a0 * torch.exp(b0 * (1.0 / t - 3.3557e-3))
    return torch.full_like(t, val)


def _solubility_factor(name, t2):
    """Effective-solubility correction [B] of the Henry constant of acids
    and bases in gasdrydep (1 for the other species); t2 [B]."""
    sac = 10.0 ** (-8.1)

    def funa(a0, b0):
        return a0 * torch.exp(b0 * (1.0 / t2 - 3.354e-3))

    if name == "HNO3":
        return 1.0 + funa(1.54e1, 8700.0) / sac
    if name == "NH3":
        return 1.0 + funa(1.7e-5, -4325.0) * sac / funa(1.0e-14, -6710.0)
    if name == "SO2":
        return 1.0 + funa(1.7e-2, 2090.0) / sac \
            + funa(1.7e-2, 2090.0) * funa(6.0e-8, 1120.0) / sac ** 2
    if name == "H2SO4":
        return 1.0 + 1.0e3 / sac + 1.0e3 * funa(1.02e-2, 2720.0) / sac ** 2
    if name == "HCl":
        return 1.0 + funa(1.7e6, 6896.0) / sac
    if name == "HOCl":
        return torch.full_like(t2, 1.0 + 3.2e-8 / sac)
    if name == "HBr":
        return torch.full_like(t2, 1.0 + 1.0e9 / sac)
    if name == "HOBr":
        return 1.0 + funa(2.3e-9, -3091.0) / sac
    return torch.ones_like(t2)


def surface_exchange(conc, vg, es, dt, deta1, detw1):
    """sedc on concentrations conc [B, nvar, n]: dry deposition at the
    velocities vg [B, nvar] out of level 1 into the surface reservoir
    (level 0, column-integral units), then the emission es [nvar]
    [molec/cm2/s] into level 1.  Returns a new conc."""
    conc = conc.clone()
    dep_fac = torch.where(vg >= 1.0e-5, torch.exp(-dt / deta1 * vg), 1.0)
    s_old = conc[:, :, 1]
    s_new = s_old * dep_fac
    conc[:, :, 0] = conc[:, :, 0] + (s_old - s_new) * deta1
    # emissions [molec/cm2/s] -> mol/m3 per step
    conc[:, :, 1] = s_new + es * dt * 1.0e4 / (detw1 * AVOGADRO)
    return conc


class ChemistryDriver:
    """Gas-phase chemistry of a Model: reads ``gas.eqn`` (or
    ``master_gas.eqn``), ``cfg.cgaslistfile`` and, with neula=0,
    ``euler_in.dat`` from ``cfg.mechdir``, and builds its ``GasKernel``
    on the model's device in the model's dtype.

    The concentrations are the chemistry state's ``conc_name`` field,
    indexed by ``conc_n2i``; the couplers to the particles (``konc``,
    ``sea_salt_source``, ``sedl``, ``aerosol_mass_feedback``) leave the
    state as it is here and act in the multiphase driver."""

    conc_name = "sgas"

    def __init__(self, model):
        from . import aqueous as aq
        cfg = model.cfg
        self.model = model
        self.dtype = model.dtype
        self.device = model.device
        self.mech = load_gas_mechanism(cfg.mechdir, iod=cfg.iod,
                                       halo=cfg.halo)
        self.kernel = GasKernel(self.mech, dtype=self.dtype,
                                device=self.device)
        self.csv = load_species_csv(f"{cfg.mechdir.rstrip('/')}/"
                                    f"{cfg.cgaslistfile}")
        self.name2i = {s: i for i, s in enumerate(self.mech.species)}
        self.conc_n2i = self.name2i
        # static chemistry-bin membership of the 2-D spectrum, for the
        # het-on-dry-aerosol rates (dry_cw_rc, kpp.f90:4580-4642)
        self.masks = aq.bin_masks(model.grids.micro)
        # MISTRA index -> mechanism index maps for the CSV species
        self.csv_in_mech = [s for s in self.csv if s["name"] in self.name2i]
        self.u0min = U0MIN_BUYS if cfg.lp_buys13_0d else U0MIN_DEFAULT

        # eulerian advection source (neula=0; euler_in.dat,
        # kpp.f90:290-306, applied :4441-4448)
        self.advect = []
        if cfg.neula == 0:
            byidx = {s["index"]: s["name"] for s in self.csv}
            with open(f"{cfg.mechdir.rstrip('/')}/euler_in.dat") as f:
                lines = [l for l in f if l.strip()
                         and not l.lstrip().startswith("!")]
            nadv = int(lines[0].split()[0])
            for line in lines[1:1 + nadv]:
                toks = line.split()
                gidx = int(toks[0])
                if gidx == 0 or byidx.get(gidx) not in self.name2i:
                    continue
                xadv = float(toks[1].lower().replace("d", "e"))
                self.advect.append((byidx[gidx], xadv))

        self.am3 = None   # set by init_chem_state
        self.cm3 = None
        self.last_info = None   # the Ros3 info of the last integrate_column
        self._static()

    def _static(self):
        """Per-species constants of gasdrydep and sedc as tensors on the
        model's device (a later CSV entry of a name overrides an earlier
        one, as the JAX loops' later writes do)."""
        def t(x, dtype=None):
            return torch.as_tensor(np.asarray(x), dtype=dtype or self.dtype,
                                   device=self.device)

        spec = {s["name"]: s for s in self.csv_in_mech}
        names = list(spec)
        self._dep_names = names
        self._dep_idx = t([self.name2i[n] for n in names], torch.long)
        f0 = np.array([F0_BY_INDEX.get(spec[n]["index"], 0.1)
                       for n in names])
        henry = [HENRY_TABLE.get(n) for n in names]
        self._dep = dict(
            pi_mass=t([PI * spec[n]["mass"] for n in names]),
            infinite=t([n in INFINITE_SOLUBILITY for n in names],
                       torch.bool),
            is_tuple=t([isinstance(h, tuple) for h in henry], torch.bool),
            h_a0=t([h[0] if isinstance(h, tuple) else 0.0 for h in henry]),
            h_b0=t([h[1] if isinstance(h, tuple) else 0.0 for h in henry]),
            h_const=t([0.0 if h is None or isinstance(h, tuple) else h
                       for h in henry]),
            f0_pos=t(f0 > 0.0, torch.bool),
            f0_2000=t(f0 / 2000.0),
            insol=t(np.where(f0 > 0.0, 2000.0 / np.where(f0 > 0.0, f0, 1.0),
                             0.0)))
        es = np.zeros(self.mech.nvar)
        for n in names:
            es[self.name2i[n]] = spec[n]["emission"]
        # ground emissions [molec/cm2/s] of the concentration field's
        # species
        self.conc_es = t(es)
        # the model's dry bins of the whole axis' masks and radii
        bins = self.model.bins
        self._masks = bins.take(t(self.masks), 1)
        self._rq = bins.take(t(self.model.grids.micro.rq), 1)

    # ------------------------------------------------------------------
    def eulerian_advection(self, chem, kinv, am3, dt):
        """Large-scale advective source below the inversion
        (kpp_driver, kpp.f90:4441-4448): xadv in mol/mol/day; kinv [B]."""
        if not self.advect:
            return chem
        conc = getattr(chem, self.conc_name).clone()
        lev = torch.arange(conc.shape[-1], device=conc.device)
        below = (lev >= 1) & (lev <= kinv[:, None])                # [B, n]
        for name, xadv in self.advect:
            add = torch.where(below, xadv * dt * am3 / 86400.0, 0.0)
            i = self.conc_n2i[name]
            conc[:, i] = conc[:, i] + add.to(conc.dtype)
        return chem.replace(**{self.conc_name: conc})

    # ------------------------------------------------------------------
    def init_chem_state(self, state) -> GasChemState:
        """Initial exponential concentration profiles (initc) of the
        one-column state ``state`` (the host column of ``Model.init_state``);
        also sets the air-density conversions ``am3`` [mol/m3] and ``cm3``
        [molec/cm3] that the run keeps, on the model's device."""
        cfg = self.model.cfg
        n = cfg.grid.n
        eta = self.model.grids.atm.eta
        rho = state.met.rho[0].detach().cpu().numpy().astype(np.float64)
        am3 = rho / M_AIR
        xm = am3 * 1.0e-9                 # ppb -> mol/m3
        kinv = int(state.tim.kinv[0])

        x4 = np.minimum(1.0, eta / 1900.0)
        sgas = np.zeros((self.mech.nvar, n))
        for s in self.csv_in_mech:
            i = self.name2i[s["name"]]
            grd, top = s["ground_ppb"], s["top_ppb"]
            if grd > 0.0:
                x2 = -np.log(grd) + np.log(top + 1.0e-10)
            else:
                x2 = 0.0
            prof = grd * np.exp(x4 * x2) * xm
            if s["name"] in _HALOGENS and s["name"] != "HCl":
                # halogens: well-mixed below the inversion, zero above
                prof[:kinv] = prof[np.minimum(np.arange(n), 2)][:kinv]
                prof[kinv:] = 0.0
            sgas[i] = prof
        sgas[:, 0] = 0.0

        # air density conversions (constant during run, as initc does)
        self.am3 = torch.as_tensor(am3, dtype=self.dtype, device=self.device)
        self.cm3 = torch.as_tensor(rho * AVOGADRO / M_AIR * 1e-6,
                                   dtype=self.dtype, device=self.device)

        dev = state.met.t.device
        return GasChemState(
            sgas=torch.as_tensor(sgas, dtype=self.dtype, device=dev)[None],
            vg=torch.zeros((1, self.mech.nvar), dtype=self.dtype,
                           device=dev),
            photol_j=torch.zeros((1, NPHRXN, n), dtype=self.dtype,
                                 device=dev),
            nonconv=torch.zeros((1,), dtype=torch.int32, device=dev))

    # ------------------------------------------------------------------
    def gasdrydep(self, state) -> torch.Tensor:
        """Wesely-type dry deposition velocities vg [B, nvar] (m/s),
        computed for every CSV species at once."""
        met = state.met
        t2 = met.t[:, 1:2]                                       # [B, 1]
        rho2 = met.rho[:, 1:2]
        xra = state.micro.xra[:, None]
        ustern = state.surf.ustern[:, None]
        c = self._dep

        xeta = 1.8325e-5 * (416.16 / (t2 + 120.0)) * (t2 / 296.16) ** 1.5
        xnu = xeta / rho2
        freep = 2.28e-5 * t2 / met.p[:, 1:2]  # mean free path proxy
        rb_fact = 5.0 / ustern * (xnu * freep / 3.0) ** (2.0 / 3.0)
        fct = 0.0820577 * t2

        vm = torch.sqrt(8.0 * GAS_CONST * t2 / c["pi_mass"])     # [B, S]
        base = xra + rb_fact / vm ** (2.0 / 3.0)
        h = torch.where(c["is_tuple"],
                        c["h_a0"] * torch.exp(c["h_b0"] * (1.0 / t2
                                                           - 3.3557e-3)),
                        c["h_const"])
        h = h * torch.stack([_solubility_factor(n, t2[:, 0])
                             for n in self._dep_names], dim=1)
        hs_inv = 1.0 / (h * fct)   # dimensionless inverse Henry
        surf_term = hs_inv * 1.0e-5 + c["f0_2000"]
        v_sol = 1.0 / (base + 1.0 / torch.clamp(surf_term, min=1e-300))
        v_insol = torch.where(c["f0_pos"], 1.0 / (base + c["insol"]), 0.0)
        v = torch.where(h > 0.0, v_sol, v_insol)
        v = torch.where(c["infinite"], 1.0 / (base + 0.1), v)

        vg = torch.zeros((t2.shape[0], self.mech.nvar), dtype=t2.dtype,
                         device=t2.device)
        vg[:, self._dep_idx] = v
        # special fixed values (sedc preamble, str.f90:2459-2500)
        for name, val in _FIXED_VG:
            if name not in self.name2i:
                continue
            i = self.name2i[name]
            if isinstance(val, str):
                if val in self.name2i:
                    vg[:, i] = vg[:, self.name2i[val]]
            else:
                vg[:, i] = val
        return vg

    # ------------------------------------------------------------------
    def sedc(self, chem, dt, deta1, detw1):
        """Surface dry deposition + ground emission (str.f90:2520-2535)."""
        return chem.replace(**{self.conc_name: surface_exchange(
            getattr(chem, self.conc_name), chem.vg, self.conc_es, dt, deta1,
            detw1)})

    # the couplers to the particles: none without aqueous bins
    def konc(self, chem, ff_before, ff_after):
        return chem

    def sea_salt_source(self, state, dt, k_in=1, d_z=None):
        return state

    def sedl(self, state, dt):
        return state.chem

    def box_dissolved_deposition(self, state, dt, n_bl, z_box):
        return state

    def aerosol_mass_feedback(self, state, conc_before):
        return state

    # ------------------------------------------------------------------
    def _het_extras(self, state, lev, y0):
        """Heterogeneous-on-dry-aerosol rate namespace for the gas
        mechanism (dry_rates_g + fdhetg, kpp.f90:5042-5203, 8198-8265)
        for the cells of layers ``lev`` (a [nlev] index) of every column,
        flattened as ``y0`` [B * nlev, nvar] is.

        In gas-only layers no aqueous bin is active, so xhet1 = xhet2 = 1
        (kpp_driver, kpp.f90:4435-4438).
        """
        from . import aqueous as aq
        met = state.met
        t, p = met.t, met.p
        freep = 2.28e-5 * t / p
        dry = aq.dry_aerosol_rates(state.micro.ff, t, self._masks, self._rq,
                                   freep, self.model.bins)

        def cells(x):
            """[B, 2, n] -> [2, B * nlev]; [B, n] -> [B * nlev]."""
            x = x[..., lev]
            if x.dim() == 3:
                return x.transpose(0, 1).reshape(2, -1)
            return x.reshape(-1)

        xkmtd = {k: cells(v) for k, v in dry["xkmtd"].items()}
        cwd = cells(dry["cwd"])
        hdry_hno3 = cells(dry["henry_dry"]["HNO3"])
        xeq_hno3 = cells(dry["xeq_hno3"])
        n2i = self.name2i

        def fdhetg(na, nb):
            names = {1: "HNO3", 2: "N2O5", 3: "NH3", 4: "H2SO4"}
            if nb == 1 and y0 is not None and f"HNO3l{na}" in n2i:
                # HNO3 uptake limited by Henry equilibrium at pH 2
                x1 = xkmtd["HNO3"][na - 1] * cwd[na - 1]
                caq = (y0[:, n2i[f"HNO3l{na}"]] * 1.5e3) * 1.0e-2 \
                    / (xeq_hno3 + 1.0e-2)
                hno3 = y0[:, n2i["HNO3"]]
                x2 = torch.where((hno3 > 0.0) & (hdry_hno3 > 0.0),
                                 -xkmtd["HNO3"][na - 1]
                                 / torch.clamp(hno3 * hdry_hno3, min=1e-300)
                                 * caq, 0.0)
                return torch.clamp(x1 + x2, min=0.0)
            return xkmtd[names[nb]][na - 1] * cwd[na - 1]

        return {"fdhetg": fdhetg, "xhet1": 1.0, "xhet2": 1.0}

    def _gas_env(self, state, lev, y0=None):
        """Rate environment + fixed-species columns of the cells of layers
        ``lev`` of every column (kpp_driver per-layer scalars,
        kpp.f90:4315-4438), flattened column-major."""
        cfg = self.model.cfg
        met = state.met
        chem = state.chem
        B = met.t.shape[0]

        def cells(x):
            return x[..., lev].reshape(-1)

        te = cells(met.t)
        air_cc = self.cm3[lev].expand(B, -1).reshape(-1)
        air = self.am3[lev].expand(B, -1).reshape(-1)
        xm1, rho = cells(met.xm1), cells(met.rho)
        h2o = xm1 * rho / 1.8e-2                           # mol/m3
        h2o_cc = xm1 * (6.022e20 / 18.0) * rho
        h2oppm = h2o_cc * 1.0e6 / air_cc
        pk = cells(met.p)
        # layer-mean photolysis rates, zeroed when the sun is low
        u0 = state.rad.u0
        phj = 0.5 * (chem.photol_j[..., lev - 1] + chem.photol_j[..., lev])
        phj = torch.where((u0 >= self.u0min)[:, None, None], phj, 0.0)
        phj = phj.transpose(1, 2).reshape(-1, phj.shape[1])  # [C, nphrxn]
        extras = None
        if any(n.endswith(("l1", "l2")) for n in self.mech.species):
            extras = self._het_extras(state, lev, y0)
        env = RateEnv(te=te, aircc=air_cc, h2oppm=h2oppm, pk=pk,
                      ph_rat=phj,
                      xhal=1.0 if cfg.halo else 0.0,
                      xiod=1.0 if (cfg.halo and cfg.iod) else 0.0,
                      extras=extras)
        fix = torch.stack([0.21 * air, 0.79 * air, h2o], dim=-1)
        fix = fix[:, [["O2", "N2", "H2O"].index(s) for s in self.mech.fixed]]
        return env, fix

    def reaction_rates_at(self, state, levels):
        """Instantaneous per-reaction rates [B * len(levels), nrxn]
        [mol/(m3 s)] at ``levels`` of every column (budget diagnostics
        C33; bud_gas, bud_g.f:18-403)."""
        lev = torch.as_tensor(np.asarray(levels), device=state.met.t.device)
        y = torch.clamp(state.chem.sgas, min=0.0)[..., lev]
        y = y.transpose(1, 2).reshape(-1, self.mech.nvar)
        env, fix = self._gas_env(state, lev, y0=y)
        k = self.kernel.rate_constants(env, fix=fix)
        return self.kernel.reaction_rates(y, k, fix)

    def integrate_column(self, state, dt) -> GasChemState:
        """One chemistry substep over all interior layers of every column
        (kpp_driver): the B x (n - 2) cells in one Ros3 batch.  ``nonconv``
        adds each column's failed cells; ``last_info`` keeps the Ros3 info
        (per-cell ``nsteps``, ...)."""
        n = self.model.cfg.grid.n
        chem = state.chem
        sgas = torch.clamp(chem.sgas, min=0.0)
        B, nvar, _ = sgas.shape

        # active layers: 1 .. n-2 (reference k = 2 .. n-1)
        lev = torch.arange(1, n - 1, device=sgas.device)
        y0 = sgas[:, :, 1:n - 1].transpose(1, 2).reshape(-1, nvar)
        env, fix = self._gas_env(state, lev, y0=y0)

        k = self.kernel.rate_constants(env, fix=fix)
        y, info = self.kernel.integrate(y0, k, fix, dt)
        y = torch.clamp(y, min=0.0)
        sgas = torch.cat([sgas[:, :, :1],
                          y.reshape(B, n - 2, nvar).transpose(1, 2),
                          sgas[:, :, n - 1:]], dim=2)
        self.last_info = info
        failed = info["failed"].reshape(B, n - 2).sum(1, dtype=torch.int32)
        return chem.replace(sgas=sgas, nonconv=chem.nonconv + failed)

    def integrate_box(self, state, dt, n_bl=1) -> GasChemState:
        """Box/chamber mode: without aqueous bins the whole column is
        solved, as the JAX package does (n_bl is not used)."""
        return self.integrate_column(state, dt)
