# Frozen copy of mistra_tpu_torch/model.py (lines 1-376, commit b2518445), with the nucleation driver taken out.
"""Model assembly: the operator-splitting timestep schedule, in torch.

Counterpart of ``mistra_tpu.model``: every configuration the JAX ``Model``
runs.  The reference's two-level time loop (outer 1-minute steps, inner 6
x 10-s substeps; str.f90:324-535): ``substep`` applies the fast physics in
the reference's fixed order and ``minute_step`` wraps six substeps between
the once-per-minute clock, deposition, solar-geometry, radiation and
photolysis updates.  The box and chamber modes step through
``boxmodel.BoxModel``, which owns a ``Model``.

There is no jit: every step is eager Python over tensors of B columns on
the model's device.  Initialisation runs on the host (numpy and torch on
the CPU) for one column, the initial radiation call included; the state
then moves to the device and is repeated to B columns.

PIFM2 radiation (``radiation/``) is on by default, as in the JAX package:
``init_state`` installs the driver, which reads ``pifm2_171115.dat`` and
the Mie files from ``cfg.inpdir`` (and raises without them), and
``post_minute`` calls it after the solar zenith angle.  Set
``model.radiation_enabled = False`` before ``init_state`` to run without
it.

mic=True runs the particle physics (difp, kon, sedp, equil above nf);
mic=False holds the particles and keeps only the level nf-1 on the
Koehler curve.  isurf=0 is the water surface (surf0), isurf=1 the bare
soil (soil, then surf1).

With chem=True the model runs, as the JAX package does, the gas-phase
``chemistry.driver.ChemistryDriver`` (nkc_l=0, or mic=False) or the
multiphase ``chemistry.driver_aq.MultiphaseDriver`` (mic=True and
nkc_l>0: the tot mechanism below nf with the aqueous stack, the gas
mechanism above) on ``cfg.mechdir``'s mechanism and, with radiation on,
``photolysis.jrates.PhotolysisDriver`` on ``cfg.inpdir``'s ``photolys/``
tables: ``difc`` after ``difm``; with the multiphase driver ``konc``
after kon, the sea-salt source (iaertyp=3, not in chamber mode) after the
surface and ``sedl`` after ``sedc``; dry deposition, surface exchange,
the optional Eulerian source (neula=0) and the stiff Ros3 solve after the
surface, then (with the multiphase driver) the aerosol mass feedback and
(nuc=True) ``physics.nucleation.NucleationDriver``; the J-rates at init
and on even minutes when the sun is up.

A ``Model`` holds a ``parallel.bins.BinShard``: the dry-aerosol bins of
ff that this process steps (the whole axis by default).  With part of the
axis (one rank of the ensemble mesh's "tp" axis) every per-bin constant
is cut to those bins and every sum over the bins is completed by an
all_reduce over the tp ranks, in every configuration (``BoxModel``'s
too).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .config import MistraConfig
from .constants import PI
from .grids import AtmGrid, Grids, MicroGrid, make_grids
from .init import AstroConsts, initial_state, solar_constants
from .parallel.bins import BinShard
from .physics import diffusion, growth, microphysics, sedimentation, surface
from .physics.turbulence import atk0
from .state import ModelState, repeat_columns, torch_dtype
from .utils import resolve_device


def solar_zenith(lst, lmin, alat, declin, dtype=torch.float64):
    """Cosine of solar zenith angle with spherical-shell path correction
    (reference: radinit.f90:1180-1189); lst, lmin int32 [B]."""
    zeit = lst.to(dtype) * 3600.0 + lmin.to(dtype) * 60.0
    horang = 7.272205e-5 * zeit - PI
    rlat = alat * 1.745329e-2
    rdec = declin * 1.745329e-2
    u00 = math.cos(rdec) * math.cos(rlat) * torch.cos(horang) \
        + math.sin(rdec) * math.sin(rlat)
    ru0 = 6371.0 * u00
    return 8.0 / (torch.sqrt(ru0 ** 2 + 102000.0) - ru0)


def atm_tensors(atm: AtmGrid, dtype, device) -> AtmGrid:
    """The atmosphere grid with [n] tensors of dtype on device."""
    def t(x):
        return torch.as_tensor(x, dtype=dtype, device=device)
    return AtmGrid(eta=t(atm.eta), etw=t(atm.etw), detw=t(atm.detw),
                   deta=t(atm.deta))


# the arrays of MicroGrid indexed by the dry-aerosol bin, and that axis
_MICRO_PER_BIN = {"enw": 0, "en": 0, "rn": 0, "kw": 0, "rq": 1, "rw": 1}
# the per-bin arrays among the constants, and their dry-aerosol axis
_CONSTS_PER_BIN = {"b0m": 0, "qabs": 2}


def micro_tensors(mg: MicroGrid, dtype, device,
                  bins: BinShard | None = None) -> MicroGrid:
    """The microphysics grid with its arrays as tensors of dtype on device
    (kw as int64), the per-bin ones cut to ``bins`` (all by default);
    scalar increments and the chemistry split ``ka`` stay Python
    numbers (``ka`` a global bin index)."""
    def t(k):
        x = torch.as_tensor(getattr(mg, k), device=device,
                            dtype=torch.int64 if k == "kw" else dtype)
        return bins.take(x, _MICRO_PER_BIN[k]) \
            if bins is not None and k in _MICRO_PER_BIN else x
    arrays = ("enw", "en", "ew", "e", "dew", "rn", "rq", "rw", "re1", "re2",
              "re3", "rpw", "kw")
    return dataclasses.replace(mg, **{k: t(k) for k in arrays})


class Model:
    """Owns configuration, grids and tables; provides the step functions.

    Args:
      cfg: the run configuration, any that the JAX ``Model`` accepts.
      device: where the state and every step run: the card by default
        (raises on a host without one); "cpu" runs the plain versions.
      band: Bott walk band J (walks longer than J bins per substep are
        clamped; J >= nkt is exact).
      newton_iters: bound of subkon's Newton iteration.
      bins: the dry-aerosol bins this process steps (``BinShard``; the
        whole axis by default); a part of the axis needs the tp process
        group of ``parallel.mesh.make_mesh``.
    """

    def __init__(self, cfg: MistraConfig, device="cuda",
                 band: int = growth.BAND,
                 newton_iters: int = growth.NEWTON_ITERS,
                 bins: BinShard | None = None):
        self.cfg = cfg
        self.bins = BinShard(cfg.grid.nka) if bins is None else bins
        if self.bins.nka != cfg.grid.nka:
            raise ValueError(f"bins of an axis of {self.bins.nka}, the grid "
                             f"has nka={cfg.grid.nka}")
        self.device = resolve_device(device)
        self.dtype = torch_dtype(cfg)
        self.band = band
        self.newton_iters = newton_iters
        self.grids: Grids = make_grids(cfg)
        self.clarke = surface.load_clarke_table(cfg.inpdir)
        self.astro: AstroConsts = solar_constants(cfg)
        self.consts: dict = {}
        self.b0m = None
        self.radiation_enabled = True
        self._radiation = None  # installed by init_state
        self._chemistry = None
        self._photolysis = None
        self._nucleation = None
        self._const_tensors: dict = {}
        # grids and tables in the compute dtype, on the model's device
        self.atm = atm_tensors(self.grids.atm, self.dtype, self.device)
        self.micro = micro_tensors(self.grids.micro, self.dtype, self.device,
                                   self.bins)
        self.clarke_dev = self.clarke.to(self.dtype, self.device)

    def set_consts(self, consts: dict) -> None:
        """Install the per-configuration constants (a0m, b0m, nar, ...)."""
        self.consts.update(consts)
        self.b0m = self.const_tensor("b0m")

    def const_tensor(self, name: str) -> torch.Tensor:
        """``consts[name]`` as a tensor of the compute dtype on the model's
        device (a per-bin array cut to the model's bins), converted once
        per array installed under that name."""
        arr = self.consts[name]
        hit = self._const_tensors.get(name)
        if hit is None or hit[0] is not arr:
            x = torch.as_tensor(np.asarray(arr), dtype=self.dtype,
                                device=self.device)
            if name in _CONSTS_PER_BIN:
                x = self.bins.take(x, _CONSTS_PER_BIN[name])
            hit = (arr, x)
            self._const_tensors[name] = hit
        return hit[1]

    # ------------------------------------------------------------------
    def init_state(self, B: int = 1) -> ModelState:
        """Initial state of B identical columns on the model's device
        (init sequence of str.f90:72-321), ff and vd cut to the model's
        bins: the whole column is built, then shared out."""
        cfg = self.cfg
        cpu = torch.device("cpu")
        state, consts = initial_state(cfg, self.grids, self.clarke)
        self.set_consts(consts)
        if self.radiation_enabled and self._radiation is None:
            from .radiation.driver import RadiationDriver
            self._radiation = RadiationDriver(self)
        if cfg.chem and self._chemistry is None:
            if cfg.mic and cfg.nkc_l > 0:
                from .chemistry.driver_aq import MultiphaseDriver
                self._chemistry = MultiphaseDriver(self)
            else:
                from .chemistry.driver import ChemistryDriver
                self._chemistry = ChemistryDriver(self)
        if (cfg.chem and self._photolysis is None
                and self._radiation is not None):
            from .photolysis.jrates import PhotolysisDriver
            self._photolysis = PhotolysisDriver(self, self._radiation)
        if cfg.nuc:
            raise NotImplementedError("the reference copy holds no "
                                      "nucleation")
        atm = atm_tensors(self.grids.atm, self.dtype, cpu)
        turb = atk0(state.met, state.turb, state.surf, atm, cfg.ug, cfg.vg,
                    cfg.z0)
        state = state.replace(turb=turb)
        # aerosols onto the Koehler equilibrium curve
        met, micro = microphysics.equil(
            state.met, state.micro, self.grids.micro, consts["a0m"],
            consts["b0m"], ncase=0, nf=cfg.grid.nf)
        state = state.replace(met=met, micro=micro)
        u0 = solar_zenith(state.tim.lst, state.tim.lmin, self.astro.alat,
                          self.astro.declin, self.dtype)
        state = state.replace(rad=state.rad.replace(u0=u0))
        # initial chemistry concentrations
        if self._chemistry is not None:
            state = state.replace(chem=self._chemistry.init_chem_state(state))
        # initial radiation call, on the host column
        if self._radiation is not None:
            state = self._radiation(state, init=True)
        # initial photolysis rates, computed whatever the sun's height
        if self._photolysis is not None:
            state = self.photolysis_step(
                state, torch.ones_like(state.rad.u0, dtype=torch.bool))
        return repeat_columns(self.bins.take_state(state).to(self.device),
                              B)

    def photolysis_step(self, state: ModelState, due) -> ModelState:
        """state with photol_j recomputed in the columns where due [B] is
        true, held in the others, and zero where the sun is low (u0 <=
        u0min, str.f90:445-476).  The batch is computed when any column is
        due (one host check); the JAX package decides per column."""
        u0 = state.rad.u0
        pj = state.chem.photol_j
        if bool(due.any()):
            pj = torch.where(due[:, None, None], self._photolysis(state), pj)
        pj = torch.where((u0 > self._chemistry.u0min)[:, None, None], pj,
                         0.0)
        return state.replace(chem=state.chem.replace(photol_j=pj))

    # ------------------------------------------------------------------
    def substep(self, state: ModelState, dd: float) -> ModelState:
        """One 10-s fractional step (dynamics + microphysics + surface)."""
        cfg = self.cfg
        n = cfg.grid.n
        a0m = self.consts["a0m"]

        # turbulent exchange of momentum/heat/moisture/TKE (+ closure)
        met, turb, kinv = diffusion.difm(
            state.met, state.turb, state.surf, state.micro, self.atm, dd,
            cfg.ug, cfg.vg)
        state = state.replace(met=met, turb=turb,
                              tim=state.tim.replace(kinv=kinv))

        chemistry = self._chemistry
        # turbulent exchange of chemical species
        if chemistry is not None:
            field = chemistry.conc_name
            out = diffusion.difc(
                {"c": getattr(state.chem, field).transpose(1, 2)},
                state.met, state.turb, self.atm, dd)
            state = state.replace(chem=state.chem.replace(
                **{field: out["c"].transpose(1, 2)}))

        if cfg.mic:
            # particle diffusion, condensational growth, settling, then the
            # levels above nf back onto the Koehler curve
            micro = diffusion.difp(state.micro, state.met, state.turb,
                                   self.atm, dd, self.bins)
            state = state.replace(micro=micro)
            ff_before_kon = state.micro.ff
            state = growth.kon(self, state, dd)
            # shift aqueous species between chemistry bins along with the
            # particles that crossed the aerosol/droplet threshold (konc)
            if chemistry is not None:
                state = state.replace(chem=chemistry.konc(
                    state.chem, ff_before_kon, state.micro.ff))
            state = sedimentation.sedp(self, state, dd)
            met, micro = microphysics.equil(
                state.met, state.micro, self.micro, a0m, self.b0m, ncase=2,
                nf=cfg.grid.nf, bins=self.bins)
        else:
            # non-mic runs keep the boundary-layer top level in equilibrium
            met, micro = microphysics.equil(
                state.met, state.micro, self.micro, a0m, self.b0m, ncase=1,
                nf=cfg.grid.nf, level=cfg.grid.nf - 1, bins=self.bins)
        state = state.replace(met=met, micro=micro)

        # radiative heating of interior levels
        t = state.met.t
        t = torch.cat([t[:, :1], t[:, 1:n - 1]
                       + state.rad.dtrad[:, 1:n - 1] * dd, t[:, n - 1:]],
                      dim=1)
        state = state.replace(met=state.met.replace(t=t))

        # surface boundary condition: water surface or bare soil
        if cfg.isurf == 0:
            met, surf_state = surface.surf0(
                self.clarke_dev, state.met, state.surf, self.atm.eta, dd,
                rhsurf=cfg.rhsurf, ltwcst=cfg.ltwcst, ntwopt=cfg.ntwopt)
        else:
            state = state.replace(surf=surface.soil(
                state.surf, self.grids.soil, dd))
            met, surf_state = surface.surf1(
                self.clarke_dev, state.met, state.surf, state.rad, self.atm,
                self.grids.soil, dd)
        state = state.replace(met=met, surf=surf_state)

        # chemistry: surface exchange then stiff integration
        if chemistry is not None:
            # sea-salt aerosol + ion source (aer_source, kpp.f90:3810-4063)
            if not cfg.chamber:
                state = chemistry.sea_salt_source(state, dd)
            chem = state.chem.replace(vg=chemistry.gasdrydep(state))
            chem = chemistry.sedc(chem, dd, self.atm.deta[1],
                                  self.atm.detw[1])
            state = state.replace(chem=chem)
            # wet deposition of dissolved species (sedl)
            state = state.replace(chem=chemistry.sedl(state, dd))
            # eulerian advective source below the inversion (neula=0)
            if cfg.neula == 0:
                state = state.replace(chem=chemistry.eulerian_advection(
                    state.chem, state.tim.kinv, chemistry.am3, dd))
            conc_before = getattr(state.chem, chemistry.conc_name)
            state = state.replace(chem=chemistry.integrate_column(state, dd))
            # aerosol-mass feedback to the particle grid (stem_kpp,
            # str.f90:5975-6134)
            state = chemistry.aerosol_mass_feedback(state, conc_before)
            # nucleation after chemistry (str.f90:397-405)
            if self._nucleation is not None:
                state, _ = self._nucleation(state, dd)

        tim = state.tim.replace(time=state.tim.time + dd)
        return state.replace(tim=tim)

    # ------------------------------------------------------------------
    def pre_minute(self, state: ModelState) -> ModelState:
        """Clock advance + once-per-minute deposition velocities."""
        lmin = state.tim.lmin + 1
        lst = state.tim.lst + lmin // 60
        lmin = lmin % 60
        lday = state.tim.lday + lst // 24
        lst = lst % 24
        state = state.replace(tim=state.tim.replace(lmin=lmin, lst=lst,
                                                    lday=lday))

        # particle dry deposition velocities, once per minute (frozen in
        # chamber mode)
        if self.cfg.chamber:
            return state
        vd, xra = sedimentation.partdep(self, state)
        return state.replace(micro=state.micro.replace(vd=vd, xra=xra))

    def post_minute(self, state: ModelState) -> ModelState:
        """Solar geometry, radiative transfer and photolysis (per
        minute)."""
        u0 = solar_zenith(state.tim.lst, state.tim.lmin, self.astro.alat,
                          self.astro.declin, self.dtype)
        state = state.replace(rad=state.rad.replace(u0=u0))
        if self._radiation is not None:
            state = self._radiation(state, init=False)
        # photolysis rates: recompute on even minutes when the sun is up,
        # hold when sun up on odd minutes, zero when dark (str.f90:445-476)
        if self._photolysis is not None:
            due = (u0 > self._chemistry.u0min) & (state.tim.lmin % 2 == 0)
            state = self.photolysis_step(state, due)
        return state

    def minute_step(self, state: ModelState) -> ModelState:
        """One outer 1-minute step: clock, 6 substeps, radiation and
        photolysis."""
        state = self.pre_minute(state)
        for _ in range(6):
            state = self.substep(state, 10.0)
        return self.post_minute(state)
