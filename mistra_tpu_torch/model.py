"""Model assembly: the operator-splitting timestep schedule, in torch.

Counterpart of ``mistra_tpu.model`` for the BTZ96 column step (mic=T,
chem=F, water surface).  The reference's two-level time loop (outer
1-minute steps, inner 6 x 10-s substeps; str.f90:324-535): ``substep``
applies the fast physics in the reference's fixed order and
``minute_step`` wraps six substeps between the once-per-minute clock,
deposition and solar-geometry updates.

There is no jit: every step is eager Python over tensors of B columns on
the model's device.  Initialisation runs on the host (numpy and torch on
the CPU) for one column, the initial radiation call included; the state
then moves to the device and is repeated to B columns.

PIFM2 radiation (``radiation/``) is on by default, as in the JAX package:
``init_state`` installs the driver, which reads ``pifm2_171115.dat`` and
the Mie files from ``cfg.inpdir`` (and raises without them), and
``post_minute`` calls it after the solar zenith angle.  Set
``model.radiation_enabled = False`` before ``init_state`` to run without
it.  Configurations outside the slice (chem=T, mic=F, isurf=1, box and
chamber modes) raise.
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


def micro_tensors(mg: MicroGrid, dtype, device) -> MicroGrid:
    """The microphysics grid with its arrays as tensors of dtype on device
    (kw as int64); scalar increments stay Python numbers."""
    def t(x):
        return torch.as_tensor(x, dtype=dtype, device=device)
    arrays = ("enw", "en", "ew", "e", "dew", "rn", "rq", "rw", "re1", "re2",
              "re3", "rpw")
    return dataclasses.replace(
        mg, kw=torch.as_tensor(mg.kw, dtype=torch.int64, device=device),
        **{k: t(getattr(mg, k)) for k in arrays})


class Model:
    """Owns configuration, grids and tables; provides the step functions.

    Args:
      cfg: the run configuration (mic=True, chem=False, isurf=0, neither
        box nor chamber mode).
      device: where the state and every step run: the card by default
        (raises on a host without one); "cpu" runs the plain versions.
      band: Bott walk band J (walks longer than J bins per substep are
        clamped; J >= nkt is exact).
      newton_iters: bound of subkon's Newton iteration.
    """

    def __init__(self, cfg: MistraConfig, device="cuda",
                 band: int = growth.BAND,
                 newton_iters: int = growth.NEWTON_ITERS):
        unported = {"chem=True": cfg.chem, "mic=False": not cfg.mic,
                     "isurf=1": cfg.isurf != 0, "box": cfg.box,
                     "chamber": cfg.chamber}
        for name, on in unported.items():
            if on:
                raise NotImplementedError(f"{name} is not ported yet")
        self.cfg = cfg
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
        self._const_tensors: dict = {}
        # grids and tables in the compute dtype, on the model's device
        self.atm = atm_tensors(self.grids.atm, self.dtype, self.device)
        self.micro = micro_tensors(self.grids.micro, self.dtype, self.device)
        self.clarke_dev = self.clarke.to(self.dtype, self.device)

    def set_consts(self, consts: dict) -> None:
        """Install the per-configuration constants (a0m, b0m, nar, ...)."""
        self.consts.update(consts)
        self.b0m = torch.as_tensor(np.asarray(consts["b0m"]),
                                   dtype=self.dtype, device=self.device)

    def const_tensor(self, name: str) -> torch.Tensor:
        """``consts[name]`` as a tensor of the compute dtype on the model's
        device, converted once per array installed under that name."""
        arr = self.consts[name]
        hit = self._const_tensors.get(name)
        if hit is None or hit[0] is not arr:
            hit = (arr, torch.as_tensor(np.asarray(arr), dtype=self.dtype,
                                        device=self.device))
            self._const_tensors[name] = hit
        return hit[1]

    # ------------------------------------------------------------------
    def init_state(self, B: int = 1) -> ModelState:
        """Initial state of B identical columns on the model's device
        (init sequence of str.f90:72-321, chemistry off)."""
        cfg = self.cfg
        cpu = torch.device("cpu")
        state, consts = initial_state(cfg, self.grids, self.clarke)
        self.set_consts(consts)
        if self.radiation_enabled and self._radiation is None:
            from .radiation.driver import RadiationDriver
            self._radiation = RadiationDriver(self)
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
        # initial radiation call, on the host column
        if self._radiation is not None:
            state = self._radiation(state, init=True)
        return repeat_columns(state.to(self.device), B)

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

        # particle diffusion, condensational growth, settling, then the
        # levels above nf back onto the Koehler curve
        micro = diffusion.difp(state.micro, state.met, state.turb, self.atm,
                               dd)
        state = state.replace(micro=micro)
        state = growth.kon(self, state, dd)
        state = sedimentation.sedp(self, state, dd)
        met, micro = microphysics.equil(
            state.met, state.micro, self.micro, a0m, self.b0m, ncase=2,
            nf=cfg.grid.nf)
        state = state.replace(met=met, micro=micro)

        # radiative heating of interior levels
        t = state.met.t
        t = torch.cat([t[:, :1], t[:, 1:n - 1]
                       + state.rad.dtrad[:, 1:n - 1] * dd, t[:, n - 1:]],
                      dim=1)
        state = state.replace(met=state.met.replace(t=t))

        # surface boundary condition (water surface)
        met, surf_state = surface.surf0(
            self.clarke_dev, state.met, state.surf, self.atm.eta, dd,
            rhsurf=cfg.rhsurf, ltwcst=cfg.ltwcst, ntwopt=cfg.ntwopt)
        state = state.replace(met=met, surf=surf_state)

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

        # particle dry deposition velocities, once per minute
        vd, xra = sedimentation.partdep(self, state)
        return state.replace(micro=state.micro.replace(vd=vd, xra=xra))

    def post_minute(self, state: ModelState) -> ModelState:
        """Solar geometry and radiative transfer (per minute; photolysis
        is not ported yet)."""
        u0 = solar_zenith(state.tim.lst, state.tim.lmin, self.astro.alat,
                          self.astro.declin, self.dtype)
        state = state.replace(rad=state.rad.replace(u0=u0))
        if self._radiation is not None:
            state = self._radiation(state, init=False)
        return state

    def minute_step(self, state: ModelState) -> ModelState:
        """One outer 1-minute step: clock, 6 substeps, radiation."""
        state = self.pre_minute(state)
        for _ in range(6):
            state = self.substep(state, 10.0)
        return self.post_minute(state)
