# Frozen copy of mistra_tpu_torch/config.py (lines 1-274, commit b2518445).
"""Typed configuration for MISTRA-TPU.

One dataclass covers the three configuration tiers of the reference model
(environment variables, the ``&mistra_cfg`` Fortran namelist with ~60
parameters, and the compile-time grid constants of
``src/global_params.f90``); see SURVEY.md section 5.6.  Unlike the
reference, grid sizes are runtime configuration here, and the chemical
mechanism is data (see mistra_tpu.chemistry.mech) rather than generated
code.

A parser for the reference's Fortran namelist files is included so the six
canonical experiment configurations under ``namelists/`` run unchanged.
"""

from __future__ import annotations

import dataclasses
import os
import re
from dataclasses import dataclass, field
from typing import Optional


# --------------------------------------------------------------------------
# Grid-size constants (reference: src/global_params.f90:44-118).
# Runtime-configurable here; defaults reproduce the reference setup.
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class GridParams:
    nf: int = 100          # constant-dz prognostic layers
    n_extra: int = 50      # log-stretched layers above nf
    nka: int = 70          # dry-aerosol mass bins
    nkt: int = 70          # water mass bins
    nkc: int = 4           # aqueous chemistry bins
    nb: int = 20           # soil layers
    mbs: int = 6           # solar spectral bands
    mbir: int = 12         # IR spectral bands
    nrlev_extra: int = 11  # standard-atmosphere extension layers for radiation
    nphrxn: int = 47       # photolysis reactions
    nlev_bud: int = 15     # levels for reaction-budget output

    @property
    def n(self) -> int:
        return self.nf + self.n_extra

    @property
    def nm(self) -> int:
        return self.n - 1

    @property
    def mb(self) -> int:
        return self.mbs + self.mbir

    @property
    def nrlay(self) -> int:
        # radiation layers = (n-1) + standard atmosphere extension to 50 km
        return self.n - 1 + self.nrlev_extra

    @property
    def nrlev(self) -> int:
        return self.nrlay + 1


@dataclass
class MistraConfig:
    """Full run configuration (parity with &mistra_cfg, config.f90:157-186)."""

    # --- run control -------------------------------------------------------
    rst: bool = False
    lstmax: int = 1                  # integration time [hours]
    netcdf: bool = False
    binout: bool = False
    jp_out_part2d_opt: int = 0

    # --- timing and geography ---------------------------------------------
    nday: int = 1
    nmonth: int = 7
    nyear: int = 2021
    nhour: int = 0
    alon: float = 0.0                # longitude [deg]
    alat: float = 0.0                # latitude [deg]

    # --- model grids -------------------------------------------------------
    detamin: float = 10.0            # constant layer height [m]
    etaw1: float = 2000.0            # top of prognostic grid [m]
    rnw0: float = 0.005              # min dry aerosol radius [um]
    rnw1: float = 15.0               # max dry aerosol radius [um]
    rw0: float = 0.005               # min particle radius [um]
    rw1: float = 150.0               # max particle radius [um]

    # --- meteorological initialisation ------------------------------------
    rp0: float = 101325.0            # surface pressure [Pa]
    xm1w: float = 8.5e-3             # specific humidity below inversion [kg/kg]
    xm1i: float = 4.0e-3             # specific humidity above inversion [kg/kg]
    rh_max_bl: float = 1.0
    rh_max_ft: float = 1.0
    zinv: float = 700.0              # initial inversion height [m]
    dtinv: float = 6.0               # inversion temperature jump [K]
    ug: float = 6.0                  # geostrophic wind x [m/s]
    vg: float = 6.0                  # geostrophic wind y [m/s]
    nuv_prof_opt: int = 0            # geostrophic wind profile option (0 or 3)
    nw_prof_opt: int = 2             # subsidence profile option (1, 2, 3)
    wmin: float = 0.0                # subsidence min [m/s]
    wmax: float = -0.006             # subsidence max [m/s]

    # --- surface -----------------------------------------------------------
    isurf: int = 0                   # 0 = water/snow surface, 1 = bare soil
    tw: float = 293.0                # water surface temperature [K]
    ltwcst: bool = True
    ntwopt: int = 1
    rhsurf: float = 1.0              # forced surface relative humidity
    z0: float = 0.01                 # roughness length [m]
    jp_albedo_opt: int = 0

    # --- microphysics ------------------------------------------------------
    mic: bool = False
    jp_part_dist_set: int = 0        # aerosol size distribution set (0..4)
    iaertyp: int = 3                 # 1=urban 2=rural 3=ocean 4=background

    # --- chemistry ---------------------------------------------------------
    chem: bool = True
    halo: bool = True
    iod: bool = True
    nkc_l: int = 4
    # integrate the multiphase (tot) stiff system in float64 even when
    # the rest of the model runs float32: the aqueous equilibrium /
    # diffusion-limited rates give the stage matrix a stiffness ratio
    # ~1e10 that exceeds float32's conditioning budget (the reference
    # is REAL*8 throughout); gas-only chemistry stays in the model dtype
    chem_f64: bool = True
    cgaslistfile: str = "gas_species.csv"
    cradlistfile: str = "gas_radical_species.csv"
    lpmona: bool = True              # Monahan-86 sea salt source
    lpsmith: bool = False            # Smith-93 sea salt source
    neula: int = 1                   # 0 = eulerian advection of chem species

    # --- box / chamber modes ----------------------------------------------
    box: bool = False
    bl_box: bool = False
    nlevbox: int = 2
    z_box: float = 700.0
    chamber: bool = False

    # --- nucleation --------------------------------------------------------
    nuc: bool = False
    ifeed: int = 0
    napari: bool = True
    lovejoy: bool = True

    # --- photolysis --------------------------------------------------------
    scaleo3_m: float = 300.0         # total ozone column [DU]

    # --- special-case switch bundles --------------------------------------
    lp_buxmann15alph: bool = False
    lp_buys13_0d: bool = False
    lp_joyce14bc: bool = False

    # --- paths (env-var tier of the reference) ----------------------------
    inpdir: str = ""                 # input data tables (Mie, pifm2, photolysis...)
    outdir: str = ""
    mechdir: str = ""

    # --- TPU-native additions ---------------------------------------------
    grid: GridParams = field(default_factory=GridParams)
    dtype: str = "float64"           # compute dtype: "float64" | "float32"
    n_columns: int = 1               # ensemble width (batched independent columns)

    # ----------------------------------------------------------------------
    def __post_init__(self) -> None:
        if not self.inpdir:
            self.inpdir = os.environ.get("INPDIR", "input/")
        if not self.outdir:
            self.outdir = os.environ.get("OUTDIR", "./output/")
        if not self.mechdir:
            self.mechdir = os.environ.get("MECHDIR", "src/mech/")
        self.validate()

    def validate(self) -> None:
        """Configuration consistency checks (reference: config.f90:363-402)."""
        if self.box and self.chamber:
            raise ValueError("box and chamber modes are mutually exclusive")
        if self.iaertyp not in (1, 2, 3, 4):
            raise ValueError(f"iaertyp must be in 1..4, got {self.iaertyp}")
        if self.jp_part_dist_set in (2, 3) and self.iaertyp != 3:
            raise ValueError(
                "jpPartDistSet=2/3 (maritime/polar) requires iaertyp=3")
        if self.nw_prof_opt not in (1, 2, 3):
            raise ValueError("nwProfOpt must be 1, 2 or 3")
        if self.nuv_prof_opt not in (0, 3):
            raise ValueError("nuvProfOpt must be 0 or 3")
        if self.isurf not in (0, 1):
            raise ValueError("isurf must be 0 or 1")
        if not self.halo:
            # iodine requires halogens (reference behavior: auto-off)
            self.iod = False
        if self.dtype not in ("float64", "float32"):
            raise ValueError("dtype must be float64 or float32")


# --------------------------------------------------------------------------
# Fortran namelist parsing (compatibility with the reference's run configs)
# --------------------------------------------------------------------------

# Map namelist keys (lowercase) -> MistraConfig field names where they differ.
_NAMELIST_KEYMAP = {
    "rhmaxbl": "rh_max_bl",
    "rhmaxft": "rh_max_ft",
    "nuvprofopt": "nuv_prof_opt",
    "nwprofopt": "nw_prof_opt",
    "jpoutpart2dopt": "jp_out_part2d_opt",
    "jpalbedoopt": "jp_albedo_opt",
    "jppartdistset": "jp_part_dist_set",
    "lpbuxmann15alph": "lp_buxmann15alph",
    "lpbuys13_0d": "lp_buys13_0d",
    "lpjoyce14bc": "lp_joyce14bc",
    "bl_box": "bl_box",
    "napari": "napari",
    "lovejoy": "lovejoy",
}

_TRUE_RE = re.compile(r"^\.?t(rue)?\.?$", re.IGNORECASE)
_FALSE_RE = re.compile(r"^\.?f(alse)?\.?$", re.IGNORECASE)


def _parse_value(raw: str):
    raw = raw.strip()
    if _TRUE_RE.match(raw):
        return True
    if _FALSE_RE.match(raw):
        return False
    if raw.startswith(("'", '"')) and raw.endswith(("'", '"')):
        return raw[1:-1]
    try:
        if re.fullmatch(r"[+-]?\d+", raw):
            return int(raw)
        return float(raw.replace("d", "e").replace("D", "E"))
    except ValueError:
        return raw


def parse_namelist(path: str, group: str = "mistra_cfg") -> dict:
    """Parse a Fortran namelist file into a {key: value} dict."""
    with open(path) as f:
        text = f.read()
    m = re.search(rf"&{group}\b(.*?)^\s*/\s*$", text,
                  re.DOTALL | re.MULTILINE | re.IGNORECASE)
    if m is None:
        raise ValueError(f"namelist group &{group} not found in {path}")
    body = m.group(1)
    out = {}
    for line in body.splitlines():
        line = line.split("!")[0].strip()
        if not line:
            continue
        for stmt in re.split(r",(?=\s*\w+\s*=)", line):
            if "=" not in stmt:
                continue
            key, val = stmt.split("=", 1)
            out[key.strip().lower()] = _parse_value(val.strip().rstrip(","))
    return out


def config_from_namelist(path: str, **overrides) -> MistraConfig:
    """Build a MistraConfig from a reference-format namelist file."""
    raw = parse_namelist(path)
    fields = {f.name for f in dataclasses.fields(MistraConfig)}
    kwargs = {}
    for key, val in raw.items():
        name = _NAMELIST_KEYMAP.get(key, key)
        if name in fields:
            kwargs[name] = val
        # unknown keys are tolerated (the reference ignores extra keys too)
    kwargs.update(overrides)
    return MistraConfig(**kwargs)
