# Frozen copy of mistra_tpu_torch/grids.py (lines 1-266, commit b2518445).
"""Model grids: atmosphere, soil, and the 2-D microphysics mass grids.

TPU-first design note: all grids are *static host-side data* computed once in
float64 numpy at model construction, then closed over by jitted step
functions as device constants.  Nothing here traces.

Semantics follow the reference grid generator (``subroutine grid``,
the reference's src/str.f90:1476-1908): an equidistant 10-m grid up to
``nf`` layers topped by a log-stretched region; a log soil grid; and
log-equidistant mass grids over (dry aerosol mass) x (water mass) with the
derived total-particle radius tables.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .config import GridParams, MistraConfig
from .constants import PI, RHO3, RHOW

ETAW1_MAX = 2500.0  # max allowed prognostic-grid top [m]


@dataclass(frozen=True)
class AtmGrid:
    """Vertical atmospheric grid (all [m], length n arrays).

    eta  : layer mid heights       (eta[0] = 0, surface "layer")
    etw  : layer top boundaries    (etw[0] = 0)
    detw : layer thicknesses (detw[0] = detamin for diffusion continuity)
    deta : mid-to-mid spacings
    """
    eta: np.ndarray
    etw: np.ndarray
    detw: np.ndarray
    deta: np.ndarray

    @property
    def n(self) -> int:
        return self.eta.shape[0]


@dataclass(frozen=True)
class SoilGrid:
    """Log-stretched soil grid (depth [m], length nb arrays)."""
    zb: np.ndarray     # layer mid depths, zb[0] = 0
    dzb: np.ndarray    # mid-to-mid spacings
    dzbw: np.ndarray   # layer thicknesses


@dataclass(frozen=True)
class MicroGrid:
    """2-D spectral microphysics mass grids.

    Axis convention (Python): arrays indexed [jt, ia] = (water bin, dry bin),
    matching the reference's ``(nkt, nka)`` layout.

    enw/en : dry-aerosol mass bin bounds / centers [mg]
    ew/e   : water mass bin bounds / centers [mg]
    dew    : water mass bin widths [mg]
    rn     : dry aerosol radius at bin center [um]
    rq     : total particle radius at (e, rn) [um]
    rw     : total particle radius at (ew, rn) [um]
    re1/2/3: equivalent pure-water radius (and powers) [m]
    dlgenw, dlgew, dlne : log-grid increments
    ka     : number of "small" dry bins (rn <= 0.5 um, chemistry bin split)
    kw     : per dry bin, number of water bins below the droplet threshold
    rpw    : 1-D output radius grid [um] (projection grid, variant 7)
    """
    enw: np.ndarray
    en: np.ndarray
    ew: np.ndarray
    e: np.ndarray
    dew: np.ndarray
    rn: np.ndarray
    rq: np.ndarray
    rw: np.ndarray
    re1: np.ndarray
    re2: np.ndarray
    re3: np.ndarray
    dlgenw: float
    dlgew: float
    dlne: float
    ka: int
    kw: np.ndarray
    rpw: np.ndarray


@dataclass(frozen=True)
class Grids:
    atm: AtmGrid
    soil: SoilGrid
    micro: MicroGrid
    params: GridParams


# --------------------------------------------------------------------------


def make_atm_grid(gp: GridParams, detamin: float, etaw1: float) -> AtmGrid:
    """Equidistant grid to eta(nf), log-equidistant above, top at ~etaw1."""
    n, nf = gp.n, gp.nf
    if etaw1 < (nf - 1) * detamin + (n - nf) * detamin:
        raise ValueError(
            "impossible to build n-nf stretched layers: decrease detamin, "
            "increase etaw1, or change layer counts")
    etaw1 = min(etaw1, ETAW1_MAX)

    etw = np.zeros(n)
    etw[:nf] = np.arange(nf) * detamin

    # stretched region: find the smallest base x0 (multiple of detamin) such
    # that the geometric progression with ratio 1 + detamin/x0 starting at x0
    # spans no more than etaw1 - etw[nf-1]
    x0 = detamin
    span = etaw1
    x3 = 2.0
    guard = 0
    while span > etaw1 - etw[nf - 1]:
        x0 += detamin
        x3 = detamin / x0 + 1.0
        top = x0 * x3 ** (n - nf - 1)
        span = top - x0
        guard += 1
        if guard > 10000:
            raise RuntimeError("atmospheric grid generation did not converge")
    etw[nf:] = x0 * x3 ** np.arange(n - nf)
    # shift so the first stretched boundary continues the equidistant grid
    etw[nf:] += nf * detamin - etw[nf]

    detw = np.empty(n)
    eta = np.empty(n)
    deta = np.empty(n)
    detw[0] = detamin  # required for diffusion boundary continuity
    eta[0] = 0.0
    detw[1:] = etw[1:] - etw[:-1]
    eta[1:] = 0.5 * (etw[1:] + etw[:-1])
    deta[:-1] = eta[1:] - eta[:-1]
    deta[-1] = (1.0 + x3) * 0.5 * etw[-1] - eta[-1]
    return AtmGrid(eta=eta, etw=etw, detw=detw, deta=deta)


def make_soil_grid(gp: GridParams, dzbw0: float = 0.001,
                   zbw1: float = 1.0) -> SoilGrid:
    """Log soil grid: thinnest layer >= dzbw0 m, total depth ~zbw1 m."""
    nb = gp.nb
    zbw0, x2 = 0.0, 0.0
    x3 = 1.0
    zbw = 0.0
    while x2 < dzbw0:
        zbw0 += 0.0001
        x3 = 10.0 ** (np.log10(zbw1 / zbw0) / nb)
        zbw = zbw0 * x3
        x2 = zbw - zbw0

    zb = np.empty(nb)
    dzb = np.empty(nb)
    dzbw = np.empty(nb)
    zb[0] = zbw
    dzbw[0] = zbw - zbw0
    for k in range(1, nb):
        zbw0 = zbw
        zbw = zbw0 * x3
        zb[k] = 0.5 * (zbw + zbw0)
        dzbw[k] = zbw - zbw0
        dzb[k - 1] = zb[k] - zb[k - 1]
    dzb[nb - 1] = (1.0 + x3) * 0.5 * zbw - zb[nb - 1]
    zb = zb - zb[0]
    return SoilGrid(zb=zb, dzb=dzb, dzbw=dzbw)


def make_micro_grid(gp: GridParams, rnw0: float, rnw1: float,
                    rw0: float, rw1: float, chamber: bool = False) -> MicroGrid:
    """Log-equidistant 2-D (dry aerosol mass) x (water mass) grids."""
    nka, nkt = gp.nka, gp.nkt
    third = 1.0 / 3.0
    x1 = 4.0 * third * PI * RHOW   # water mass factor
    x2 = 4.0 * third * PI * RHO3   # dry aerosol mass factor

    # dry aerosol mass grid [mg]: masses of spheres with radii rnw0..rnw1 um
    enwmin = x2 * rnw0 ** 3 * 1.0e-12
    enwmax = x2 * rnw1 ** 3 * 1.0e-12
    dlgenw = np.log10(enwmax / enwmin) / nka
    fac_n = 10.0 ** dlgenw
    enw = enwmin * fac_n ** np.arange(1, nka + 1)
    enw_lo = np.concatenate([[enwmin], enw[:-1]])
    en = 0.5 * (enw + enw_lo)
    rn = (en / x2) ** third * 1.0e4  # [um]

    # water mass grid [mg]
    ewmin = x1 * rw0 ** 3 * 1.0e-12
    ewmax = x1 * rw1 ** 3 * 1.0e-12
    dlgew = np.log10(ewmax / ewmin) / nkt
    fac_t = 10.0 ** dlgew
    dlne = np.log(10.0) * dlgew
    ew = ewmin * fac_t ** np.arange(1, nkt + 1)
    ew_lo = np.concatenate([[ewmin], ew[:-1]])
    e = 0.5 * (ew + ew_lo)
    dew = ew - ew_lo

    # equivalent pure-water radius [m] of the water mass centers
    re1 = (e * 1.0e-6 / x1) ** third
    re2 = re1 * re1
    re3 = re2 * re1

    # total particle radius [um], [jt, ia]
    rq = ((e[:, None] * 1.0e-6 / x1 + (rn[None, :] * 1.0e-6) ** 3) ** third
          * 1.0e6)
    rw_arr = ((ew[:, None] * 1.0e-6 / x1 + (rn[None, :] * 1.0e-6) ** 3) ** third
              * 1.0e6)

    # chemistry bin split: small/large dry aerosol boundary ka
    zradthres = 0.1 if chamber else 0.5
    above = np.nonzero(rn > zradthres)[0]
    ka = int(above[0]) if above.size else nka  # bins [0:ka] are "small"

    # per dry bin: water bins below the aerosol/droplet threshold
    # (water-equivalent radius <= xfac * rn, volume ratio 1000)
    xfac = 10.0
    wet_r = (e * 1.0e-6 / x1) ** third * 1.0e6  # [um]
    kw = np.empty(nka, dtype=np.int64)
    for ia in range(nka):
        over = np.nonzero(wet_r > xfac * rn[ia])[0]
        kw[ia] = int(over[0]) if over.size else nkt

    rpw = _make_rpw(rw_arr, nka)

    return MicroGrid(enw=enw, en=en, ew=ew, e=e, dew=dew, rn=rn, rq=rq,
                     rw=rw_arr, re1=re1, re2=re2, re3=re3,
                     dlgenw=float(dlgenw), dlgew=float(dlgew),
                     dlne=float(dlne), ka=ka, kw=kw, rpw=rpw)


def _make_rpw(rw: np.ndarray, nka: int) -> np.ndarray:
    """1-D output radius grid, diagonal-subsampling variant (str.f90:1825+)."""
    diag = np.diagonal(rw)  # rw[i, i]
    rpw = np.empty(nka)
    rpw[0] = rw[0, 0] ** 2 / rw[2, 2]
    ij = 1            # next slot to fill (0-based)
    iij = 2 * ij - 2  # every second diagonal element: 0, 2, 4, ...
    while iij < nka and diag[iij] <= rw[0, nka - 1]:
        rpw[ij] = diag[iij]
        ij += 1
        iij = 2 * ij - 2
    iij += 1          # continue densely from the next diagonal element
    ia = 0
    while iij + ia < nka and ij + ia < nka:
        rpw[ij + ia] = diag[iij + ia]
        ia += 1
    while ij + ia < nka:
        rpw[ij + ia] = rpw[ij + ia - 1] * 1.001
        ia += 1
    return rpw


def make_grids(cfg: MistraConfig) -> Grids:
    gp = cfg.grid
    return Grids(
        atm=make_atm_grid(gp, cfg.detamin, cfg.etaw1),
        soil=make_soil_grid(gp),
        micro=make_micro_grid(gp, cfg.rnw0, cfg.rnw1, cfg.rw0, cfg.rw1,
                              chamber=cfg.chamber),
        params=gp,
    )
