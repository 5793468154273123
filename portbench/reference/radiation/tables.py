# Frozen copy of mistra_tpu_torch/radiation/tables.py (lines 1-345, commit b2518445).
"""Loaders for the radiative-transfer input tables.

Parses the reference model's data files (PIFM2 correlated-k coefficient
file and the Mie optics tables for urban/rural/ocean aerosol; see
``ipdata``/``intrad``, radinit.f90:126-695).  Everything here is host-side
numpy executed once at model construction; the parsed tables become device
constants.  A copy of ``mistra_tpu.radiation.tables`` (framework-free), plus
``write_synthetic_radiation_tables`` for runs without the reference files.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass

import numpy as np

MB = 18    # spectral bands
MBS = 6    # solar bands
MBIR = 12  # IR bands
NCW = 8    # droplet optics classes

# number of cumulative probabilities (k-quadrature points) per band
KG = np.array([10, 8, 12, 7, 12, 5, 2, 3, 4, 4, 3, 5, 2, 10, 12, 7, 7, 8])

# Mie table coordinate grids (radinit.f90:263-272)
XA0 = np.array([0.0, 0.2, 0.4, 0.6, 0.7, 0.8, 0.85, 0.9, 0.95, 0.975, 1.0])
XW0 = np.array([0.01, 0.0125, 0.015, 0.02, 0.025, 0.03, 0.04, 0.05, 0.06,
                0.08, 0.1, 0.125, 0.15, 0.2, 0.25, 0.3, 0.4, 0.5, 0.6, 0.8,
                1.0, 1.25, 1.5, 2.0, 2.5, 3.0, 4.0, 5.0, 6.0, 8.0,
                10.0, 12.5, 15.0, 20.0, 25.0, 30.0, 40.0, 50.0, 60.0, 80.0])

PIFM2_FILE = "pifm2_171115.dat"
# solar (kw) and IR (lw) Mie tables of the urban, rural and ocean types
MIE_FILES = ("urbankw.dat", "urbanlw.dat", "ruralkw.dat", "rurallw.dat",
             "ozeankw.dat", "ozeanlw.dat")


@dataclass(frozen=True)
class Pifm2Tables:
    """Contents of pifm2_171115.dat (Fortran column-major fill order)."""
    ttab: np.ndarray      # [35]
    pibtab: np.ndarray    # [35, mbir]
    ret: np.ndarray       # [ncw] tabulated effective radii
    r2wt: np.ndarray      # [ncw]
    b2wt: np.ndarray      # [ncw, mb]
    w2wt: np.ndarray      # [ncw, mb]
    g2wt: np.ndarray      # [ncw, mb]
    feux: np.ndarray      # [8] reference relative humidities
    seanew: np.ndarray    # [8, mb, 4] aerosol extinction
    saanew: np.ndarray    # [8, mb, 4] aerosol absorption
    ganew: np.ndarray     # [8, mb, 4] aerosol asymmetry
    s0b: np.ndarray       # [mbs] solar energy per band
    hk: dict              # band (1-based) -> [kg] quadrature weights
    cgas: dict            # named coefficient tables per band
    o3un: np.ndarray      # [52] unreduced ozone amounts (Craig table)
    berayl: np.ndarray    # [mbs] Rayleigh coefficients

    @property
    def s0tot(self) -> float:
        return float(self.s0b.sum())


class _Reader:
    """Sequential reader mimicking Fortran list reads of '(8e16.8)' blocks
    separated by one comment line each."""

    def __init__(self, path: str):
        with open(path) as f:
            self.lines = f.read().splitlines()
        self.pos = 0

    def block(self, shape) -> np.ndarray:
        count = int(np.prod(shape))
        self.pos += 1  # skip the comment/separator line
        vals = []
        while len(vals) < count:
            line = self.lines[self.pos]
            self.pos += 1
            # fixed-width e16.8 fields
            for i in range(0, len(line.rstrip()), 16):
                vals.append(float(line[i:i + 16]))
        arr = np.array(vals[:count])
        # Fortran column-major fill
        return arr.reshape(tuple(reversed(shape))).T if len(shape) > 1 \
            else arr


def load_pifm2(inpdir: str, fname: str = PIFM2_FILE) -> Pifm2Tables:
    r = _Reader(os.path.join(inpdir, fname))
    ttab = r.block((35,))
    pibtab = r.block((35, MBIR))
    ret = r.block((NCW,))
    r2wt = r.block((NCW,))
    b2wt = r.block((NCW, MB))
    w2wt = r.block((NCW, MB))
    g2wt = r.block((NCW, MB))
    feux = r.block((8,))
    seanew = r.block((8, MB, 4))
    saanew = r.block((8, MB, 4))
    ganew = r.block((8, MB, 4))
    s0b = r.block((MBS,))

    hk = {}
    cgas = {}
    hk[1] = r.block((10,))
    cgas["fk1o3"] = r.block((10,))
    for ib, ncoef, npres in [(2, 8, 11), (3, 12, 11), (4, 7, 11),
                             (5, 12, 11), (6, 5, 11)]:
        hk[ib] = r.block((ncoef,))
        cgas[f"c{ib}h2o"] = r.block((3, npres, ncoef))
    for ib, ncoef in [(7, 2), (8, 3), (9, 4)]:
        hk[ib] = r.block((ncoef,))
        cgas[f"c{ib}h2o"] = r.block((3, 19, ncoef))
    hk[10] = r.block((4,))
    cgas["c10h2o"] = r.block((3, 19, 4))
    cgas["c10ch4"] = r.block((3, 19))
    cgas["c10n2o"] = r.block((3, 19))
    hk[11] = r.block((3,))
    cgas["c11h2o"] = r.block((3, 19, 3))
    cgas["c11ch4"] = r.block((3, 19))
    cgas["c11n2o"] = r.block((3, 19))
    hk[12] = r.block((5,))
    cgas["c12o3"] = r.block((3, 19, 5))
    cgas["c12h2o"] = r.block((3, 19))
    hk[13] = r.block((2,))
    cgas["c13h2o"] = r.block((3, 19, 2))
    hk[14] = r.block((10,))
    cgas["c14hca"] = r.block((3, 19, 10))
    cgas["c14hcb"] = r.block((3, 19, 10))
    hk[15] = r.block((12,))
    cgas["c15hca"] = r.block((3, 19, 12))
    cgas["c15hcb"] = r.block((3, 19, 12))
    for ib, ncoef in [(16, 7), (17, 7), (18, 8)]:
        hk[ib] = r.block((ncoef,))
        cgas[f"c{ib}h2o"] = r.block((3, 19, ncoef))
    o3un = r.block((52,))
    berayl = r.block((MBS,))

    return Pifm2Tables(ttab=ttab, pibtab=pibtab, ret=ret, r2wt=r2wt,
                       b2wt=b2wt, w2wt=w2wt, g2wt=g2wt, feux=feux,
                       seanew=seanew, saanew=saanew, ganew=ganew, s0b=s0b,
                       hk=hk, cgas=cgas, o3un=o3un, berayl=berayl)


# --------------------------------------------------------------------------
# Mie tables -> per-bin optics (intrad)
# --------------------------------------------------------------------------

def load_mie_tables(inpdir: str) -> np.ndarray:
    """Read the six urban/rural/ocean kw/lw files.

    Returns qabs0/qext0/asym0 stacked: [3 types, mb, nw0, na0, 3 quantities].
    """
    na0, nw0 = len(XA0), len(XW0)
    out = np.zeros((3, MB, nw0, na0, 3))
    for ityp, (fkw, flw) in enumerate(zip(MIE_FILES[::2], MIE_FILES[1::2])):
        for fname, b0, b1 in [(fkw, 0, MBS), (flw, MBS, MB)]:
            nb = b1 - b0
            # one record per (ja0, jw0, jb); the record holds 5 values but
            # the reference reads only the first 3 (qabs, qext, asym)
            rows = []
            with open(os.path.join(inpdir, fname)) as f:
                for line in f:
                    toks = line.split()
                    if len(toks) >= 3:
                        rows.append([float(toks[0]), float(toks[1]),
                                     float(toks[2])])
            vals = np.array(rows).reshape(na0, nw0, nb, 3)
            out[ityp, b0:b1] = np.transpose(vals, (2, 1, 0, 3))
    return out


def interpolate_particle_optics(mie: np.ndarray, rn: np.ndarray,
                                rq: np.ndarray):
    """Bilinear interpolation of the Mie tables onto the 2-D particle grid
    (reference ``intrad``).

    Args: mie [3, mb, nw0, na0, 3]; rn [nka] dry radii; rq [nkt, nka] total
    radii (um).  Returns (qabs, qext, asym), each [mb, nkt, nka, 3]
    (trailing axis = aerosol type: urban/rural/ocean).
    """
    nkt, nka = rq.shape
    xw1 = rq                                       # [nkt, nka]
    xa1 = 1.0 - (rn[None, :] / rq) ** 3

    iw = np.searchsorted(XW0, xw1)                 # first idx with xw0 >= xw1
    iw = np.clip(iw, 1, len(XW0) - 1)
    below = xw1 < XW0[0]
    above = xw1 > XW0[-1]
    dx = (xw1 - XW0[iw - 1]) / (XW0[iw] - XW0[iw - 1])
    dx = np.where(below, 0.0, np.where(above, 1.0, dx))
    iw = np.where(below, 1, np.where(above, len(XW0) - 1, iw))

    xa1 = np.clip(xa1, 0.0, 1.0)
    ia = np.clip(np.searchsorted(XA0, xa1), 1, len(XA0) - 1)
    dy = (xa1 - XA0[ia - 1]) / (XA0[ia] - XA0[ia - 1])

    w11 = (dx * dy)[None, :, :, None]
    w10 = (dx * (1 - dy))[None, :, :, None]
    w01 = ((1 - dx) * dy)[None, :, :, None]
    w00 = ((1 - dx) * (1 - dy))[None, :, :, None]

    def interp(q):  # q: [3 types, mb, nw0, na0]
        qt = np.transpose(q, (1, 0, 2, 3))  # [mb, 3, nw0, na0]
        v = (w11 * qt[:, :, iw, ia].transpose(0, 2, 3, 1)
             + w10 * qt[:, :, iw, ia - 1].transpose(0, 2, 3, 1)
             + w01 * qt[:, :, iw - 1, ia].transpose(0, 2, 3, 1)
             + w00 * qt[:, :, iw - 1, ia - 1].transpose(0, 2, 3, 1))
        return v  # [mb, nkt, nka, 3]

    qabs = interp(mie[..., 0])
    qext = interp(mie[..., 1])
    asym = interp(mie[..., 2])
    return qabs, qext, asym


# --------------------------------------------------------------------------
# synthetic stand-in tables
# --------------------------------------------------------------------------

def _synthetic_pifm2_blocks(rng):
    """(label, array) blocks of a stand-in pifm2 file, in load_pifm2's
    read order."""
    def weights(n):
        w = rng.uniform(0.3, 1.0, n)
        return w / w.sum()

    def lnk(npres, ncoef, k_lo, k_hi):
        """ln-k coefficients [3, npres(, ncoef)]: k rising from k_lo to k_hi
        over the quadrature points and as p^0.5 over the standard
        pressures, with a weak quadratic temperature dependence."""
        nc = 1 if ncoef is None else ncoef
        lp = np.log(np.geomspace(1e-2, 1.0, npres))
        c = np.empty((3, npres, nc))
        c[0] = (np.linspace(np.log(k_lo), np.log(k_hi), nc)[None, :]
                + 0.5 * lp[:, None] + rng.normal(0.0, 0.1, (npres, nc)))
        c[1] = rng.uniform(-0.01, 0.01, (npres, nc))
        c[2] = rng.uniform(-5e-5, 5e-5, (npres, nc))
        return c[..., 0] if ncoef is None else c

    ttab = np.linspace(170.0, 340.0, 35)
    ret = np.geomspace(4.18e-6, 3.123e-5, NCW)
    feux = np.array([0.0, 0.5, 0.7, 0.8, 0.9, 0.95, 0.98, 0.99])
    solar = np.arange(MB) < MBS
    # droplet extinction per unit water mass ~ 3 Q / (2 rho_w r_e)
    q = rng.uniform(0.8, 1.05, MB)
    b2wt = 1.5 * q[None, :] / (1000.0 * ret[:, None])
    w2wt = np.where(solar, rng.uniform(0.99, 0.9999, MB),
                    rng.uniform(0.3, 0.6, MB))[None, :] \
        * np.ones((NCW, 1))
    g2wt = np.linspace(0.80, 0.88, NCW)[:, None] * np.ones((1, MB))
    # aerosol extinction per particle growing with humidity, weaker in IR
    spec = np.where(solar, 1.0, 0.2) * rng.uniform(0.5, 1.0, MB)
    seanew = 1e-13 * (1.0 + 2.0 * feux)[:, None, None] \
        * spec[None, :, None] * rng.uniform(0.5, 1.5, (1, 1, 4))
    saanew = seanew * rng.uniform(0.02, 0.3, (1, MB, 4))
    ganew = (0.55 + 0.2 * feux)[:, None, None] * np.ones((1, MB, 4))
    z = np.arange(52.0)
    o3un = 0.15 * np.array([math.erfc((x - 24.0) / 9.0) for x in z])

    blocks = [("ttab", ttab),
              ("pibtab", (ttab[:, None] / 300.0) ** 4
               * rng.uniform(5.0, 15.0, MBIR)[None, :]),
              ("ret", ret), ("r2wt", np.ones(NCW)), ("b2wt", b2wt),
              ("w2wt", w2wt), ("g2wt", g2wt), ("feux", feux),
              ("seanew", seanew), ("saanew", saanew), ("ganew", ganew),
              ("s0b", np.array([600.0, 480.0, 160.0, 55.0, 35.0, 9.95])),
              ("hk1", weights(10)), ("fk1o3", np.geomspace(1.0, 200.0, 10))]
    for ib, ncoef in [(2, 8), (3, 12), (4, 7), (5, 12), (6, 5)]:
        blocks += [(f"hk{ib}", weights(ncoef)),
                   (f"c{ib}h2o", lnk(11, ncoef, 1e-6, 1.0))]
    for ib, ncoef in [(7, 2), (8, 3), (9, 4), (10, 4)]:
        blocks += [(f"hk{ib}", weights(ncoef)),
                   (f"c{ib}h2o", lnk(19, ncoef, 1e-5, 1.0))]
    blocks += [("c10ch4", lnk(19, None, 0.3, 0.3)),
               ("c10n2o", lnk(19, None, 1.0, 1.0)),
               ("hk11", weights(3)), ("c11h2o", lnk(19, 3, 1e-5, 1.0)),
               ("c11ch4", lnk(19, None, 0.3, 0.3)),
               ("c11n2o", lnk(19, None, 1.0, 1.0)),
               ("hk12", weights(5)), ("c12o3", lnk(19, 5, 1.0, 1e3)),
               ("c12h2o", lnk(19, None, 1e-3, 1e-3)),
               ("hk13", weights(2)), ("c13h2o", lnk(19, 2, 1e-5, 1.0))]
    for ib, ncoef in [(14, 10), (15, 12)]:
        blocks += [(f"hk{ib}", weights(ncoef)),
                   (f"c{ib}hca", lnk(19, ncoef, 1e-4, 10.0)),
                   (f"c{ib}hcb", lnk(19, ncoef, 1e-3, 1.0))]
    for ib, ncoef in [(16, 7), (17, 7), (18, 8)]:
        blocks += [(f"hk{ib}", weights(ncoef)),
                   (f"c{ib}h2o", lnk(19, ncoef, 1e-5, 1.0))]
    blocks += [("o3un", o3un),
               ("berayl", np.array([2.0e-5, 2.5e-6, 5.0e-7, 1.6e-7, 5.0e-8,
                                    2.0e-8]))]
    return blocks


def _synthetic_mie(rng, nb, solar):
    """[na0, nw0, nb, 3] stand-in (qabs, qext, asym) of one aerosol type:
    smooth in the size parameter 2 pi r / lambda, absorption rising with
    the water fraction in the IR."""
    lam = np.geomspace(0.5, 3.7, nb) if solar else np.geomspace(4.5, 35.0, nb)
    x = 2.0 * np.pi * XW0[None, :, None] / lam[None, None, :]
    qext = 2.0 * (1.0 - np.exp(-0.5 * x ** 2))
    base = rng.uniform(0.01, 0.1) if solar else rng.uniform(0.3, 0.6)
    absorbed = np.clip(base * (1.0 + 0.5 * XA0[:, None, None]), 0.0, 1.0)
    qabs = qext * absorbed
    asym = 0.7 * x ** 2 / (1.0 + x ** 2)
    shape = (len(XA0), len(XW0), nb)
    return np.stack([np.broadcast_to(qabs, shape),
                     np.broadcast_to(qext, shape),
                     np.broadcast_to(asym, shape)], axis=-1)


def write_synthetic_radiation_tables(inpdir) -> None:
    """Write stand-in ``pifm2_171115.dat`` and the six Mie files into inpdir.

    Not the reference's values: smooth tables, drawn from a fixed seed, in
    the reference's file formats and shapes (121 k-pairs over 18 bands, the
    Mie grids ``XA0`` x ``XW0``), for runs and tests where the reference
    input tables are absent.  Both packages read them with ``load_pifm2``
    and ``load_mie_tables``, so they see the same inputs.  They keep what
    the solver relies on: each band's quadrature weights are positive and
    sum to 1; the solar energies sum to ~1340 W m-2; the droplet radii
    rise over 4.18e-6 .. 3.123e-5 m and the reference humidities within
    [0, 1); aerosol absorption <= extinction, asymmetries in [0, 1),
    Rayleigh coefficients > 0; the ozone table decreases; the ln-k
    coefficients give layer optical depths from ~1e-4 to ~10 over the
    pairs; in the Mie files qext >= qabs >= 0 and 0 <= asym < 1.
    """
    rng = np.random.default_rng(0)
    with open(os.path.join(str(inpdir), PIFM2_FILE), "w") as f:
        for label, a in _synthetic_pifm2_blocks(rng):
            f.write(f" {label}\n")          # the separator line of a block
            flat = np.ravel(np.asarray(a, np.float64), order="F")
            for i in range(0, flat.size, 8):
                f.write("".join(f"{v:16.8e}" for v in flat[i:i + 8]) + "\n")
    for i, fname in enumerate(MIE_FILES):
        solar = fname.endswith("kw.dat")
        vals = _synthetic_mie(rng, MBS if solar else MBIR, solar)
        # one record of five numbers per (ja0, jw0, jb), jb fastest; the
        # reference's last two are not read
        with open(os.path.join(str(inpdir), fname), "w") as f:
            for rec in vals.reshape(-1, 3):
                f.write(" ".join(f"{v:.8e}" for v in rec) + " 0.0 0.0\n")
