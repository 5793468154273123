# Frozen copy of mistra_tpu_torch/photolysis/tables.py (lines 1-397, commit b2518445).
"""Photolysis input tables: 176-interval cross sections, extraterrestrial
flux, quantum yields, and the Schumann-Runge Chebyshev coefficients.

Parses the reference data files (``CROSS_INIT``/jrate.f:767-1140 reads
flux.dat / sig0900.dat / cheb_coeff.dat; qyield.dat holds the CH2O, NO3
and NO2 quantum-yield channels).

Design note (TPU-first): the reference collapses the 176-interval spectrum
into a 7-interval band model with fitted lookup tables (lookt0900.dat,
Landgraf & Crutzen 1998) to save serial CPU time.  Here the full
176-interval actinic-flux calculation is carried out directly — the
wavelength axis is just another batch dimension on TPU — so the lookup
machinery is replaced by the exact spectral integral it approximates.

A copy of ``mistra_tpu.photolysis.tables`` (framework-free), plus
``write_synthetic_photolysis_tables`` for runs without the reference files.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

MAXWAV = 176

# single-temperature cross-section arrays in file order (jrate.f:938-1062)
SINGLE_CS = [
    "H2O", "HNO3", "HNO4", "SO2", "HCl", "HOCl", "BrNO3", "CF3Cl",
    "CCl3F", "CCl4", "CCl2O", "F115", "F114", "F113", "CF2O", "CClFO",
    "O2", "CH3OH", "H2O2", "F22", "F13B1", "F12B1", "CH3Br", "CCl2F2",
    "CH3OOH", "Cl2", "CHBr3", "Cl2O2", "N2O5", "O4", "NO3n", "O3H2O",
    "HOI_Jen91", "HOCH2OOH", "HOBr_JPL", "HOBr", "BrCl_noT", "ClNO2",
    "BrNO2", "Br2", "IO", "INO3", "CH3I", "I2", "ICl", "IBr", "C3H7I",
    "CH2ClI", "CH2I2", "INO2", "BrO_noT", "OClO_noT", "Cl2_noT", "HONO",
    "NO2m", "dumm23", "dumm24", "dumm25", "dumm26",
]

# temperature-dependent sets: (name, number of temperatures)
TDEP_CS = [("O3", 3), ("NO3", 2), ("NO2", 2), ("OCS", 2), ("ClONO2", 3),
           ("CH3CCl3", 3), ("CO2", 3)]
TDEP_CS_TAIL = [("HOI", 3), ("CH2O", 2), ("CH3Cl", 3)]

# Michelsen O(1D) quantum yield coefficients (jrate.f block data)
A_O1D = np.array([1.01, 1.01, 1.05, 1.15, 1.39, 1.90, 2.93, 4.87, 8.21,
                  13.3, 17.6, 20.4, 18.0, 21.8, 18.1, 17.2, 7.99, 12.9,
                  11.25])
B_O1D = np.array([3.933, 11.51, 33.09, 79.39, 159.9, 272.5, 407.9, 551.4,
                  682.3, 791.6, 851.3, 903.8, 900.3, 948.4, 891.1, 1066.0,
                  969.4, 1191.5, 1293.5])

# Schumann-Runge optical depth above TOA (CT_TOP, jrate.f block data)
CT_TOP = np.array([
    [-2.5488e2, 1.5900e1, -3.4078e-1, 2.5083e-3],
    [-5.8222e2, 3.5825e1, -7.4328e-1, 5.2068e-3],
    [-5.8239e2, 3.5637e1, -7.3537e-1, 5.1210e-3],
    [-5.6359e2, 3.4235e1, -7.0220e-1, 4.8652e-3],
    [-5.5623e2, 3.3538e1, -6.8358e-1, 4.7115e-3],
    [-6.4776e2, 3.8519e1, -7.7292e-1, 5.2339e-3],
    [-5.7035e2, 3.3504e1, -6.6617e-1, 4.4825e-3],
    [-5.7514e2, 3.3451e1, -6.5964e-1, 4.4075e-3],
    [-9.3045e2, 5.3921e1, -1.0505e0, 6.8803e-3],
    [-8.9272e2, 5.1460e1, -1.0005e0, 6.5579e-3],
    [-7.1078e2, 4.0599e1, -7.8842e-1, 5.1978e-3],
    [-1.4366e2, 6.1527e0, -9.5919e-2, 5.8395e-4],
    [-1.1535e2, 4.5631e0, -6.6966e-2, 4.1305e-4]])


def wavelength_grid():
    """Wavelength centers [cm] and widths of the 176 intervals
    (jrate.f:875-915)."""
    wave = np.zeros(MAXWAV)
    L = np.arange(1, 14)
    wave[:13] = 1.0 / (56250.0 - 500.0 * L)
    L = np.arange(14, 46)
    wave[13:45] = 1.0 / (49750.0 - (L - 13) * 500.0)
    L = np.arange(46, 69)
    wave[45:68] = (266.0 + (L - 13)) * 1.0e-7
    L = np.arange(69, 72)
    wave[68:71] = (320.5 + 2.0 * (L - 68)) * 1.0e-7
    L = np.arange(72, 177)
    wave[71:176] = (325.0 + 5.0 * (L - 71)) * 1.0e-7
    dwave = np.zeros(MAXWAV)
    dwave[1:-1] = 0.5 * (wave[2:] - wave[:-2])
    dwave[0] = dwave[1]
    dwave[-1] = dwave[-2]
    return wave, dwave


def rayleigh_cs(wave):
    """Nicolet (1984) Rayleigh scattering cross sections [cm2]."""
    wl = wave * 1.0e4  # um
    x = 0.389 * wl + 0.09426 / wl - 0.3228
    return 4.02e-28 / wl ** (4.0 + x)


@dataclass
class PhotolysisTables:
    wave: np.ndarray                  # [176] cm
    dwave: np.ndarray
    flux: np.ndarray                  # [176] photons/cm2/s per interval
    cs_ray: np.ndarray                # [176]
    cs: dict                          # name -> [176]
    cs_t: dict                        # name -> ([nT, 176], [nT] temps)
    coeff_hno3: np.ndarray            # [176] T-correction coefficients
    cheb_a: np.ndarray                # [20, 13]
    cheb_b: np.ndarray                # [20, 13]
    qy: dict                          # channel name -> [176]


def _read_floats(path):
    with open(path) as f:
        return f.read()


def load_photolysis_tables(inpdir_phot: str) -> PhotolysisTables:
    wave, dwave = wavelength_grid()

    flux = np.array(_read_floats(
        os.path.join(inpdir_phot, "flux.dat")).split(), dtype=float)
    assert flux.size == MAXWAV

    # --- sig0900.dat: headers + 7-per-line float blocks ------------------
    toks = _read_floats(os.path.join(inpdir_phot, "sig0900.dat")).split("\n")
    pos = 0

    def next_block(count):
        nonlocal pos
        vals = []
        while len(vals) < count:
            line = toks[pos]
            pos += 1
            vals.extend(float(v) for v in line.split())
        return np.array(vals[:count])

    def skip_header():
        nonlocal pos
        pos += 1

    cs = {}
    for name in SINGLE_CS:
        skip_header()
        cs[name] = next_block(MAXWAV)

    cs_t = {}
    for name, nt in TDEP_CS:
        skip_header()
        temps = next_block(nt)
        arrs = [next_block(MAXWAV) for _ in range(nt)]
        cs_t[name] = (np.stack(arrs), temps)
    skip_header()
    coeff_hno3 = next_block(MAXWAV)
    for name, nt in TDEP_CS_TAIL:
        skip_header()
        temps = next_block(nt)
        arrs = [next_block(MAXWAV) for _ in range(nt)]
        cs_t[name] = (np.stack(arrs), temps)

    # --- cheb_coeff.dat: comma-separated, 2 header lines per block, then
    # 20 records x 17 values (2 leading + 13 kept + 2 trailing) ------------
    cheb_toks = []
    for line in _read_floats(os.path.join(inpdir_phot,
                                          "cheb_coeff.dat")).splitlines():
        if "Cheb" in line or "Region" in line:
            continue
        for tok in line.replace(",", " ").split():
            try:
                cheb_toks.append(float(tok))
            except ValueError:
                pass

    def cheb_block(offset):
        vals = np.array(cheb_toks[offset:offset + 20 * 17]).reshape(20, 17)
        return vals[:, 2:15]

    cheb_a = cheb_block(0)
    cheb_b = cheb_block(20 * 17)

    # --- qyield.dat -------------------------------------------------------
    qlines = _read_floats(os.path.join(inpdir_phot,
                                       "qyield.dat")).splitlines()
    qy = {}
    qi = 0
    names = {"CH2O -> H+HCO": "CHOH", "CH2O -> H2+CO": "COH2",
             "NO3 -> NO2 + O": "NO2O", "NO3 -> NO + O2": "NOO2",
             "NO2 -> NO + O": "NO2"}
    current = None
    vals = []
    for line in qlines:
        stripped = line.strip()
        is_header = any(stripped.startswith(k.split()[0]) and "->" in
                        stripped for k in names) or \
            (stripped and not stripped[0].isdigit())
        if is_header and not stripped.replace(".", "").replace("E", "") \
                .replace("+", "").replace("-", "").replace(" ", "").isdigit():
            if current is not None:
                qy[current] = np.array(vals[:MAXWAV])
            key = None
            for k, v in names.items():
                if stripped.startswith(k):
                    key = v
            current = key
            vals = []
        else:
            vals.extend(float(v) for v in stripped.split())
    if current is not None:
        qy[current] = np.array(vals[:MAXWAV])

    return PhotolysisTables(
        wave=wave, dwave=dwave, flux=flux, cs_ray=rayleigh_cs(wave),
        cs=cs, cs_t=cs_t, coeff_hno3=coeff_hno3, cheb_a=cheb_a,
        cheb_b=cheb_b, qy=qy)


# --------------------------------------------------------------------------
# synthetic stand-in for the reference's photolys/ files
# --------------------------------------------------------------------------

PHOTOLYSIS_FILES = ("flux.dat", "sig0900.dat", "cheb_coeff.dat",
                    "qyield.dat")
# the headers of qyield.dat's five channels, in the loader's names
QY_HEADERS = {"CHOH": "CH2O -> H+HCO", "COH2": "CH2O -> H2+CO",
              "NO2O": "NO3 -> NO2 + O", "NOO2": "NO3 -> NO + O2",
              "NO2": "NO2 -> NO + O"}
# temperatures [K] of the temperature-dependent sets
_TEMPS = {2: (220.0, 298.0), 3: (226.0, 263.0, 298.0)}
# absorption bands of named species: (peak [cm2], centre [nm], width [nm])
_BANDS = {
    "NO2": (5.5e-19, 400.0, 55.0), "NO3": (1.2e-17, 640.0, 25.0),
    "HONO": (4.5e-19, 360.0, 25.0), "H2O2": (6.0e-20, 200.0, 40.0),
    "HNO3": (1.5e-19, 190.0, 25.0), "N2O5": (2.0e-19, 200.0, 40.0),
    "CH2O": (3.5e-20, 310.0, 25.0), "Cl2": (2.5e-19, 330.0, 30.0),
    "Cl2_noT": (2.5e-19, 330.0, 30.0), "Br2": (6.0e-19, 420.0, 45.0),
    "BrCl_noT": (3.8e-19, 375.0, 45.0), "I2": (3.0e-18, 500.0, 45.0),
    "IO": (2.0e-17, 440.0, 25.0), "HOBr": (2.5e-19, 280.0, 40.0),
    "HOI_Jen91": (3.5e-19, 340.0, 40.0), "HOI": (3.5e-19, 340.0, 40.0),
    "CH3I": (1.2e-18, 255.0, 20.0), "OClO_noT": (1.0e-17, 360.0, 35.0),
    "NO3n": (1.0e-20, 302.0, 15.0),
}


def _band(nm, peak, centre, width):
    return peak * np.exp(-0.5 * ((nm - centre) / width) ** 2)


def _logistic(nm, edge, width):
    """1 well below edge [nm], 0 well above."""
    return 1.0 / (1.0 + np.exp((nm - edge) / width))


def _synthetic_flux(nm, dnm):
    """Photons cm-2 s-1 in each interval: a 5778 K black body seen from
    1 AU, damped below ~300 nm as the solar spectrum is."""
    h, c, kb = 6.62607015e-34, 2.99792458e8, 1.380649e-23
    lam = nm * 1.0e-9
    radiance = 2.0 * h * c ** 2 / lam ** 5 \
        / np.expm1(h * c / (lam * kb * 5778.0))          # W m-2 sr-1 m-1
    irradiance = radiance * np.pi * (6.957e8 / 1.496e11) ** 2
    irradiance /= 1.0 + (300.0 / nm) ** 8
    return irradiance * lam / (h * c) * dnm * 1.0e-9 * 1.0e-4


def _synthetic_cross_sections(rng, nm):
    """{name: [176]} of every single-temperature set and {name: [nT, 176]}
    of every temperature-dependent one, positive and smooth."""
    def generic():
        return _band(nm, 10.0 ** rng.uniform(-20.0, -17.5),
                     rng.uniform(190.0, 360.0), rng.uniform(15.0, 50.0))

    cs = {}
    for name in SINGLE_CS:
        if name == "O2":
            # Herzberg continuum; the Schumann-Runge bands (the first 13
            # intervals) come from the Chebyshev fit
            cs[name] = np.where(nm < 245.0,
                                7.0e-24 * np.exp(-(nm - 200.0) / 12.0), 0.0)
        elif name in _BANDS:
            cs[name] = _band(nm, *_BANDS[name])
        else:
            cs[name] = generic()
    cs_t = {}
    for name, nt in TDEP_CS + TDEP_CS_TAIL:
        temps = np.asarray(_TEMPS[nt])
        if name == "O3":
            # Hartley band, Huggins tail and the Chappuis band
            base = _band(nm, 1.13e-17, 255.0, 22.0) \
                + _band(nm, 4.7e-21, 600.0, 60.0)
        elif name in _BANDS:
            base = _band(nm, *_BANDS[name])
        else:
            base = generic()
        # a few per cent per 10 K, more on the long-wave flank
        slope = 1.0e-3 * (1.0 + (nm > 300.0))
        cs_t[name] = (np.stack([base * (1.0 + slope * (t - 298.0))
                                for t in temps]), temps)
    return cs, cs_t


def _synthetic_chebyshev(rng):
    """cheb_a, cheb_b [20, 13]: the Schumann-Runge O2 cross section of
    interval i as exp(a (T - 220) + b), with b = ln sigma falling from
    sigma0_i at an O2 slant column of e^38 cm-2 to sigma0_i e^-s_i at
    e^56, and a ~ 2-8e-3 K-1; higher orders are small and decay."""
    cheb_a = np.zeros((20, 13))
    cheb_b = np.zeros((20, 13))
    sigma0 = 10.0 ** np.linspace(-20.0, -22.5, 13)
    slope = rng.uniform(2.0, 4.0, 13)
    cheb_b[0] = 2.0 * (np.log(sigma0) - 0.5 * slope)
    cheb_b[1] = -0.5 * slope
    cheb_a[0] = 2.0 * rng.uniform(2.0e-3, 8.0e-3, 13)
    cheb_a[1] = rng.uniform(-1.0e-3, 1.0e-3, 13)
    decay = 0.3 ** np.arange(2, 20)[:, None]
    cheb_b[2:] = 0.05 * decay * rng.uniform(-1.0, 1.0, (18, 13))
    cheb_a[2:] = 1.0e-4 * decay * rng.uniform(-1.0, 1.0, (18, 13))
    return cheb_a, cheb_b


def _synthetic_quantum_yields(nm):
    """The five channels of qyield.dat, each in [0, 1]."""
    return {
        "CHOH": 0.76 * _logistic(nm, 333.0, 4.0)
        * (1.0 - 0.6 * _logistic(nm, 260.0, 8.0)),
        "COH2": 0.5 * _logistic(nm, 356.0, 4.0)
        * (1.0 - _logistic(nm, 280.0, 10.0)),
        "NO2O": _logistic(nm, 615.0, 6.0),
        "NOO2": 0.35 * _band(nm, 1.0, 600.0, 10.0),
        "NO2": _logistic(nm, 405.0, 4.0),
    }


def _write_block(f, values, per_line=7):
    """values as lines of per_line floats (a new line for each block)."""
    for i in range(0, len(values), per_line):
        f.write(" ".join(f"{v:.6e}" for v in values[i:i + per_line]) + "\n")


def write_synthetic_photolysis_tables(inpdir) -> None:
    """Write stand-in ``flux.dat``, ``sig0900.dat``, ``cheb_coeff.dat`` and
    ``qyield.dat`` into ``inpdir/photolys/``.

    NOT the reference's data: smooth, physically plausible tables drawn
    from a fixed seed, in the reference's file formats, for runs and tests
    where the reference photolysis files are absent.  Both packages read
    them with ``load_photolysis_tables``, so they see the same inputs.
    What they keep: the extraterrestrial flux of a 5778 K black body at
    1 AU (~2.4e15 photons cm-2 s-1 per 5-nm interval in the visible, weak
    below 300 nm); positive cross sections, with O3's Hartley band at
    1.1e-17 cm2 near 255 nm, NO2's ~5.5e-19 near 400 nm and O2's Herzberg
    continuum below 245 nm; Schumann-Runge Chebyshev coefficients whose
    series gives ln(cross section) of -46..-56 over slant O2 columns of
    e^38..e^56 cm-2; and quantum yields in [0, 1].  So the O(1D),
    Schumann-Runge and Chebyshev paths of the solver see real numbers.
    """
    rng = np.random.default_rng(0)
    out = os.path.join(str(inpdir), "photolys")
    os.makedirs(out, exist_ok=True)
    wave, dwave = wavelength_grid()
    nm, dnm = wave * 1.0e7, dwave * 1.0e7

    with open(os.path.join(out, "flux.dat"), "w") as f:
        _write_block(f, _synthetic_flux(nm, dnm), per_line=6)

    cs, cs_t = _synthetic_cross_sections(rng, nm)
    coeff_hno3 = 1.5e-3 + 2.0e-3 * _logistic(nm, 260.0, 20.0)
    with open(os.path.join(out, "sig0900.dat"), "w") as f:
        for name in SINGLE_CS:
            f.write(f" {name} cross section [cm2], synthetic stand-in\n")
            _write_block(f, cs[name])
        for names in (TDEP_CS, None, TDEP_CS_TAIL):
            if names is None:
                f.write(" HNO3 temperature coefficients, synthetic\n")
                _write_block(f, coeff_hno3)
                continue
            for name, _ in names:
                arrs, temps = cs_t[name]
                f.write(f" {name} temperatures [K], then cross sections\n")
                _write_block(f, temps)
                for a in arrs:
                    _write_block(f, a)

    cheb_a, cheb_b = _synthetic_chebyshev(rng)
    with open(os.path.join(out, "cheb_coeff.dat"), "w") as f:
        for label, block in (("A", cheb_a), ("B", cheb_b)):
            f.write(f"Chebyshev coefficients {label} (synthetic stand-in)\n")
            f.write("Region 1-13: order, interval count, 13 values, 0, 0\n")
            for j, row in enumerate(block):
                vals = [float(j + 1), 13.0, *row, 0.0, 0.0]
                f.write(", ".join(f"{v:.8e}" for v in vals) + "\n")

    qy = _synthetic_quantum_yields(nm)
    with open(os.path.join(out, "qyield.dat"), "w") as f:
        for key, header in QY_HEADERS.items():
            # data lines start with a digit: the loader takes any other
            # line for a header
            f.write(f"{header}\n")
            _write_block(f, np.clip(qy[key], 0.0, 1.0))
