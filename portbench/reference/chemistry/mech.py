# Frozen copy of mistra_tpu_torch/chemistry/mech.py (lines 1-714, commit b2518445).
"""Mechanism compiler: KPP-format equation files -> packed arrays.

Replaces the reference's offline KPP/csh code-generation pipeline
(src/mech/make_kpp.sc and the generated gas.f/aer.f/tot.f; SURVEY.md C39):
the ``.eqn`` mechanism definitions are parsed directly into stoichiometry
arrays plus rate-expression strings that are evaluated against the
vectorized rate-law library (``rates.py``).  One batched Rosenbrock
integrator then serves any mechanism size.

A copy of ``mistra_tpu/chemistry/mech.py`` (numpy only), plus
``write_synthetic_multiphase_mechanism``, which writes a stand-in
mechanism of the tot mechanism's block shape for runs without the
reference's mechanism files.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

import numpy as np

# species that KPP treats as fixed (held constant during integration);
# from the reference's #DEFFIX blocks (master.spc / gas.def)
DEFAULT_FIXED = ("O2", "N2", "H2O")

MAX_REACTANTS = 3


@dataclass
class Reaction:
    label: str
    reactants: list        # [(species, count)]
    products: list         # [(species, coeff)]
    rate_expr: str         # pythonized rate expression


@dataclass
class Mechanism:
    name: str
    species: list                  # variable species names (order = index)
    fixed: list                    # fixed species names
    reactions: list                # [Reaction]
    bins: tuple = ()               # active aqueous bins (multiphase)
    species_bin: np.ndarray = None # [nvar] aqueous bin of species (0 = gas)
    # packed arrays (built by finalize)
    stoich: np.ndarray = None      # [nrxn, nvar] net stoichiometry
    ridx: np.ndarray = None        # [nrxn, MAX_REACTANTS] reactant indices
    rcnt: np.ndarray = None        # [nrxn, MAX_REACTANTS] reactant orders
    fixed_ridx: np.ndarray = None  # [nrxn, MAX_REACTANTS] fixed-species idx

    @property
    def nvar(self) -> int:
        return len(self.species)

    @property
    def nrxn(self) -> int:
        return len(self.reactions)

    def finalize(self):
        """Build the packed stoichiometry / reactant-index arrays."""
        sp_idx = {s: i for i, s in enumerate(self.species)}
        fx_idx = {s: i for i, s in enumerate(self.fixed)}
        nrxn, nvar = len(self.reactions), len(self.species)
        stoich = np.zeros((nrxn, nvar))
        # reactant slots: entries < nvar are variable species; nvar means
        # "none"; nvar+1+k means fixed species k (concentration from FIX)
        ridx = np.full((nrxn, MAX_REACTANTS), nvar, dtype=np.int32)
        for j, rx in enumerate(self.reactions):
            slot = 0
            for name, cnt in rx.reactants:
                if name in fx_idx:
                    idx = nvar + 1 + fx_idx[name]
                elif name in sp_idx:
                    idx = sp_idx[name]
                    stoich[j, idx] -= cnt
                else:
                    raise KeyError(f"unknown reactant {name} in {rx.label}")
                for _ in range(int(cnt)):
                    if slot >= MAX_REACTANTS:
                        raise ValueError(f"too many reactants in {rx.label}")
                    ridx[j, slot] = idx
                    slot += 1
            for name, coeff in rx.products:
                if name in sp_idx:
                    stoich[j, sp_idx[name]] += coeff
                elif name not in fx_idx:
                    raise KeyError(f"unknown product {name} in {rx.label}")
        self.stoich = stoich
        self.ridx = ridx
        return self


_COMMENT_RE = re.compile(r"\{[^}]*\}")


def _pythonize_rate(expr: str) -> str:
    """Fortran rate expression -> python (evaluated against rates.py)."""
    e = expr.strip()
    # d-exponents: 1.4d-12 -> 1.4e-12 (also D), incl. forms like 5d2
    e = re.sub(r"(?<=[\d.])[dD](?=[+-]?\d)", "e", e)
    # Fortran operators and names
    e = e.replace(".d0", ".0")
    e = re.sub(r"\bDBLE\b", "", e, flags=re.IGNORECASE)
    # function/variable names lowercase (tokens only, not numbers)
    e = re.sub(r"\b[A-Za-z_][A-Za-z0-9_]*\b",
               lambda m: m.group(0).lower(), e)
    # ph_rat( 3) etc. are fine after lowering
    return e


def _parse_side(side: str, is_lhs: bool):
    """Parse one side of an equation into [(species, coeff)]; products may
    carry negative stoichiometry ("A - Hplz", master_aqueous.eqn)."""
    out = []
    # split into signed terms
    tokens = re.split(r"(?=[+-])", " " + side.strip())
    for term in tokens:
        term = term.strip()
        if not term:
            continue
        sign = 1.0
        if term[0] == "+":
            term = term[1:].strip()
        elif term[0] == "-":
            sign = -1.0
            term = term[1:].strip()
        if not term:
            continue
        m = re.match(r"^([0-9.]+)?\s*([A-Za-z][A-Za-z0-9_]*)$", term)
        if m is None:
            raise ValueError(f"cannot parse species term {term!r}")
        coeff = sign * (float(m.group(1)) if m.group(1) else 1.0)
        name = m.group(2)
        if name == "hv":
            continue
        if is_lhs and coeff < 0:
            raise ValueError(f"negative reactant {term!r}")
        out.append((name, coeff))
    return out


def parse_eqn(text: str, name: str = "mech",
              fixed=DEFAULT_FIXED) -> Mechanism:
    """Parse a KPP .eqn file (reference format, src/mech/master_gas.eqn)."""
    # drop the #EQUATIONS header
    text = re.sub(r"#\w+.*", "", text)
    # extract reaction labels before stripping comments: a reaction entry
    # starts with {label}; commented-out reactions start with {--- ...}
    # Strategy: remove ALL {---...} blocks (true comments), keep {label}
    # markers as separators, then strip remaining {...} inline comments.
    text = re.sub(r"\{---[^}]*\}", " ", text)

    reactions = []
    species = []
    seen = set(fixed)

    # split the stream at ';' into statements
    statements = []
    buf = []
    for line in text.splitlines():
        buf.append(line)
        if ";" in line:
            statements.append("\n".join(buf))
            buf = []
    for stmt in statements:
        stmt = stmt.strip()
        if not stmt or "=" not in stmt or ":" not in stmt:
            continue
        mlab = re.match(r"\s*\{([^}]*)\}", stmt)
        label = mlab.group(1).strip() if mlab else f"R{len(reactions)+1}"
        body = _COMMENT_RE.sub(" ", stmt)
        body = body.split(";")[0]
        lhs_rhs, rate = body.split(":", 1)
        lhs, rhs = lhs_rhs.split("=", 1)
        try:
            reac = _parse_side(lhs, True)
            prod = _parse_side(rhs, False)
        except ValueError as exc:
            raise ValueError(f"in reaction {label}: {exc}") from exc
        rx = Reaction(label=label, reactants=reac, products=prod,
                      rate_expr=_pythonize_rate(rate))
        reactions.append(rx)
        for nm, _ in reac + prod:
            if nm not in seen:
                seen.add(nm)
                species.append(nm)

    mech = Mechanism(name=name, species=species, fixed=list(fixed),
                     reactions=reactions)
    return mech.finalize()


def _resolve_includes(text: str, mechdir: str) -> str:
    """Inline KPP ``#INCLUDE file`` directives (one level, as gas.eqn uses)."""
    def repl(m):
        with open(f"{mechdir}/{m.group(1)}") as f:
            return f.read()
    return re.sub(r"#include\s+(\S+)", repl, text, flags=re.IGNORECASE)


def load_gas_mechanism(mechdir: str, fname: str = "gas.eqn",
                       iod: bool = True, halo: bool = True) -> Mechanism:
    """Gas mechanism = master_gas.eqn + the 8 active het-on-dry-aerosol
    reactions of gas.eqn (reference: mech/gas.eqn #INCLUDEs master_gas.eqn;
    KPP sizes NVAR=102/NREACT=331, gas_Parameters.h:26-49)."""
    mechdir = mechdir.rstrip("/")
    try:
        with open(f"{mechdir}/{fname}") as f:
            text = _resolve_includes(f.read(), mechdir)
    except FileNotFoundError:
        with open(f"{mechdir}/master_gas.eqn") as f:
            text = f.read()
    mech = parse_eqn(text, name="gas")
    # bin tag for the het product species (HNO3l1, SO4l2, DUMM1, ...);
    # restricted to species absent from the pure gas mechanism so that
    # gas-phase names that merely look binned (Cl2 = molecular chlorine)
    # stay gas-phase
    with open(f"{mechdir}/master_gas.eqn") as f:
        gas_names = set(parse_eqn(f.read(), name="gas_base").species)
    bins = []
    for s in mech.species:
        m = re.search(r"(?:l|DUMM)([12])$", s)
        bins.append(int(m.group(1)) if m and s not in gas_names else 0)
    mech.species_bin = np.asarray(bins, dtype=np.int32)
    return mech


# --------------------------------------------------------------------------
# multiphase mechanism construction (replaces make_aq_mech.sc / make_kpp.sc)
# --------------------------------------------------------------------------

def _clone_aqueous(text: str, b: int):
    """Clone the master aqueous mechanism for bin ``b`` (the csh script's
    z -> 1..4 substitution; mech/make_aq_mech.sc:27-40).

    Returns (cloned_text, aqueous_names): the set of species names created
    by the z-substitution, i.e. the definitive bin-``b`` aqueous species.
    Identifying them here (instead of regexing final names) avoids the
    trap that gas-phase names can *look* binned — "Cl2" ends in "l2" but
    is molecular chlorine, not a bin-2 species.
    """
    stem_re = re.compile(r"\b([A-Za-z][A-Za-z0-9_]*l)z\b")
    names = {m.group(1) + str(b) for m in stem_re.finditer(text)}
    out = text
    out = re.sub(r",\s*z\)", f",{b})", out)          # yxkmt(ind_X, z)
    out = re.sub(r"\(\s*z\)", f"({b})", out)         # ycw(z)
    out = re.sub(r"\bxliqz\b", f"xliq{b}", out)
    out = re.sub(r"\bcvvz\b", f"cvv{b}", out)
    out = stem_re.sub(rf"\g<1>{b}", out)
    return out, names


def _strip_includes(text: str) -> str:
    return re.sub(r"#include\s+\S+", "", text, flags=re.IGNORECASE)


def load_multiphase_mechanism(mechdir: str, bins=(1, 2, 3, 4),
                              name: str = "tot") -> Mechanism:
    """Build the aer (bins 1-2) or tot (bins 1-4) mechanism from the
    mechanism-definition sources."""
    mechdir = mechdir.rstrip("/")
    with open(f"{mechdir}/master_gas.eqn") as f:
        gas_text = f.read()
    parts = [gas_text]
    # heterogeneous reactions on dry/liquid aerosol from the .head files
    het_parts = []
    if name == "aer":
        with open(f"{mechdir}/aer_eqn.head") as f:
            het_parts.append(_strip_includes(f.read()))
    else:
        for head in ("tot_eqn12.head", "tot_eqn34.head"):
            try:
                with open(f"{mechdir}/{head}") as f:
                    het_parts.append(_strip_includes(f.read()))
            except FileNotFoundError:
                pass
    parts += het_parts
    with open(f"{mechdir}/master_aqueous.eqn") as f:
        aqueous = f.read()
    # bin of each aqueous species, tracked through the z-substitution
    aq_bin: dict[str, int] = {}
    for b in bins:
        cloned, names = _clone_aqueous(aqueous, b)
        parts.append(cloned)
        for nm in names:
            aq_bin[nm] = b

    fixed = list(DEFAULT_FIXED) + [f"H2Ol{b}" for b in bins]
    mech = parse_eqn("\n".join(parts), name=name, fixed=tuple(fixed))
    mech.bins = tuple(bins)

    # species introduced only by the heterogeneous .head reactions
    # (HNO3l1, SO4l2, DUMM1, ...): binned iff they are not gas-phase names
    gas_names = set(parse_eqn(gas_text, name="gas").species) \
        | set(DEFAULT_FIXED)
    for s in mech.species:
        if s in aq_bin or s in gas_names:
            continue
        m = re.search(r"(?:l|DUMM)([1-4])$", s)
        if m:
            aq_bin[s] = int(m.group(1))
    mech.species_bin = np.array([aq_bin.get(s, 0) for s in mech.species],
                                dtype=np.int32)
    return mech


# --------------------------------------------------------------------------
# synthetic stand-in for the reference's mechanism files
# --------------------------------------------------------------------------

# temperature at which the synthetic rate constants take their drawn values
_T_REF = 288.15


def _farr_expr(rng, k_ref):
    """``farr(a, b)`` with a random b and a chosen so that it is k_ref at
    _T_REF."""
    b = float(rng.uniform(-2000.0, 500.0))
    return f"farr({k_ref / np.exp(b / _T_REF):.6e}, {b:.3f})"


def _farr2_expr(rng, k_ref):
    """``farr2(a0, b0)`` (b0 referenced to 298 K) equal to k_ref at
    _T_REF."""
    b0 = float(rng.uniform(-3000.0, 3000.0))
    return (f"farr2({k_ref / np.exp(b0 * (1.0 / _T_REF - 3.3557e-3)):.6e}, "
            f"{b0:.3f})")


def _log_uniform(rng, lo, hi):
    return float(10.0 ** rng.uniform(lo, hi))


def write_synthetic_multiphase_mechanism(mechdir, n_gas: int = 101,
                                         n_aq: int = 80, seed: int = 0):
    """Write ``master_gas.eqn`` and ``master_aqueous.eqn`` of a stand-in
    multiphase mechanism into ``mechdir``; returns the two paths.

    NOT the reference's chemistry: the species (``G000``.. gas,
    ``A000lz``.. aqueous stems) and rate constants are random, drawn from
    ``seed``.  What it shares with the reference's tot mechanism is its
    shape: ``load_multiphase_mechanism(mechdir, bins=(1, 2, 3, 4))`` gives
    n_gas gas species and 4 bins of n_aq aqueous species (at the defaults
    mg = 101, ma = 80, nvar = 421, 1623 reactions), no aqueous reaction
    couples two bins (the block-arrow structure), and gas and aqueous
    phases exchange through transfer pairs.  Rate expressions use only
    constants, ``farr`` and ``farr2``; reactants may be ``O2`` and
    ``H2Olz`` (fixed species), so no aqueous hook (``xliqz``, ``cvvz``,
    ``yxkmt``) is needed.  The rates span about 1e-3..1e4 1/s at
    concentrations of ~1e-8 mol/m3, which makes the system stiff: a 10-s
    Ros3 solve takes on the order of a hundred steps per cell.
    """
    rng = np.random.default_rng(seed)
    gas = [f"G{i:03d}" for i in range(n_gas)]
    aq = [f"A{i:03d}lz" for i in range(n_aq)]
    ytyp = 1.0e-8          # typical concentration [mol/m3]

    def other(names, i):
        j = int(rng.integers(len(names) - 1))
        return names[j + (j >= i)]

    lines = ["#EQUATIONS", "{--- synthetic stand-in, not the reference "
             "mechanism ---}"]
    for i, s in enumerate(gas):
        # first-order conversion, bimolecular reaction, reaction with O2
        lines.append(f"{{SG{i}a}} {s} = {other(gas, i)} : "
                     f"{_farr_expr(rng, _log_uniform(rng, -3.0, 2.0))} ;")
        p, q = other(gas, i), other(gas, i)
        lines.append(f"{{SG{i}b}} {s} + {other(gas, i)} = {p} + {q} : "
                     f"{_farr2_expr(rng, _log_uniform(rng, -3.0, 1.0) / ytyp)}"
                     " ;")
        lines.append(f"{{SG{i}c}} {s} + O2 = {other(gas, i)} : "
                     f"{_log_uniform(rng, -4.0, -1.0):.6e} ;")
    gas_text = "\n".join(lines) + "\n"

    lines = ["#EQUATIONS", "{--- synthetic stand-in, not the reference "
             "mechanism; one bin (z) ---}"]
    for i, a in enumerate(aq):
        g = gas[i % n_gas]
        # gas <-> aqueous transfer pair
        lines.append(f"{{SA{i}i}} {g} = {a} : "
                     f"{_log_uniform(rng, -2.0, 1.0):.6e} ;")
        lines.append(f"{{SA{i}o}} {a} = {g} : "
                     f"{_farr_expr(rng, _log_uniform(rng, -2.0, 1.0))} ;")
        if i % 2 == 0:
            # fast equilibrium pair within the bin
            b = other(aq, i)
            kf = _log_uniform(rng, 1.0, 4.0)
            lines.append(f"{{SA{i}f}} {a} = {b} : {kf:.6e} ;")
            lines.append(f"{{SA{i}r}} {b} = {a} : "
                         f"{_farr2_expr(rng, kf * _log_uniform(rng, -1.0, 1.0))}"
                         " ;")
        if i % 2 == 0:
            lines.append(f"{{SA{i}w}} {a} + H2Olz = {other(aq, i)} : "
                         f"{_log_uniform(rng, -1.0, 2.0):.6e} ;")
        else:
            p = other(aq, i)
            lines.append(f"{{SA{i}b}} {a} + {other(aq, i)} = {p} : "
                         f"{_farr2_expr(rng, _log_uniform(rng, -3.0, 1.0) / ytyp)}"
                         " ;")
        if i % 8 == 0:
            lines.append(f"{{SA{i}d}} {a} = {other(aq, i)} : "
                         f"{_log_uniform(rng, -3.0, 0.0):.6e} ;")
    aq_text = "\n".join(lines) + "\n"

    mechdir = str(mechdir).rstrip("/")
    paths = (f"{mechdir}/master_gas.eqn", f"{mechdir}/master_aqueous.eqn")
    for path, text in zip(paths, (gas_text, aq_text)):
        with open(path, "w") as f:
            f.write(text)
    return paths


# the reference gas mechanism's shape: 95 gas species and 323 gas-phase
# reactions in master_gas.eqn, plus gas.eqn's 8 het-on-dry-aerosol
# reactions with 7 binned products (NVAR=102, NREACT=331)
_GAS_RXN_PER_95 = 323
# gas.eqn's het reactions: (reactant, products, bin, fdhetg species slot)
_HET_REACTIONS = (
    ("HNO3", "HNO3l1", 1, 1), ("N2O5", "2 HNO3l1", 1, 2),
    ("NH3", "NH3l1 + DUMM1", 1, 3), ("H2SO4", "SO4l1", 1, 4),
    ("HNO3", "HNO3l2", 2, 1), ("N2O5", "2 HNO3l2", 2, 2),
    ("NH3", "NH3l2", 2, 3), ("H2SO4", "SO4l2", 2, 4),
)
# named gas species, in the order a small stand-in takes them: (name,
# molar mass [kg/mol], ground mixing ratio [ppb], emission
# [molec/cm2/s]).  The first five are the het reactants; the rest are
# looked up by name in the drivers (Henry table, effective-solubility
# corrections, fixed deposition velocities, the halogen profiles).
_NAMED_GAS = (
    ("HNO3", 63.0e-3, 0.1, 0.0), ("N2O5", 108.0e-3, 1.0e-3, 0.0),
    ("NH3", 17.0e-3, 0.5, 5.0e9), ("H2SO4", 98.0e-3, 1.0e-4, 0.0),
    ("HCl", 36.5e-3, 0.1, 0.0), ("O3", 48.0e-3, 30.0, 0.0),
    ("NO", 30.0e-3, 0.05, 1.0e9), ("NO2", 46.0e-3, 0.1, 0.0),
    ("OH", 17.0e-3, 1.0e-4, 0.0), ("HO2", 33.0e-3, 1.0e-3, 0.0),
    ("SO2", 64.0e-3, 0.1, 0.0), ("DMS", 62.0e-3, 0.1, 3.0e9),
    ("HOCl", 52.5e-3, 1.0e-3, 0.0), ("Cl2", 71.0e-3, 1.0e-4, 0.0),
    ("HOBr", 97.0e-3, 1.0e-3, 0.0), ("Br2", 160.0e-3, 1.0e-4, 0.0),
    ("HOI", 144.0e-3, 1.0e-3, 0.0), ("I2", 254.0e-3, 1.0e-5, 0.0),
    ("CH3I", 142.0e-3, 1.0e-3, 1.0e8), ("HCHO", 30.0e-3, 0.3, 0.0),
    ("NO3", 62.0e-3, 1.0e-3, 0.0), ("HONO", 47.0e-3, 0.01, 0.0),
    ("HNO4", 79.0e-3, 0.01, 0.0), ("H2O2", 34.0e-3, 1.0, 0.0),
    ("C2H6", 30.0e-3, 1.0, 0.0), ("ETHE", 28.0e-3, 0.1, 0.0),
    ("PAN", 121.0e-3, 0.05, 0.0), ("ALD2", 44.0e-3, 0.1, 0.0),
    ("ACTA", 60.0e-3, 0.1, 0.0), ("ROOH", 48.0e-3, 0.5, 0.0),
    ("MO2", 47.0e-3, 1.0e-3, 0.0), ("O1D", 16.0e-3, 1.0e-9, 0.0),
    ("O3P", 16.0e-3, 1.0e-6, 0.0), ("CH3OH", 32.0e-3, 0.5, 0.0),
    ("C2H5OH", 46.0e-3, 0.1, 0.0), ("ClNO3", 97.5e-3, 1.0e-3, 0.0),
    ("BrNO3", 142.0e-3, 1.0e-3, 0.0), ("HBr", 81.0e-3, 1.0e-3, 0.0),
    ("BrCl", 115.5e-3, 1.0e-4, 0.0), ("IO", 143.0e-3, 1.0e-4, 0.0),
    ("OIO", 159.0e-3, 1.0e-4, 0.0), ("INO2", 173.0e-3, 1.0e-4, 0.0),
    ("INO3", 189.0e-3, 1.0e-4, 0.0), ("HI", 128.0e-3, 1.0e-4, 0.0),
    ("I2O2", 286.0e-3, 1.0e-5, 0.0), ("ICl", 162.5e-3, 1.0e-5, 0.0),
    ("IBr", 207.0e-3, 1.0e-5, 0.0), ("CH2I2", 268.0e-3, 1.0e-4, 5.0e7),
    ("CH2ClI", 176.5e-3, 1.0e-4, 5.0e7), ("C3H7I", 170.0e-3, 1.0e-4, 0.0),
    ("DMSO", 78.0e-3, 0.01, 0.0), ("DMSO2", 94.0e-3, 0.01, 0.0),
    ("CH3SO2H", 80.0e-3, 1.0e-3, 0.0), ("CH3SO3H", 96.0e-3, 0.01, 0.0),
)
# the photol_j slots (1-based) that the photolysis code fills
_J_SLOTS = tuple(k for k in range(1, 48) if k != 45)


def write_synthetic_gas_mechanism(mechdir, n_gas: int = 95, seed: int = 0):
    """Write ``master_gas.eqn``, ``gas.eqn``, ``gas_species.csv`` and
    ``euler_in.dat`` of a stand-in gas mechanism into ``mechdir``; returns
    the four paths.

    NOT the reference's chemistry: apart from gas.eqn's het reactions, the
    reactions and rate constants are random, drawn from ``seed``.  What it
    shares with the reference's gas mechanism is its shape and the names
    the drivers look up.  At the defaults ``load_gas_mechanism`` gives
    n_gas = 95 gas species plus the 7 binned products of the 8
    het-on-dry-aerosol reactions (``HNO3l1``, ``DUMM1``, ``NH3l1``,
    ``SO4l1``, ``HNO3l2``, ``NH3l2``, ``SO4l2``): nvar 102 and 331
    reactions, so ``GasKernel`` picks the block-arrow solver (2 bins of
    ma = 4, a gas core of mg = 95).  The first gas species carry the
    reference's names (``_NAMED_GAS``: HNO3, N2O5, NH3, H2SO4, HCl, then
    names of the Henry table and the halogen list), the rest are
    ``G000``..; n_gas must be at least 5.  Mixing ratios stay at or below
    30 ppb (the real reservoirs, CO2, CH4, CO and H2, are left out).

    Rate expressions: the het reactions are ``xhet1*fdhetg(1, s)`` and
    ``xhet2*fdhetg(2, s)``, as in gas.eqn; the gas reactions are
    ``farr``/``farr2`` first- and second-order conversions, reactions with
    the fixed O2, and about a quarter are photolysis ``ph_rat(k)``.
    Every gas reaction turns n molecules of variable species into n (or
    into fewer), so no chain can grow the total.  The first-order rates
    span ~1e-3..1e1 1/s and the second-order ones the same at the
    species' ppb-level concentrations: stiff over a 10-s substep, and
    solvable in float32 as in float64.
    """
    if n_gas < 5:
        raise ValueError(f"n_gas must be at least 5, got {n_gas}")
    rng = np.random.default_rng(seed)
    named = list(_NAMED_GAS[:n_gas])
    for i in range(n_gas - len(named)):
        named.append((f"G{i:03d}", float(rng.uniform(0.03, 0.15)),
                      _log_uniform(rng, -3.0, 1.0), 0.0))
    gas = [s[0] for s in named]
    # typical concentrations [mol/m3] at ~42 mol/m3 of air
    ctyp = [max(s[2], 1.0e-4) * 4.2e-8 for s in named]

    def other(i, avoid=()):
        while True:
            j = int(rng.integers(n_gas))
            if j != i and gas[j] not in avoid:
                return j

    lines = ["#EQUATIONS", "{--- synthetic stand-in, not the reference "
             "mechanism ---}"]
    n_rxn = (_GAS_RXN_PER_95 * n_gas) // 95
    for r in range(n_rxn):
        i, kind = r % n_gas, r // n_gas
        s = gas[i]
        if kind == 0:
            # bimolecular, two reactants to two products; k is such that
            # neither reactant's loss rate exceeds k1 at their typical
            # concentrations
            b = other(i)
            p, q = other(i, (gas[b],)), other(i, (gas[b],))
            k1 = _log_uniform(rng, -4.0, 0.0)
            rate = _farr2_expr(rng, k1 / max(ctyp[i], ctyp[b]))
            lines.append(f"{{SG{r}}} {s} + {gas[b]} = {gas[p]} + {gas[q]} "
                         f": {rate} ;")
        elif kind == 1:
            lines.append(f"{{SG{r}}} {s} = {gas[other(i)]} : "
                         f"{_farr_expr(rng, _log_uniform(rng, -4.0, 0.0))} ;")
        elif kind == 2 and i % 2:
            lines.append(f"{{SG{r}}} {s} + O2 = {gas[other(i)]} : "
                         f"{_log_uniform(rng, -5.0, -2.0):.6e} ;")
        else:
            slot = int(rng.choice(_J_SLOTS))
            lines.append(f"{{SG{r}}} {s} + hv = {gas[other(i)]} : "
                         f"ph_rat({slot}) ;")
    gas_text = "\n".join(lines) + "\n"

    het = ["#INCLUDE master_gas.eqn", "#EQUATIONS",
           "{--- het reactions on dry aerosol (gas.eqn's form) ---}"]
    for k, (reac, prods, b, slot) in enumerate(_HET_REACTIONS):
        het.append(f"{{HET{k + 1}}} {reac} = {prods} : "
                   f"xhet{b}*fdhetg({b},{slot}) ;")
    het_text = "\n".join(het) + "\n"

    # gas_species.csv: MISTRA index, name, molar mass, ground and top
    # mixing ratios [ppb], emission [molec/cm2/s]; one entry that no
    # reaction uses, as the reference's list has
    rows = ["! synthetic stand-in, not the reference's species list",
            "! index name mass[kg/mol] ground[ppb] top[ppb] "
            "emission[molec/cm2/s]"]
    for i, (name, mass, grd, emis) in enumerate(named):
        top = grd * float(rng.uniform(0.3, 1.5))
        rows.append(f"{i + 1} {name} {mass:.4E} {grd:.6e} {top:.6e} "
                    f"{emis:.3e}")
    rows.append(f"{n_gas + 1} NOTINMECH 1.0000E-01 1.0e-3 1.0e-3 0.0")

    # euler_in.dat: the advected species as (MISTRA index, xadv in
    # mol/mol/day); index 0 and an index without a species are skipped
    adv = [(1 + i, float(rng.uniform(-2.0, 5.0)) * 1.0e-9)
           for i in range(0, n_gas, 7)]
    euler = ["! synthetic stand-in: eulerian advection source",
             f"{len(adv) + 2}"]
    euler += [f"{g} {x:.4e}".replace("e", "d") for g, x in adv]
    euler += ["0 1.0d-9", f"{n_gas + 50} 1.0d-9"]

    mechdir = str(mechdir).rstrip("/")
    paths = (f"{mechdir}/master_gas.eqn", f"{mechdir}/gas.eqn",
             f"{mechdir}/gas_species.csv", f"{mechdir}/euler_in.dat")
    for path, text in zip(paths, (gas_text, het_text, "\n".join(rows) + "\n",
                                  "\n".join(euler) + "\n")):
        with open(path, "w") as f:
            f.write(text)
    return paths


# aqueous stems the multiphase drivers look up by name: the Pitzer ions
# (activity.ION_SPECIES), the loaded ions (sources.ION_NAMES, DOM), the
# mass-feedback ion CH3SO3- and the bisulfite of the SO2 equilibrium
_TOT_IONS = ("Hp", "NH4p", "HSO4m", "SO42m", "NO3m", "Clm", "HCO3m", "Brm",
             "Im", "IO3m", "DOM", "CH3SO3m", "HSO3m")
# acid-base equilibria of the stand-in: (acid stem, anion stem), each
# present when both stems are; ykef/ykeb look the acid up in
# aqueous.EQUILIBRIA (HSO4ml1's key carries the bin suffix)
_TOT_EQUILIBRIA = (("HNO3", "NO3m"), ("HCl", "Clm"), ("SO2", "HSO3m"),
                   ("H2SO4", "HSO4m"), ("HSO4m", "SO42m"), ("HBr", "Brm"))
# constant factor on the equilibrium hooks (forward and backward alike, so
# the equilibrium stays the table's): the table's relaxation rates
# (ykef ~1.5e10 1/s, ykeb ~1e9 cvv) leave a Ros3 solve at rtol 1e-3
# unconverged; scaled, the fastest equilibrium relaxes at ~1e2 1/s
_EQ_SCALE = 1.0e-8
# aqueous reactions per bin at 80 stems: the reference tot mechanism has
# 1627 reactions at its shape, 323 of them gas-phase and the heads' 14 here
_TOT_AQ_RXN = 322
_TOT_NAQ = 80


def write_synthetic_tot_mechanism(mechdir, n_gas: int = 95, n_aq: int = 78,
                                  seed: int = 0):
    """Write a stand-in of the reference's tot (multiphase) mechanism into
    ``mechdir``: ``write_synthetic_gas_mechanism``'s four files, plus
    ``tot_eqn12.head``, ``tot_eqn34.head`` and ``master_aqueous.eqn`` in
    the reference's formats; returns the seven paths.

    NOT the reference's chemistry: the gas phase is the gas stand-in's,
    the aqueous reactions and rate constants are drawn from ``seed``.
    What it shares with the reference is its shape and the names and
    hooks the multiphase drivers use.  ``load_multiphase_mechanism(mechdir,
    bins=(1, 2, 3, 4))`` gives n_gas gas species, 4 bins of n_aq aqueous
    species (bins 1 and 2 also hold the het products SO4l1, DUMM1 and
    SO4l2) and about 17 reactions per aqueous species: at the defaults
    nvar 410 (a gas core of mg = 95, bins of 80, 79, 78, 78: the largest,
    which sets the batched inverse's tile, is the reference's ~80) and
    ~1,590 reactions.  No reaction couples two aqueous bins.

    The aqueous stems (``Xlz``, cloned to bins 1-4) are the ions the
    drivers read (Hp, NH4p, HSO4m, SO42m, NO3m, Clm for the Pitzer
    activities; HCO3m, Brm, Im, IO3m, DOM for the ion loading; CH3SO3m;
    HSO3m), the dissolved form of every gas species in
    ``aqueous.EXCHANGE_SPECIES`` (HNO3lz among them), then ``A000lz``..
    up to n_aq.  Every aqueous rate carries ``xliqz``; together the files
    call every hook of the driver's rate namespace: gas <-> aqueous
    transfer pairs ``xliqz*yxkmt(ind_X,z)*ycw(z)`` and
    ``xliqz*yxkmt(ind_X,z)*yhenry(ind_X)``; acid-base equilibria
    ``ykef``/``ykeb`` (scaled by _EQ_SCALE); aqueous bimolecular
    reactions ``k*cvvz``; one rate on a gas concentration ``c(ind_O3)``;
    in ``tot_eqn12.head`` gas.eqn's 8 het reactions (``xhet1``,
    ``xhet2`` with ``fdhetg``, ``fdheta``, ``fdhett``) and N2O5 uptake by
    ``fhet_da``, ``fhet_dt`` and ``fhet_t``; in ``tot_eqn34.head`` N2O5
    uptake into the droplet bins 3 and 4.  n_gas must be at least 12 (the
    gas species through SO2 and DMS) and n_aq at least the count of
    stems the drivers need.
    """
    from .aqueous import EXCHANGE_SPECIES
    if n_gas < 12:
        raise ValueError(f"n_gas must be at least 12, got {n_gas}")
    paths = write_synthetic_gas_mechanism(mechdir, n_gas, seed)
    gas = [s[0] for s in _NAMED_GAS[:n_gas]]
    dissolved = [s for s in EXCHANGE_SPECIES if s in gas]
    stems = list(_TOT_IONS) + dissolved
    if n_aq < len(stems):
        raise ValueError(f"n_aq must be at least {len(stems)}, got {n_aq}")
    stems += [f"A{i:03d}" for i in range(n_aq - len(stems))]
    rng = np.random.default_rng(seed + 1)

    def pick(avoid=()):
        while True:
            s = stems[int(rng.integers(len(stems)))]
            if s not in avoid:
                return s

    lines = ["#EQUATIONS", "{--- synthetic stand-in, not the reference "
             "mechanism; one bin (z) ---}"]
    for s in dissolved:
        # gas <-> aqueous transfer pair (mech/master_aqueous.eqn's form)
        lines.append(f"{{T{s}i}} {s} = {s}lz : "
                     f"xliqz*yxkmt(ind_{s},z)*ycw(z) ;")
        lines.append(f"{{T{s}o}} {s}lz = {s} : "
                     f"xliqz*yxkmt(ind_{s},z)*yhenry(ind_{s}) ;")
    eq = f"{_EQ_SCALE:.1e}".replace("e", "d")
    for acid, anion in _TOT_EQUILIBRIA:
        if acid not in stems or anion not in stems:
            continue
        lines.append(f"{{E{acid}f}} {acid}lz = {anion}lz + Hplz : "
                     f"{eq}*xliqz*ykef(ind_{acid}lz,z) ;")
        lines.append(f"{{E{acid}b}} {anion}lz + Hplz = {acid}lz : "
                     f"{eq}*xliqz*ykeb(ind_{acid}lz,z) ;")
    # S(IV) oxidation by the gas-phase ozone of the cell
    lines.append("{SIVO3} HSO3mlz = SO42mlz + Hplz : "
                 "1.0d5*xliqz*c(ind_O3) ;")
    n_rxn = round(_TOT_AQ_RXN * n_aq / _TOT_NAQ)
    for r in range(n_rxn - (len(lines) - 2)):
        a = pick()
        kind = r % 4
        if kind == 0:
            # bimolecular, two stems to one: k [1/(M s)] times cvv
            b = pick((a,))
            rate = f"{_log_uniform(rng, -2.0, 2.0):.6e}*xliqz*cvvz"
            lines.append(f"{{R{r}}} {a}lz + {b}lz = {pick((a, b))}lz : "
                         f"{rate} ;")
        elif r % 8 == 3:
            # with the bin's water: 55.55 M x k
            lines.append(f"{{R{r}}} {a}lz + H2Olz = {pick((a,))}lz : "
                         f"{_log_uniform(rng, -5.0, -2.0):.6e}*xliqz*cvvz ;")
        else:
            lines.append(f"{{R{r}}} {a}lz = {pick((a,))}lz : "
                         f"{_log_uniform(rng, -3.0, 1.0):.6e}*xliqz ;")
    aq_text = "\n".join(lines) + "\n"

    head12 = ["#INCLUDE tot.spc", "#EQUATIONS",
              "{--- het reactions on dry aerosol and aerosol bins 1-2 "
              "(stand-in) ---}"]
    het_fn = ("fdhetg", "fdheta", "fdhett")
    for k, (reac, prods, b, slot) in enumerate(_HET_REACTIONS):
        head12.append(f"{{HET{k + 1}}} {reac} = {prods} : "
                      f"xhet{b}*{het_fn[k % 3]}({b},{slot}) ;")
    head12 += [
        "{HTA1} N2O5 = 2 HNO3l1 : fhet_da(xliq1,xhet1,1,1,1) ;",
        "{HTA2} N2O5 + Clml1 = NO2 + NO3ml1 : fhet_da(xliq1,xhet1,1,2,1) ;",
        "{HTD1} N2O5 = 2 HNO3l2 : fhet_dt(xliq2,xhet2,2,1,1) ;",
        "{HTT1} N2O5 + Brml2 = NO2 + NO3ml2 : fhet_t(2,3,1) ;"]
    head34 = ["#INCLUDE tot.spc", "#EQUATIONS",
              "{--- N2O5 uptake into the droplet bins (stand-in) ---}"]
    for b in (3, 4):
        head34.append(f"{{HTL{b}}} N2O5 = 2 HNO3l{b} : "
                      f"xliq{b}*yxkmt(ind_N2O5,{b})*ycw({b}) ;")

    mechdir = str(mechdir).rstrip("/")
    more = (f"{mechdir}/tot_eqn12.head", f"{mechdir}/tot_eqn34.head",
            f"{mechdir}/master_aqueous.eqn")
    for path, text in zip(more, ("\n".join(head12) + "\n",
                                 "\n".join(head34) + "\n", aq_text)):
        with open(path, "w") as f:
            f.write(text)
    return paths + more
