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
