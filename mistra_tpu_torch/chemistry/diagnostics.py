"""Chemistry diagnostics: family mass closure and per-reaction budgets.

Torch counterpart of ``mistra_tpu.chemistry.diagnostics``, every
concentration and rate with a leading column axis B.  Parity map:
``mass_ch`` (kpp.f90:5900-6181) column totals of the Cl / Br / I / S
element families across gas and aqueous phases; the ``bud_*`` files (C33)
record per-reaction instantaneous and cumulative rates.  Element counts
come from parsing species names (host code, a copy of the JAX package's),
reaction rates from the packed rate vector.
"""

from __future__ import annotations

import re

import numpy as np
import torch


def base_name(name: str, binned: bool) -> str:
    """Chemical formula of an aqueous species with the bin suffix and the
    trailing charge marker (m = anion, p = cation: Clm, SO42m, NH4p)
    removed.  Gas-phase names pass through untouched: gas "Cl2" keeps its
    l2, it is molecular chlorine, not a bin suffix."""
    if not binned:
        return name
    base = re.sub(r"l[1-4]$", "", name)
    return re.sub(r"[mp]$", "", base) if len(base) > 1 else base


def element_counts(species: list, element: str,
                   species_bin=None) -> np.ndarray:
    """Number of atoms of ``element`` in each species, parsed from the
    conventional species names (Cl2 -> 2, BrCl -> 1, Clml3 -> 1...).

    species_bin: [nvar] aqueous-bin array (0 = gas phase); required to
    strip the l1..l4 suffix of binned species.  None = all gas-phase.
    """
    counts = np.zeros(len(species))
    pat = re.compile(rf"{element}(?![a-z])([0-9]*)")
    for i, name in enumerate(species):
        binned = species_bin is not None and species_bin[i] > 0
        for m in pat.finditer(base_name(name, binned)):
            counts[i] += int(m.group(1)) if m.group(1) else 1
    return counts


def family_column_totals(sgas, species, detw, elements=("Cl", "Br", "I",
                                                        "S", "N"),
                         species_bin=None):
    """Column-integrated element totals [mol/m2] per family, each [B]
    (mass_ch, kpp.f90:5900-6181: gas + aqueous contributions enter
    through the combined species vector).

    sgas: [B, nvar, n] concentrations [mol/m3]; detw: [n] layer
    thicknesses.
    """
    detw = torch.as_tensor(detw, dtype=sgas.dtype, device=sgas.device)
    out = {}
    for el in elements:
        cnt = torch.as_tensor(element_counts(species, el, species_bin),
                              dtype=sgas.dtype, device=sgas.device)
        out[el] = torch.einsum("bsn,s,n->b", sgas, cnt, detw)
    return out


def species_production_loss(rates, stoich, species_idx):
    """Per-species production / loss rates from per-reaction rates
    (the S/DMS budget machinery bud_s_{g,a,t}.f generalized: every
    reaction producing or consuming the species is a budget channel).

    rates: [..., nrxn] (a leading column axis, levels...); stoich: [nrxn,
    nvar] net stoichiometry.  Returns (production [...], loss [...]) with
    loss >= 0.
    """
    col = torch.as_tensor(np.asarray(stoich)[:, species_idx],
                          dtype=rates.dtype, device=rates.device)
    prod = rates @ torch.clamp(col, min=0.0)
    loss = rates @ torch.clamp(-col, min=0.0)
    return prod, loss


def species_budget_channels(rates, stoich, species_idx, labels=None,
                            top: int = 20):
    """The ``top`` reactions by |contribution| to a species tendency, per
    column: the per-channel view the reference prints for the S family.

    rates: [B, nrxn] (one cell per column); returns, for each column, a
    list of (reaction label or index, signed rate) sorted by magnitude."""
    col = np.asarray(stoich)[:, species_idx]
    out = []
    for r in torch.as_tensor(rates).detach().cpu().numpy():
        contrib = r * col
        order = np.argsort(-np.abs(contrib))[:top]
        chans = []
        for j in order:
            if contrib[j] == 0.0:
                break
            lab = labels[j] if labels is not None else int(j)
            chans.append((lab, float(contrib[j])))
        out.append(chans)
    return out


class BudgetAccumulator:
    """Per-reaction rate budgets at selected levels of B columns
    (reference bud_gas: bg(1,:,:) instantaneous, bg(2,:,:) cumulative;
    bud_g.f:18-403); inst and cum are [B, nrxn, nlev] numpy arrays."""

    def __init__(self, nrxn: int, levels, B: int = 1):
        self.levels = np.asarray(levels)
        self.inst = np.zeros((B, nrxn, len(levels)))
        self.cum = np.zeros((B, nrxn, len(levels)))

    def update(self, rates_by_level, dt):
        """rates_by_level: [B, nlev_selected, nrxn] reaction rates
        [mol/m3/s]."""
        r = torch.as_tensor(rates_by_level).detach().cpu().numpy()
        self.inst = np.swapaxes(r, 1, 2)
        self.cum = self.cum + self.inst * dt


def ion_charge(name: str, binned: bool = True) -> int:
    """Signed charge parsed from the species naming convention
    (...m = anion, ...p = cation; SO42m/SO32m/CO32m carry charge -2)."""
    if not binned:
        return 0
    base = re.sub(r"l[1-4]$", "", name)
    if base.endswith("m"):
        return -2 if base in ("SO42m", "SO32m", "CO32m") else -1
    if base.endswith("p"):
        return 1
    return 0


def ion_balance(conc, species, species_bin, nkc):
    """Net charge [mol/m3] per chemistry bin, [B, nkc, n] (ion_mass,
    str.f90:6503-6612); exact electro-neutrality is not expected because
    Na+ is implicit, but drift in time indicates a bug.  conc: [B, nvar,
    n]."""
    z = np.array([ion_charge(s, species_bin[i] > 0)
                  for i, s in enumerate(species)])
    out = []
    for kc in range(1, nkc + 1):
        idx = np.nonzero((species_bin == kc) & (z != 0))[0]
        if idx.size == 0:
            out.append(conc.new_zeros((conc.shape[0], conc.shape[2])))
            continue
        zz = torch.as_tensor(z[idx], dtype=conc.dtype, device=conc.device)
        out.append(torch.einsum("bsn,s->bn", conc[:, idx], zz))
    return torch.stack(out, dim=1)


def total_aqueous_mass(conc, species, species_bin, molar_mass):
    """Total dissolved mass [g/m3] per bin, [B, nkc, n] (out_mass,
    str.f90:7114-7228).  conc: [B, nvar, n]; molar_mass: dict name ->
    kg/mol (0 for unknown names)."""
    nkc = int(species_bin.max()) if species_bin.size else 0
    out = []
    for kc in range(1, nkc + 1):
        idx = np.nonzero(species_bin == kc)[0]
        mm = torch.as_tensor(
            [molar_mass.get(re.sub(r"l[1-4]$", "", species[i]), 0.0) * 1e3
             for i in idx], dtype=conc.dtype, device=conc.device)
        out.append(torch.einsum("bsn,s->bn", conc[:, idx], mm))
    if not out:
        return conc.new_zeros((conc.shape[0], 0, conc.shape[2]))
    return torch.stack(out, dim=1)


def sulfur_reaction_channels(mech):
    """Budget channels of the S/DMS family: every reaction that moves a
    sulfur atom (the reference's fixed 122-channel layout bud_s_{g,a,t}.f
    generalized to mechanism-as-data: each S-touching reaction is one
    channel, at all levels).

    Returns (idx [nch] reaction indices, labels [nch]).
    """
    sb = getattr(mech, "species_bin", None)
    s_cnt = element_counts(mech.species, "S", sb)
    st = np.asarray(mech.stoich)
    has_s = (np.abs(st) @ (s_cnt > 0)) > 0
    idx = np.nonzero(has_s)[0]
    labels = [mech.reactions[i].label for i in idx]
    return idx, labels
