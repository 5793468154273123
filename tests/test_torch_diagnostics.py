"""``chemistry.diagnostics`` against the JAX package's: the name parsing
(element counts, ion charges, the sulfur channels) on hand-written names
like those of tests/test_diagnostics.py and on the small tot stand-in
(``write_synthetic_tot_mechanism``), equal; family totals, ion balance,
aqueous mass, production/loss and the budget channels on random
concentrations and rates of two columns, float64, within 1e-12."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from mistra_tpu.chemistry import diagnostics as jd
from mistra_tpu.chemistry.mech import \
    load_multiphase_mechanism as jax_load_multiphase
from mistra_tpu_torch.chemistry import diagnostics as td
from mistra_tpu_torch.chemistry.mech import (load_multiphase_mechanism,
                                             write_synthetic_tot_mechanism)

GAS = ["Cl2", "BrCl", "HCl", "CH2I2", "N2O5", "DMS", "SO2", "INO2"]
BINNED = ["Clml1", "Cl2l2", "SO42ml3", "NH4pl1", "Brml4", "HSO4ml1",
          "Hpl2", "SO32ml4", "CO32ml1", "NH4pl2"]
BINS = np.array([1, 2, 3, 1, 4, 1, 2, 4, 1, 2])
ELEMENTS = ("Cl", "Br", "I", "S", "N", "C", "O", "H")


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-300))


@pytest.fixture(scope="module")
def tot(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tot"))
    write_synthetic_tot_mechanism(d, 12, 25)
    return load_multiphase_mechanism(d), jax_load_multiphase(d)


def test_name_parsing_matches_jax():
    for el in ELEMENTS:
        assert td.element_counts(GAS, el).tolist() == \
            jd.element_counts(GAS, el).tolist()
        assert td.element_counts(BINNED, el, BINS).tolist() == \
            jd.element_counts(BINNED, el, BINS).tolist()
    for name in GAS + BINNED:
        for binned in (True, False):
            assert td.ion_charge(name, binned) == jd.ion_charge(name, binned)
            assert td.base_name(name, binned) == jd.base_name(name, binned)


def test_tot_stand_in_parsing_matches_jax(tot):
    tm, jm = tot
    assert tm.species == jm.species
    for el in ELEMENTS:
        np.testing.assert_array_equal(
            td.element_counts(tm.species, el, tm.species_bin),
            jd.element_counts(jm.species, el, jm.species_bin))
    ti, tl = td.sulfur_reaction_channels(tm)
    ji, jl = jd.sulfur_reaction_channels(jm)
    assert ti.tolist() == ji.tolist() and tl == jl and len(ti) > 0


def test_column_diagnostics_match_jax(tot):
    tm, jm = tot
    rng = np.random.default_rng(7)
    B, n = 2, 9
    conc = rng.uniform(0.0, 1.0, (B, tm.nvar, n)) \
        * 10.0 ** rng.uniform(-12.0, -6.0, (B, tm.nvar, n))
    detw = rng.uniform(5.0, 20.0, n)
    mm = {s: rng.uniform(0.01, 0.2) for s in
          {s[:-2] if s[-2:-1] == "l" else s for s in tm.species}}
    fam = td.family_column_totals(torch.from_numpy(conc), tm.species,
                                  torch.from_numpy(detw),
                                  species_bin=tm.species_bin)
    bal = td.ion_balance(torch.from_numpy(conc), tm.species, tm.species_bin,
                         4)
    mass = td.total_aqueous_mass(torch.from_numpy(conc), tm.species,
                                 tm.species_bin, mm)
    assert bal.shape == mass.shape == (B, 4, n)
    for c in range(B):
        jc = jnp.asarray(conc[c])
        want = jd.family_column_totals(jc, jm.species, jnp.asarray(detw),
                                       species_bin=jm.species_bin)
        for el in ("Cl", "Br", "I", "S", "N"):
            assert rel(want[el], fam[el][c]) <= 1e-12, el
        assert rel(jd.ion_balance(jc, jm.species, jm.species_bin, 4),
                   bal[c]) <= 1e-12
        assert rel(jd.total_aqueous_mass(jc, jm.species, jm.species_bin,
                                         mm), mass[c]) <= 1e-12


def test_budgets_match_jax(tot):
    tm, jm = tot
    rng = np.random.default_rng(11)
    B, nlev = 2, 3
    rates = rng.uniform(-1.0, 1.0, (B, nlev, tm.nrxn)) * 1e-9
    species = [tm.species.index("SO2"), tm.species.index("DMS")]
    for i in species:
        prod, loss = td.species_production_loss(torch.from_numpy(rates),
                                                tm.stoich, i)
        assert prod.shape == loss.shape == (B, nlev)
        chans = td.species_budget_channels(torch.from_numpy(rates[:, 0]),
                                           tm.stoich, i, top=10)
        for c in range(B):
            jp, jl = jd.species_production_loss(jnp.asarray(rates[c]),
                                                jm.stoich, i)
            assert rel(jp, prod[c]) <= 1e-12 and rel(jl, loss[c]) <= 1e-12
            want = jd.species_budget_channels(jnp.asarray(rates[c, 0]),
                                              jm.stoich, i, top=10)
            assert [j for j, _ in want] == [j for j, _ in chans[c]]
            assert rel([v for _, v in want], [v for _, v in chans[c]]) \
                <= 1e-12
    levels = [1, 4, 7]
    acc = td.BudgetAccumulator(tm.nrxn, levels, B)
    jacc = [jd.BudgetAccumulator(tm.nrxn, levels) for _ in range(B)]
    for step in range(3):
        r = rates * (step + 1)
        acc.update(torch.from_numpy(r), 60.0)
        for c in range(B):
            jacc[c].update(r[c], 60.0)
    for c in range(B):
        assert rel(jacc[c].inst, acc.inst[c]) <= 1e-12
        assert rel(jacc[c].cum, acc.cum[c]) <= 1e-12
