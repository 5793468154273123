"""The frozen stand-in writers write what the port's writers write."""

from __future__ import annotations

import filecmp
import os

import pytest

from mistra_tpu_torch.chemistry import mech as prog_mech
from mistra_tpu_torch.photolysis import tables as prog_phot
from mistra_tpu_torch.physics import surface as prog_surface
from mistra_tpu_torch.radiation import tables as prog_rad
from portbench import standins
from portbench.reference.chemistry import mech
from portbench.reference.photolysis import tables as phot
from portbench.reference.physics import surface
from portbench.reference.radiation import tables as rad


def same_tree(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    for n in names:
        pa, pb = os.path.join(a, n), os.path.join(b, n)
        if os.path.isdir(pa):
            same_tree(pa, pb)
        else:
            assert filecmp.cmp(pa, pb, shallow=False), n


@pytest.mark.parametrize("ours, theirs", [
    (surface.write_synthetic_clarke_table,
     prog_surface.write_synthetic_clarke_table),
    (rad.write_synthetic_radiation_tables,
     prog_rad.write_synthetic_radiation_tables),
    (phot.write_synthetic_photolysis_tables,
     prog_phot.write_synthetic_photolysis_tables),
    (mech.write_synthetic_tot_mechanism,
     prog_mech.write_synthetic_tot_mechanism),
], ids=["clarke", "radiation", "photolysis", "tot_mechanism"])
def test_writers_are_byte_equal(tmp_path, ours, theirs):
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    ours(str(tmp_path / "a"))
    theirs(str(tmp_path / "b"))
    same_tree(tmp_path / "a", tmp_path / "b")


def test_small_tot_mechanism_is_byte_equal(tmp_path):
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    mech.write_synthetic_tot_mechanism(str(tmp_path / "a"), 12, 25, seed=3)
    prog_mech.write_synthetic_tot_mechanism(str(tmp_path / "b"), 12, 25,
                                            seed=3)
    same_tree(tmp_path / "a", tmp_path / "b")


@pytest.mark.parametrize("config", ["btz96", "multiphase"])
def test_write_inputs_gives_what_the_configuration_lists(tmp_path, config):
    from portbench import registry
    spec = registry.config(config)
    inp, mechdir = standins.write_inputs(spec["inputs"], str(tmp_path))
    have = set(os.listdir(inp))
    assert {"clarke.dat", rad.PIFM2_FILE, *rad.MIE_FILES} <= have
    assert ("photolys" in have) == bool(spec["inputs"]["photolysis"])
    assert bool(os.listdir(mechdir)) == bool(
        spec["inputs"]["tot_mechanism"])
