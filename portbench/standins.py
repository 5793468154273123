"""The stand-in input tables and mechanism that both sides of a run read.

The reference's own tables (``clarke.dat``, ``pifm2_171115.dat`` and the
six Mie files, ``photolys/*``) and its multiphase mechanism are not in the
repository.  A configuration lists under ``inputs`` which stand-ins it
needs; they are written by the reference copy's writers (frozen copies of
the port's ``write_synthetic_*``), into a directory of the run's own, and
both the program and the reference read those files.
"""

from __future__ import annotations

import os

from .reference.chemistry.mech import write_synthetic_tot_mechanism
from .reference.photolysis.tables import write_synthetic_photolysis_tables
from .reference.physics.surface import write_synthetic_clarke_table
from .reference.radiation.tables import write_synthetic_radiation_tables


def write_inputs(spec: dict, tmp: str):
    """(inpdir, mechdir) under tmp, holding the stand-ins that ``spec``
    (a configuration's ``inputs``) asks for."""
    inpdir = os.path.join(tmp, "input")
    mechdir = os.path.join(tmp, "mech")
    os.makedirs(inpdir)
    os.makedirs(mechdir)
    write_synthetic_clarke_table(inpdir)
    if spec.get("radiation"):
        write_synthetic_radiation_tables(inpdir)
    if spec.get("photolysis"):
        write_synthetic_photolysis_tables(inpdir)
    tot = spec.get("tot_mechanism")
    if tot is not None:
        write_synthetic_tot_mechanism(mechdir, **tot)
    return inpdir, mechdir
