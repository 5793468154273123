"""chem_ops_ms_per_min: ms per window minute in the multiphase substep's
chemistry operators outside the solve: the program's spans ``difc``,
``konc``, ``sea_salt``, ``gasdrydep``, ``sedc``, ``sedl``, ``eulerian``
and ``feedback`` (``Model.substep``), their device time included."""

from portbench import program_trace

LAYER = "Multiphase driver"
UNIT = "ms/min"
SOURCE = "program_span"
MOVES = "column_min_per_s"
NAMES = ("difc", "konc", "sea_salt", "gasdrydep", "sedc", "sedl",
         "eulerian", "feedback")


def read(trace):
    return program_trace.ms_per_minute(trace, NAMES)
