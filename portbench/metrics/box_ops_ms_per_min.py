"""box_ops_ms_per_min: ms per window minute in the box substep's
operators outside the solve: the program's spans ``sea_salt`` (the
source at the box level), ``sedc_box`` (gas exchange over the box depth)
and ``box_partdep`` (particle and dissolved deposition) of
``BoxModel.substep``, their device time included."""

from portbench import program_trace

LAYER = "Box mode"
UNIT = "ms/min"
SOURCE = "program_span"
MOVES = "column_min_per_s"
NAMES = ("sea_salt", "sedc_box", "box_partdep")


def read(trace):
    return program_trace.ms_per_minute(trace, NAMES)
