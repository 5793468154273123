"""box_solve_ms_per_min: ms per window minute in the box's stiff solve
(``integrate_box``: liq_parm and the one-level tot Ros3 solve, once per
substep): the program's ``chem_solve`` spans of ``BoxModel.substep``."""

from portbench import program_trace

LAYER = "Box mode"
UNIT = "ms/min"
SOURCE = "program_span"
MOVES = "column_min_per_s"


def read(trace):
    return program_trace.ms_per_minute(trace, ("chem_solve",))
