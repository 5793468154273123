"""liq_parm_ms_per_min: ms per window minute in the multiphase driver's
liq_parm (the liquid-phase parameters of every chemistry substep): the
program's ``liq_parm`` spans inside ``chem_solve``."""

from portbench import program_trace

LAYER = "Multiphase driver"
UNIT = "ms/min"
SOURCE = "program_span"
MOVES = "column_min_per_s"


def read(trace):
    return program_trace.ms_per_minute(trace, ("liq_parm",))
