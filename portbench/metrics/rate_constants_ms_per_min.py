"""rate_constants_ms_per_min: ms per window minute in the evaluation of
the mechanisms' rate expressions (``GasKernel.rate_constants``, the tot
and the gas-above kernels'): the program's ``rate_constants`` spans."""

from portbench import program_trace

LAYER = "Block-arrow solver, mechanism algebra"
UNIT = "ms/min"
SOURCE = "program_span"
MOVES = "column_min_per_s"


def read(trace):
    return program_trace.ms_per_minute(trace, ("rate_constants",))
