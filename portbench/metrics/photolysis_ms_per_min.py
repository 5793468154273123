"""photolysis_ms_per_min: ms per window minute in the photolysis driver's
call (``Model.photolysis_step``, on even minutes when the sun is up in
some column): the program's ``photolysis`` spans over all the window's
minutes."""

from portbench import program_trace

LAYER = "Photolysis"
UNIT = "ms/min"
SOURCE = "program_span"
MOVES = "column_min_per_s"


def read(trace):
    return program_trace.ms_per_minute(trace, ("photolysis",))
