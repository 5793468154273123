"""box_post_minute_ms_per_min: ms per window minute in the box's end of
minute (``BoxModel.post_minute``: the solar zenith angle and, on even
minutes when the sun is up, the J-rates of every box's column): the
program's ``post_minute`` spans."""

from portbench import program_trace

LAYER = "Box mode"
UNIT = "ms/min"
SOURCE = "program_span"
MOVES = "column_min_per_s"


def read(trace):
    return program_trace.ms_per_minute(trace, ("post_minute",))
