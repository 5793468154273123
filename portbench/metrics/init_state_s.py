"""init_state_s: seconds of the run's ``Model.init_state`` (the host
column, the drivers' tables and mechanism, the initial radiation and
photolysis calls, the move to the device): the program's ``init_state``
span, part of ``setup_s``."""

from portbench import program_trace

LAYER = "Step driver"
UNIT = "s"
SOURCE = "program_span"
MOVES = "setup_s"


def read(trace):
    r = program_trace.first("init_state")
    return None if r is None else r["seconds"]
