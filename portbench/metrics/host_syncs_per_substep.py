"""host_syncs_per_substep: the step's synchronising calls, the program's
``sync.*`` counters (reads of device values on the host: subkon's Newton
checks, sedp's Courant checks, the Ros3 loop's checks, the photolysis
check; copies of host values to the device, each a wait for the device:
the constant rates, the multiphase driver's index and weight arrays) in
the window's minutes, over the window's ``substep`` spans."""

from portbench import program_trace

LAYER = "Step driver"
UNIT = "syncs/substep"
SOURCE = "program_counter"
MOVES = "column_min_per_s"


def read(trace):
    recs = program_trace.window(trace)
    if recs is None:
        return None
    substeps = sum(r["name"] == "substep" for r in recs)
    if substeps == 0:
        return None
    return sum(n for r in recs for k, n in r["counts"].items()
               if k.startswith("sync.")) / substeps
