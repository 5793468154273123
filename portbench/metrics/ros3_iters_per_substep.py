"""ros3_iters_per_substep: Ros3 loop iterations per substep of the window,
both solves: the sum over GasKernel.integrate calls of the largest step
count of the call's cells (the loop runs until its slowest cell ends)."""

LAYER = "Ros3 loop"
UNIT = "iter/substep"
SOURCE = "program_counter"
MOVES = "column_min_per_s"


def _steps(args, kwargs, out):
    return out[1]["nsteps"].max()


RECORDS = {
    "ros3_tot": {"target": "model:_chemistry.tot_kernel.integrate",
                 "take": _steps},
    "ros3_gas": {"target": "model:_chemistry.kernel.integrate",
                 "take": _steps},
}


def read(trace):
    steps = [n for k in RECORDS for n in trace["records"].get(k, [])]
    if not steps or trace["substeps"] <= 0:
        return None
    return sum(steps) / trace["substeps"]
