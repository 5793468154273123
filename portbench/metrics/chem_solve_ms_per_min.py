"""chem_solve_ms_per_min: ms per minute in the chemistry driver's
integrate_column (liq_parm and the tot and gas-above Ros3 solves; once
per substep): the mean of the synchronised spans around it in the
window, outside the profiled slice, times its calls per minute of the
window."""

LAYER = "Multiphase driver"
UNIT = "ms/min"
SOURCE = "program_span"
MOVES = "column_min_per_s"
SPANS = {"chem_solve": "model:_chemistry.integrate_column"}


def read(trace):
    ms = trace["span_ms"].get("chem_solve")
    if not ms or trace["minutes"] <= 0:
        return None
    calls = trace["span_calls"]["chem_solve"] / trace["minutes"]
    return calls * sum(ms) / len(ms)
