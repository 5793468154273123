"""ros3_graph_iter_pct: the share of the window's Ros3 loop iterations
that were replayed from CUDA graphs, the program's ``ros3.graph_iters``
over its ``ros3.iters`` counters (both solves), in percent."""

from portbench import program_trace

LAYER = "Ros3 loop"
UNIT = "%"
SOURCE = "program_counter"
MOVES = "column_min_per_s"


def read(trace):
    recs = program_trace.window(trace)
    if recs is None:
        return None
    iters = sum(r["counts"].get("ros3.iters", 0) for r in recs)
    if iters == 0:
        return None
    return 100.0 * sum(r["counts"].get("ros3.graph_iters", 0)
                       for r in recs) / iters
