"""radiation_ms_per_min: ms per minute in the radiation driver's call (once
per minute, in post_minute): the mean of the synchronised spans around
it in the window, outside the profiled slice, times its calls per minute
of the window."""

LAYER = "Radiation"
UNIT = "ms/min"
SOURCE = "program_span"
MOVES = "column_min_per_s"
SPANS = {"radiation": "model:_radiation"}


def read(trace):
    ms = trace["span_ms"].get("radiation")
    if not ms or trace["minutes"] <= 0:
        return None
    calls = trace["span_calls"]["radiation"] / trace["minutes"]
    return calls * sum(ms) / len(ms)
