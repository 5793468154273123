"""growth_ms_per_min: ms per minute in growth.kon, the condensational
growth (once per substep): the mean of the synchronised spans around it
in the window, outside the profiled slice, times its calls per minute of
the window."""

LAYER = "Physics operators"
UNIT = "ms/min"
SOURCE = "program_span"
MOVES = "column_min_per_s"
SPANS = {"kon": "mistra_tpu_torch.physics.growth:kon"}


def read(trace):
    ms = trace["span_ms"].get("kon")
    if not ms or trace["minutes"] <= 0:
        return None
    calls = trace["span_calls"]["kon"] / trace["minutes"]
    return calls * sum(ms) / len(ms)
