"""newton_iters_per_substep: subkon's Newton iterations per substep of the
window, counted by the dwsum kernel's launch counter (one launch per
iteration over the batch)."""

LAYER = "Newton loop"
UNIT = "iter/substep"
SOURCE = "program_counter"
MOVES = "column_min_per_s"
LAUNCHES = {"bott_dwsum": "mistra_tpu_torch.physics.bott_cuda:bott_dwsum"}


def read(trace):
    n = trace["launches"].get("bott_dwsum", 0)
    if n <= 0 or trace["substeps"] <= 0:
        return None
    return n / trace["substeps"]
