"""device_idle_pct: the share of the profiled slice's wall time in which
no operation ran on the card (100 less the union of the CUDA intervals
over the slice).

Its spans name the breakdown's idle gaps by what the host was doing: the
physics operators, the radiation driver's call, the chemistry driver's
substep and its two Ros3 solves."""

LAYER = "Device (H100)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "column_min_per_s"
SPANS = {
    "kon": "mistra_tpu_torch.physics.growth:kon",
    "difm": "mistra_tpu_torch.physics.diffusion:difm",
    "difp": "mistra_tpu_torch.physics.diffusion:difp",
    "sedp": "mistra_tpu_torch.physics.sedimentation:sedp",
    "partdep": "mistra_tpu_torch.physics.sedimentation:partdep",
    "equil": "mistra_tpu_torch.physics.microphysics:equil",
    "surf0": "mistra_tpu_torch.physics.surface:surf0",
    "radiation": "model:_radiation",
    "chem_solve": "model:_chemistry.integrate_column",
    "ros3_tot": "model:_chemistry.tot_kernel.integrate",
    "ros3_gas": "model:_chemistry.kernel.integrate",
}


def read(trace):
    p = trace["profile"]
    if p is None or p["wall_s"] <= 0.0 or p["events"] == 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["wall_s"])
