"""bott_advect_roofline_pct: the least time of the profiled slice's
``bott_advect`` launches (``roofline.bott_advect_seconds`` of each launch's
rows, bins and significant bins, recorded from its input z) over the
device time of ``bott_advect_kernel`` in the slice, in percent."""

from portbench import roofline
from portbench import trace as T

LAYER = "Bott kernels"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "column_min_per_s"


def _launch(args, kwargs, out):
    z = args[2]
    return (z.numel() // z.shape[-1], z.shape[-1],
            (z >= roofline.YMIN).sum(), z.element_size(),
            str(z.dtype).replace("torch.", ""))


RECORDS = {"bott_advect": {
    "target": "mistra_tpu_torch.physics.bott_cuda:bott_advect",
    "take": _launch, "slice": True}}


def read(trace):
    p = trace["profile"]
    if p is None:
        return None
    least = T.launch_bounds(trace["records"].get("bott_advect"),
                            roofline.bott_advect_seconds)
    spent = T.kernel_seconds(p, "bott_advect_kernel")
    if least is None or spent <= 0.0:
        return None
    return 100.0 * least / spent
