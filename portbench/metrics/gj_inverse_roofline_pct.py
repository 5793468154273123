"""gj_inverse_roofline_pct: the least time of the profiled slice's
batched inverses (``roofline.inverse_seconds`` of each launch's [N, m, m],
recorded from its input) over the device time of the ``gj_inverse``
kernels in the slice, in percent."""

from portbench import roofline
from portbench import trace as T

LAYER = "Inverse kernel"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "column_min_per_s"


def _launch(args, kwargs, out):
    a = args[0]
    return (a.shape[0], a.shape[-1], a.element_size(),
            str(a.dtype).replace("torch.", ""))


RECORDS = {"inverse": {
    "target": "mistra_tpu_torch.chemistry.lu_cuda:batched_inv",
    "take": _launch, "slice": True}}


def read(trace):
    p = trace["profile"]
    if p is None:
        return None
    least = T.launch_bounds(trace["records"].get("inverse"),
                            roofline.inverse_seconds)
    spent = T.kernel_seconds(p, "gj_inverse")
    if least is None or spent <= 0.0:
        return None
    return 100.0 * least / spent
