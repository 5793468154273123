"""``utils.profiling.trace`` on the CPU: the Chrome trace it writes holds
the ranges of the program's spans opened while it records."""

from __future__ import annotations

import json

import torch

from mistra_tpu_torch.utils import profiling as tprof


def test_trace_writes_a_chrome_trace_with_the_annotation(tmp_path):
    with tprof.tracing(), tprof.trace(str(tmp_path)):
        with tprof.span("mistra_span"):
            torch.ones(8, 8).sum()
    files = list(tmp_path.glob("trace_*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "mistra_span" for e in events)
    tprof.reset()
