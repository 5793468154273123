"""``utils.profiling`` on the CPU: benchmark splits the first call from
the steady ones, annotate names a range that the Chrome trace written by
trace holds, the Roofline report is the JAX package's for the same
costs and peaks, and model_costs gives the JAX package's numbers for
the same configuration (its peaks are the H100's, not the TPU's)."""

from __future__ import annotations

import json

import pytest
import torch

import mistra_tpu_torch as pt
from mistra_tpu.config import GridParams, MistraConfig
from mistra_tpu.utils import profiling as jprof
from mistra_tpu_torch.utils import profiling as tprof


def test_benchmark_and_annotate():
    def f(x):
        with tprof.annotate("double"):
            return x * 2.0

    per_iter, first_s = tprof.benchmark(f, torch.ones(64, 64), iters=3)
    assert per_iter > 0.0 and first_s > 0.0


def test_trace_writes_a_chrome_trace_with_the_annotation(tmp_path):
    with tprof.trace(str(tmp_path)):
        with tprof.annotate("mistra_span"):
            torch.ones(8, 8).sum()
    files = list(tmp_path.glob("trace_*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "mistra_span" for e in events)


def test_roofline_report_matches_jax():
    for cost in ((1e9, 1e6), (1e6, 1e9)):
        r = tprof.Roofline(peak_flops=1e12, peak_bw=1e11)
        r.add(tprof.KernelCost("k", flops=cost[0], bytes=cost[1]))
        j = jprof.Roofline(peak_flops=1e12, peak_bw=1e11)
        j.add(jprof.KernelCost("k", flops=cost[0], bytes=cost[1]))
        assert r.report("k", wall_s=1e-2, batch=10) == \
            j.report("k", wall_s=1e-2, batch=10)
    assert tprof.Roofline().peak_bw == 3.35e12
    assert tprof.Roofline().peak_flops == 67e12


@pytest.mark.parametrize("dtype_bytes", [4, 8])
def test_model_costs_match_jax(dtype_bytes):
    grid = dict(nf=12, n_extra=6, nka=16, nkt=16, nb=8)
    r = tprof.model_costs(pt.MistraConfig(grid=pt.GridParams(**grid)),
                          dtype_bytes)
    j = jprof.model_costs(MistraConfig(grid=GridParams(**grid)),
                          dtype_bytes)
    assert set(r.kernels) == set(j.kernels) == {"difm", "difp", "kon",
                                                "sedp", "nstrahl"}
    for k, c in j.kernels.items():
        assert (r.kernels[k].flops, r.kernels[k].bytes) == \
            (c.flops, c.bytes)
