"""Tracing / profiling of the PyTorch port (counterpart of
``mistra_tpu.utils.profiling``).

- ``trace(logdir)``: capture a ``torch.profiler`` trace of a code block,
  the host's operators and the card's kernels, exported as a Chrome
  trace (viewable in Perfetto or chrome://tracing).
- ``annotate(name)``: a named range (``torch.profiler.record_function``)
  that shows up in traces, so each physics operator is attributable on
  the timeline.
- ``Roofline``: analytic per-kernel FLOP/byte cost model from the grid
  dimensions, used with measured wall time to report the achieved
  fraction of the card's peak compute / memory bandwidth.
- ``benchmark(fn, *args)``: timing harness with the first call (on the
  card: the kernels' build and load, the allocator's warm-up) split out.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass, field

import torch

# Peak numbers for the roofline denominators, per card: NVIDIA H100 SXM
# (H100 80GB HBM3, data sheet at its 700 W power limit), the figures of
# the port's kernel bounds: HBM 3.35 TB/s; 67 TFLOP/s of float32 outside
# the tensor cores (float64 on the tensor cores has the same rate).
# Override via Roofline(peak_flops=..., peak_bw=...) for other hardware.
PEAK_FLOPS_F32 = 67e12
PEAK_HBM_BW = 3.35e12        # bytes/s


def _synchronize():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a torch.profiler trace of the enclosed block into
    ``logdir/trace_<pid>_<ns>.json`` (Chrome trace format): the host's
    operators and, on a host with a card, the card's kernels.  Yields
    the profiler."""
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(logdir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        _synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def annotate(name: str):
    """Named range visible in profiler timelines."""
    return torch.profiler.record_function(name)


def benchmark(fn, *args, iters: int = 10, warmup: int = 1):
    """Time a callable: returns (seconds/iter, first_call_seconds).

    The first call is measured separately; the steady calls are timed on
    the host clock with the card synchronised before and after them.
    """
    _synchronize()
    t0 = time.perf_counter()
    fn(*args)
    _synchronize()
    first_s = time.perf_counter() - t0
    for _ in range(max(0, warmup - 1)):
        fn(*args)
    _synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    _synchronize()
    return (time.perf_counter() - t0) / iters, first_s


@dataclass
class KernelCost:
    """Analytic cost of one kernel invocation."""
    name: str
    flops: float
    bytes: float

    def intensity(self) -> float:
        return self.flops / max(self.bytes, 1.0)


@dataclass
class Roofline:
    """Roofline bookkeeping: register analytic kernel costs, then report
    achieved compute / bandwidth fractions from measured wall time."""
    peak_flops: float = PEAK_FLOPS_F32
    peak_bw: float = PEAK_HBM_BW
    kernels: dict = field(default_factory=dict)

    def add(self, cost: KernelCost):
        self.kernels[cost.name] = cost

    def report(self, name: str, wall_s: float, batch: int = 1) -> dict:
        c = self.kernels[name]
        flops = c.flops * batch
        byts = c.bytes * batch
        bound = "compute" if c.intensity() > self.peak_flops / self.peak_bw \
            else "memory"
        return {
            "kernel": name,
            "wall_s": wall_s,
            "achieved_tflops": flops / wall_s / 1e12,
            "pct_peak_flops": 100.0 * flops / wall_s / self.peak_flops,
            "achieved_gbps": byts / wall_s / 1e9,
            "pct_peak_bw": 100.0 * byts / wall_s / self.peak_bw,
            "arithmetic_intensity": c.intensity(),
            "bound": bound,
        }


def model_costs(cfg, dtype_bytes: int = 4) -> Roofline:
    """Analytic per-minute-step costs for the main physics operators
    (the JAX package's cost model, SURVEY.md §6): chemistry Fun/Jac/LU
    sizes, radiation 121 (ig,ib) quadrature points x layers, growth
    iterations over the (nkt, nka) spectrum."""
    g = cfg.grid
    n, nf, nka, nkt = g.n, g.nf, g.nka, g.nkt
    r = Roofline()
    nsub = 6
    # difm/difc/difp: tridiagonal sweeps, ~10 flops/cell/sweep
    r.add(KernelCost("difm", 5 * 10 * n * nsub, 5 * 3 * n * dtype_bytes))
    r.add(KernelCost("difp", 10 * nka * nkt * n * nsub,
                     nka * nkt * n * dtype_bytes * 2))
    # kon/subkon: <=10 Newton iterations x spectrum x levels per substep
    r.add(KernelCost("kon", 10 * 40 * nka * nkt * nf * nsub,
                     nka * nkt * n * dtype_bytes * 4))
    # sedp: Courant-split advection over the spectrum
    r.add(KernelCost("sedp", 3 * 20 * nka * nkt * nf * nsub,
                     nka * nkt * n * dtype_bytes * 2))
    # radiation: 121 quadrature points x 18 bands worth of layer recursions
    nrlay = n + 10
    r.add(KernelCost("nstrahl", 121 * nrlay * 60.0,
                     121 * nrlay * dtype_bytes * 6))
    return r


def print_report(rows):
    for row in rows:
        print(json.dumps(row))
