"""Batched Rosenbrock (Ros3) stiff ODE integrator for chemistry cells.

Port of ``mistra_tpu/chemistry/rosenbrock.py`` (KPP's
``RosenbrockIntegrator_g``, gas.f:1112-1337; Ros3 coefficients
gas.f:1474-1513; tolerances RTOL=1e-3, ATOL=1e-25, Hstart=1e-3 from
gas.f:739-747).

* The stage-matrix factorization/solve is the ``linop`` argument; the
  program's one is the block-arrow solver (block_solver.py), whose
  batched inverse is the hand-written CUDA kernel on a GPU.
* The per-cell adaptive stepping is the JAX package's masked
  ``while_loop`` as a Python loop: all cells advance together, finished
  or rejected cells mask their updates, and the host asks ``done.all()``
  once per step.  A cell that exhausts ``max_steps`` is frozen
  individually (gas.f:764-767 / 1294-1325); the ``info`` dict reports
  which cells failed.
* An iteration is ``begin_step``, the stage matrix's factorization and
  ``end_step``.  ``integrate`` runs them op by op; ``GraphedLoop`` replays
  them on a CUDA device from CUDA graphs cut at the inverses of the
  factorization, which it launches between the graphs.
* Counters (``COUNTS``, and the program's tracer): ``ros3.iters``, every
  iteration on either path; ``ros3.graph_iters``, those replayed from
  graphs; ``ros3.graph_captures``, the graph sets captured.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import NamedTuple

import torch

from ..utils.profiling import count

# Ros3 coefficients (L-stable, 3 stages; gas.f:1474-1513)
ROS_A21 = 1.0
ROS_A31 = 1.0
ROS_A32 = 0.0
ROS_C21 = -0.10156171083877702091975600115545e1
ROS_C31 = 0.40759956452537699824805835358067e1
ROS_C32 = 0.92076794298330791242156818474003e1
ROS_M = (0.1e1, 0.61697947043828245592553615689730e1,
         -0.42772256543218573326238373806514)
ROS_E = (0.5, -0.29079558716805469821718236208017e1,
         0.22354069897811569627360909276199)
ROS_ELO = 3.0
ROS_GAMMA = 0.43586652150845899941601945119356
ROS_NEWF3 = False  # stage 3 reuses the stage-2 function value

FAC_MIN = 0.2
FAC_MAX = 6.0
FAC_REJ = 0.1
FAC_SAFE = 0.9
DELTA_MIN = 1.0e-5


@dataclass(frozen=True)
class RosOptions:
    rtol: float = 1.0e-3
    atol: float = 1.0e-25   # reference value (gas.f:739-747); f64 semantics
    hstart: float = 1.0e-3
    hmin: float = 0.0
    max_steps: int = 400

    def for_dtype(self, dtype):
        """The reference ATOL=1e-25 assumes f64: in f32 it sits far below
        rounding noise (yerr ~ eps_f32 * |y| ~ 1e-14 for mol/m3 fields),
        so the error norm can never pass and every cell burns max_steps
        rejections.  Use an atol at the f32 noise floor instead."""
        if torch.finfo(dtype).eps > 1e-10 and self.atol < 1e-18:
            return replace(self, atol=1.0e-16)
        return self


COUNTS = dict.fromkeys(("ros3.iters", "ros3.graph_iters",
                        "ros3.graph_captures"), 0)


def _count(name: str) -> None:
    COUNTS[name] += 1
    count(name)


def reset_counts() -> None:
    for name in COUNTS:
        COUNTS[name] = 0


class Ros3State(NamedTuple):
    """The loop's per-cell state."""
    y: torch.Tensor         # [B, nvar] concentrations
    t: torch.Tensor         # [B] time reached
    h: torch.Tensor         # [B] next step size
    rej1: torch.Tensor      # [B] the last attempt was rejected
    rej2: torch.Tensor      # [B] the two last attempts were rejected
    nstp: torch.Tensor      # [B] int32 attempts
    done: torch.Tensor      # [B] reached tend or failed
    failed: torch.Tensor    # [B] ran out of steps


def initial_state(y0, tend, opts: RosOptions) -> Ros3State:
    """The state at t = 0: start from Hstart (gas.f:739-747), floored at
    DELTA_MIN — the reference's ros_Integrator does the same clip
    (gas.f:1112+)."""
    B = y0.shape[0]
    dtype, dev = y0.dtype, y0.device
    h = torch.full((B,), min(max(opts.hstart, opts.hmin, DELTA_MIN), tend),
                   dtype=dtype, device=dev)
    t = torch.zeros((B,), dtype=dtype, device=dev)
    rej1 = torch.zeros((B,), dtype=torch.bool, device=dev)
    rej2 = torch.zeros((B,), dtype=torch.bool, device=dev)
    nstp = torch.zeros((B,), dtype=torch.int32, device=dev)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    failed = torch.zeros((B,), dtype=torch.bool, device=dev)
    return Ros3State(y0, t, h, rej1, rej2, nstp, done, failed)


def info(st: Ros3State) -> dict:
    """``integrate``'s info dict of a state."""
    return {"t": st.t, "nsteps": st.nstp, "done": st.done,
            "failed": st.failed,
            "n_failed": st.failed.sum(dtype=torch.int32)}


def begin_step(fun, jac, st: Ros3State, tend):
    """An iteration up to the stage matrix: the step each cell attempts,
    f(y), the Jacobian's context and the shift 1 / (gamma h)."""
    roundoff = torch.finfo(st.y.dtype).eps
    h_eff = torch.clamp(torch.minimum(st.h, tend - st.t), min=10.0 * roundoff)
    fcn0 = fun(st.y)
    jac0 = jac(st.y)
    ghinv = 1.0 / (h_eff * ROS_GAMMA)
    return h_eff, fcn0, jac0, ghinv


def end_step(fun, solve, st: Ros3State, h_eff, fcn0, fact, tend,
             opts: RosOptions) -> Ros3State:
    """The rest of an iteration from the factored stage matrix: one Ros3
    step attempt, its error norm, and each unfinished cell's acceptance,
    next step size and failure.  opts is ``for_dtype``'s."""
    y = st.y
    # stage 1
    k1 = solve(fact, fcn0)
    # stage 2
    y2 = y + ROS_A21 * k1
    f2 = fun(y2)
    k2 = solve(fact, f2 + (ROS_C21 / h_eff)[:, None] * k1)
    # stage 3 (no new function evaluation)
    k3 = solve(fact, f2 + (ROS_C31 / h_eff)[:, None] * k1
               + (ROS_C32 / h_eff)[:, None] * k2)
    ynew = y + ROS_M[0] * k1 + ROS_M[1] * k2 + ROS_M[2] * k3
    yerr = ROS_E[0] * k1 + ROS_E[1] * k2 + ROS_E[2] * k3

    ymax = torch.maximum(y.abs(), ynew.abs())
    scale = opts.atol + opts.rtol * ymax
    err = torch.sqrt(torch.mean((yerr / scale) ** 2, dim=-1))
    # guard against NaN steps (singular matrix): treat as rejection
    bad = ~torch.isfinite(ynew).all(dim=-1)
    err = torch.where(bad, 1.0e10, err)

    fac = torch.clamp(FAC_SAFE / err ** (1.0 / ROS_ELO), FAC_MIN, FAC_MAX)
    hnew = h_eff * fac

    accept = (err <= 1.0) | (h_eff <= opts.hmin)
    upd = ~st.done

    y = torch.where((upd & accept)[:, None], ynew, y)
    t = torch.where(upd & accept, st.t + h_eff, st.t)

    # step-size control with rejection memory (gas.f:1294-1325)
    hnew_acc = torch.clamp(hnew, opts.hmin, tend)
    hnew_acc = torch.where(st.rej1, torch.minimum(hnew_acc, h_eff),
                           hnew_acc)
    hnew_rej = torch.where(st.rej2, h_eff * FAC_REJ, hnew)
    h = torch.where(upd, torch.where(accept, hnew_acc, hnew_rej), st.h)
    rej2 = torch.where(upd, ~accept & st.rej1, st.rej2)
    rej1 = torch.where(upd, ~accept, st.rej1)

    nstp = st.nstp + upd.to(torch.int32)
    done = st.done | (t >= tend * (1.0 - 1e-12))
    # per-cell failure: a cell burning max_steps without reaching
    # tend freezes at its last accepted state; the rest of the
    # batch keeps integrating (reference warns per cell and
    # continues, gas.f:764-767)
    newly_failed = upd & (nstp >= opts.max_steps) & ~done
    failed = st.failed | newly_failed
    done = done | newly_failed
    return Ros3State(y, t, h, rej1, rej2, nstp, done, failed)


def integrate(fun, linop, y0, tend, opts: RosOptions = RosOptions()):
    """Integrate dy/dt = fun(y) from 0 to tend for a batch of cells.

    Args:
      fun: (B, nvar) -> (B, nvar) tendencies (autonomous).
      linop: stage-solve operator with methods ``jac(y) -> ctx``,
        ``prepare(ctx, ghinv) -> fact`` (factorize ghinv*I - J), and
        ``solve(fact, rhs[B, nvar]) -> x``.
      y0: [B, nvar] initial concentrations.
      tend: scalar integration length [s].

    Returns (y_final [B, nvar], info dict with per-cell ``t``,
    ``nsteps``, ``done``, ``failed`` and the count ``n_failed``).  Every
    loop iteration advances each unfinished cell by one step attempt, so
    the iteration count is ``nsteps.max()``.
    """
    opts = opts.for_dtype(y0.dtype)
    st = initial_state(y0, tend, opts)
    while True:
        count("sync.ros3")
        if bool(st.done.all()):
            break
        _count("ros3.iters")
        h_eff, fcn0, jac0, ghinv = begin_step(fun, linop.jac, st, tend)
        st = end_step(fun, linop.solve, st, h_eff, fcn0,
                      linop.prepare(jac0, ghinv), tend, opts)
    return st.y, info(st)


class GraphedLoop:
    """``integrate`` for one batch shape on a CUDA device, each iteration
    replayed from CUDA graphs.

    The iteration is cut at the inverses of ``linop.phases()`` (the
    protocol of ``BlockArrowSolver``: ``phases``, ``invert``, ``solve``,
    and ``jac``): the first graph is ``begin_step`` and the first phase,
    each next graph the next phase, and the last graph the last phase and
    ``end_step``, which writes the state into buffers made once.  Between
    two graphs ``linop.invert`` launches the inverse eagerly, into a
    buffer the next graph reads, so each launch is a call of the inverse
    as on the op-by-op path.  The operations are ``integrate``'s, in its
    order, so the results are bit for bit its own.

    fun and ``linop.jac`` read the rest of their inputs from buffers that
    the caller fills before each ``run``.  The first iteration of the
    first ``run`` runs op by op on the capture stream, so that every
    kernel is loaded and cuBLAS has its workspace there before the
    capture; the graphs are captured after it, in one memory pool that
    holds one iteration's intermediates.  The host still asks
    ``done.all()`` once per iteration.
    """

    def __init__(self, fun, linop, y0, tend, opts: RosOptions):
        self.fun, self.linop, self.tend = fun, linop, tend
        self.opts = opts.for_dtype(y0.dtype)
        y = torch.empty_like(y0, memory_format=torch.contiguous_format)
        self.state = Ros3State(y, *(v.clone() for v in initial_state(
            y, tend, self.opts)[1:]))
        self.stream = torch.cuda.Stream(device=y0.device)
        self.graphs = None
        self.inverses = []      # (input, output) of each inverse launch
        # what a later graph reads of an earlier one, kept alive so that
        # the pool never hands its memory to another tensor
        self._keep = {}

    def run(self, y0):
        """(y, info) of ``integrate`` from y0."""
        with torch.cuda.device(y0.device):
            for buf, v in zip(self.state,
                              initial_state(y0, self.tend, self.opts)):
                buf.copy_(v)
            while True:
                count("sync.ros3")
                if bool(self.state.done.all()):
                    break
                _count("ros3.iters")
                if self.graphs is None:
                    self._first_iteration()
                    continue
                for g, (a, out) in zip(self.graphs, self.inverses):
                    g.replay()
                    self.linop.invert(a, out=out)
                self.graphs[-1].replay()
                _count("ros3.graph_iters")
        st = Ros3State(*(v.clone() for v in self.state))
        return st.y, info(st)

    def _segments(self):
        """The iteration as functions of the inverse before (None for the
        first), each returning the matrices to invert next (None for the
        last)."""
        first, *middle, last = self.linop.phases()
        keep = self._keep = {}

        def head(_):
            h_eff, fcn0, jac0, ghinv = begin_step(
                self.fun, self.linop.jac, self.state, self.tend)
            keep.update(h_eff=h_eff, fcn0=fcn0)
            keep["part"], a = first(jac0, ghinv)
            return a

        def between(phase):
            def segment(inv):
                keep["part"], a = phase(keep["part"], inv)
                return a
            return segment

        def tail(inv):
            fact, _ = last(keep["part"], inv)
            new = end_step(self.fun, self.linop.solve, self.state,
                           keep["h_eff"], keep["fcn0"], fact, self.tend,
                           self.opts)
            for buf, v in zip(self.state, new):
                buf.copy_(v)

        return [head, *map(between, middle), tail]

    def _first_iteration(self):
        """One iteration op by op on the capture stream, then the capture
        of the graphs."""
        current = torch.cuda.current_stream()
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            inv = None
            for segment in self._segments():
                a = segment(inv)
                if a is not None:
                    inv = self.linop.invert(a)
        current.wait_stream(self.stream)
        pool = torch.cuda.graph_pool_handle()
        graphs, inv = [], None
        for segment in self._segments():
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g, pool=pool, stream=self.stream):
                a = segment(inv)
            graphs.append(g)
            if a is not None:
                inv = torch.empty_like(a)
                self.inverses.append((a, inv))
        self.graphs = graphs
        _count("ros3.graph_captures")
