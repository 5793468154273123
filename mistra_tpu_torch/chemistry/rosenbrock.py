"""Batched Rosenbrock (Ros3) stiff ODE integrator for chemistry cells.

Port of ``mistra_tpu/chemistry/rosenbrock.py`` (KPP's
``RosenbrockIntegrator_g``, gas.f:1112-1337; Ros3 coefficients
gas.f:1474-1513; tolerances RTOL=1e-3, ATOL=1e-25, Hstart=1e-3 from
gas.f:739-747).

* The stage-matrix factorization/solve is pluggable (``linop``): a dense
  batched LU, the static sparse LU (sparse_lu.py), or the block-arrow
  solver (block_solver.py) whose batched inverse is the hand-written
  CUDA kernel on a GPU.
* The per-cell adaptive stepping is the JAX package's masked
  ``while_loop`` as a Python loop: all cells advance together, finished
  or rejected cells mask their updates, and the host asks ``done.all()``
  once per step.  A cell that exhausts ``max_steps`` is frozen
  individually (gas.f:764-767 / 1294-1325); the ``info`` dict reports
  which cells failed.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

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


class DenseLinOp:
    """Stage solves via batched dense LU with partial pivoting."""

    def __init__(self, jac_fn, nvar, dtype, device):
        self._jac = jac_fn
        self._eye = torch.eye(nvar, dtype=dtype, device=device)

    def jac(self, y):
        return self._jac(y)

    def prepare(self, jac0, ghinv):
        a = ghinv[:, None, None] * self._eye[None] - jac0
        return torch.linalg.lu_factor(a)

    def solve(self, fact, rhs):
        lu, piv = fact
        return torch.linalg.lu_solve(lu, piv, rhs[..., None])[..., 0]


class SparseLinOp:
    """Stage solves via the static-structure sparse LU (the
    KppDecomp/KppSolve design, gas.f:6142-6177)."""

    def __init__(self, jac_fn, slu, nvar, device):
        self._jac = jac_fn
        self._slu = slu
        perm = [int(p) for p in slu.perm]
        inv = [0] * nvar
        for newi, old in enumerate(perm):
            inv[old] = newi
        self._perm = perm
        self._inv_idx = torch.as_tensor(inv, device=device)
        self._diag_slots = [slu.slots[(i, i)] for i in range(nvar)]
        self._nvar = nvar

    def jac(self, y):
        return self._jac(y)

    def prepare(self, jac0, ghinv):
        a = [-v for v in jac0]
        for i in range(self._nvar):
            ds = self._diag_slots[i]
            a[ds] = a[ds] + ghinv
        return self._slu.decompose(a)

    def solve(self, fact, rhs):
        b = [rhs[:, p] for p in self._perm]
        x = self._slu.solve(fact, b)
        return torch.stack(x, dim=-1)[:, self._inv_idx]


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
    B, nvar = y0.shape
    dtype, dev = y0.dtype, y0.device
    opts = opts.for_dtype(dtype)
    roundoff = torch.finfo(dtype).eps
    hmax = tend

    def step_attempt(y, h, fcn0, fact):
        """One Ros3 step from y with factored stage matrix."""
        # stage 1
        k1 = linop.solve(fact, fcn0)
        # stage 2
        y2 = y + ROS_A21 * k1
        f2 = fun(y2)
        k2 = linop.solve(fact, f2 + (ROS_C21 / h)[:, None] * k1)
        # stage 3 (no new function evaluation)
        k3 = linop.solve(fact, f2 + (ROS_C31 / h)[:, None] * k1
                         + (ROS_C32 / h)[:, None] * k2)
        ynew = y + ROS_M[0] * k1 + ROS_M[1] * k2 + ROS_M[2] * k3
        yerr = ROS_E[0] * k1 + ROS_E[1] * k2 + ROS_E[2] * k3
        return ynew, yerr

    def err_norm(y, ynew, yerr):
        ymax = torch.maximum(y.abs(), ynew.abs())
        scale = opts.atol + opts.rtol * ymax
        return torch.sqrt(torch.mean((yerr / scale) ** 2, dim=-1))

    # start from Hstart (gas.f:739-747), floored at DELTA_MIN — the
    # reference's ros_Integrator does the same clip (gas.f:1112+)
    h = torch.full((B,), min(max(opts.hstart, opts.hmin, DELTA_MIN), hmax),
                   dtype=dtype, device=dev)
    y = y0
    t = torch.zeros((B,), dtype=dtype, device=dev)
    rej1 = torch.zeros((B,), dtype=torch.bool, device=dev)
    rej2 = torch.zeros((B,), dtype=torch.bool, device=dev)
    nstp = torch.zeros((B,), dtype=torch.int32, device=dev)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    failed = torch.zeros((B,), dtype=torch.bool, device=dev)

    while True:
        count("sync.ros3")
        if bool(done.all()):
            break
        h_eff = torch.clamp(torch.minimum(h, tend - t), min=10.0 * roundoff)

        fcn0 = fun(y)
        jac0 = linop.jac(y)
        ghinv = 1.0 / (h_eff * ROS_GAMMA)
        fact = linop.prepare(jac0, ghinv)
        ynew, yerr = step_attempt(y, h_eff, fcn0, fact)
        err = err_norm(y, ynew, yerr)
        # guard against NaN steps (singular matrix): treat as rejection
        bad = ~torch.isfinite(ynew).all(dim=-1)
        err = torch.where(bad, 1.0e10, err)

        fac = torch.clamp(FAC_SAFE / err ** (1.0 / ROS_ELO), FAC_MIN, FAC_MAX)
        hnew = h_eff * fac

        accept = (err <= 1.0) | (h_eff <= opts.hmin)
        upd = ~done

        y = torch.where((upd & accept)[:, None], ynew, y)
        t = torch.where(upd & accept, t + h_eff, t)

        # step-size control with rejection memory (gas.f:1294-1325)
        hnew_acc = torch.clamp(hnew, opts.hmin, hmax)
        hnew_acc = torch.where(rej1, torch.minimum(hnew_acc, h_eff),
                               hnew_acc)
        hnew_rej = torch.where(rej2, h_eff * FAC_REJ, hnew)
        h = torch.where(upd, torch.where(accept, hnew_acc, hnew_rej), h)
        rej2 = torch.where(upd, ~accept & rej1, rej2)
        rej1 = torch.where(upd, ~accept, rej1)

        nstp = nstp + upd.to(torch.int32)
        done = done | (t >= tend * (1.0 - 1e-12))
        # per-cell failure: a cell burning max_steps without reaching
        # tend freezes at its last accepted state; the rest of the
        # batch keeps integrating (reference warns per cell and
        # continues, gas.f:764-767)
        newly_failed = upd & (nstp >= opts.max_steps) & ~done
        failed = failed | newly_failed
        done = done | newly_failed

    info = {"t": t, "nsteps": nstp, "done": done, "failed": failed,
            "n_failed": failed.sum(dtype=torch.int32)}
    return y, info
