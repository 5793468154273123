"""Chemistry kernel: mechanism arrays -> batched fun/jac/rates, on torch.

Port of ``mistra_tpu/chemistry/gas_kernel.py`` (which replaces the
KPP-generated ``Update_RCONST_g``/``Fun_g``/``Jac_SP_g``, gas.f:275-709,
2043-2655, with mechanism-as-data): rate expressions are evaluated against
the torch rate library, species production/loss and the dense Jacobian
are products with the packed stoichiometry, and the Ros3 integrator
advances all cells in one masked batch.

Concentration units: mol/m3 (the reference's transport unit; bimolecular
rate expressions carry the CONV1 factor in the mechanism file).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import resolve_device
from ..utils.profiling import count, span
from .mech import MAX_REACTANTS, Mechanism
from .rates import RateEnv, make_namespace
from . import rosenbrock


class GasKernel:
    # unless ``solver`` names one ("block", "sparse", "dense"): binned
    # mechanisms use the block-arrow solver with the batched inverse
    # (block_solver.py), others up to this size the static sparse LU; the
    # rule is the JAX package's (its ``use_sparse`` flag, which no caller
    # sets, is not ported)
    SPARSE_NVAR_MAX = 300

    def __init__(self, mech: Mechanism, dtype=torch.float64, device="cuda",
                 solver: str | None = None):
        self.mech = mech
        self.dtype = dtype
        self.device = resolve_device(device)
        self.nvar = mech.nvar
        self.nfix = len(mech.fixed)
        self.stoich = torch.as_tensor(mech.stoich, dtype=dtype,
                                      device=self.device)   # [nrxn, nvar]
        self.ridx = torch.as_tensor(mech.ridx, dtype=torch.long,
                                    device=self.device)     # [nrxn, 3]
        # per-slot one-hot for the dense Jacobian (zero rows for fixed)
        oh = []
        for l in range(MAX_REACTANTS):
            col = mech.ridx[:, l]
            m = np.zeros((mech.nrxn, mech.nvar))
            valid = col < mech.nvar
            m[np.nonzero(valid)[0], col[valid]] = 1.0
            oh.append(m)
        self.onehot = torch.as_tensor(np.stack(oh), dtype=dtype,
                                      device=self.device)   # [3, nrxn, nvar]
        sb = getattr(mech, "species_bin", None)
        binned = sb is not None and bool(np.any(np.asarray(sb) > 0))
        if solver is None:
            if binned:
                solver = "block"
            elif mech.nvar <= self.SPARSE_NVAR_MAX:
                solver = "sparse"
            else:
                solver = "dense"
        self.solver = solver
        self.slu = None
        self.block = None
        if solver == "sparse":
            from .sparse_lu import (SparseLU, jac_pattern_from_mech,
                                    sparse_jac_terms)
            self.slu = SparseLU(jac_pattern_from_mech(mech), mech.nvar)
            self._jac_terms = sparse_jac_terms(mech, self.slu)
        elif solver == "block":
            from .block_solver import BlockArrowSolver
            self.block = BlockArrowSolver(mech, dtype=dtype,
                                          device=self.device)

    # ------------------------------------------------------------------
    def rate_constants(self, env: RateEnv, fix=None) -> torch.Tensor:
        """Evaluate all rate expressions -> k [..., nrxn].

        env fields may be scalars or batched tensors; the result
        broadcasts.  fix: [..., nfix] fixed-species concentrations
        (FIX(indf_*) refs).
        """
        with span("rate_constants"):
            ns = make_namespace(env)
            ns.setdefault("fdhetg", lambda na, nb: 0.0)
            ns.setdefault("yxkmt", lambda ind, a: 0.0)
            ns.setdefault("ycw", lambda a: 0.0)
            # no aerosol environment bound: het-on-dry-aerosol switched off
            ns.setdefault("xhet1", 0.0)
            ns.setdefault("xhet2", 0.0)
            if fix is not None:
                ns["fix"] = lambda i: fix[..., i]
                for fi, name in enumerate(self.mech.fixed):
                    ns[f"indf_{name.lower()}"] = fi
            ks = []
            zero = env.te * 0.0
            for rx in self.mech.reactions:
                try:
                    k = eval(rx.rate_expr, {"__builtins__": {}}, ns)
                except Exception as exc:
                    raise RuntimeError(
                        f"rate expression for {rx.label} failed: "
                        f"{rx.rate_expr!r}: {exc}") from exc
                if not torch.is_tensor(k):
                    # a constant rate: copied to the device, a host sync
                    count("sync.rate_constants")
                ks.append(torch.as_tensor(k, dtype=self.dtype,
                                          device=zero.device) + zero)
            return torch.stack(ks, dim=-1)

    # ------------------------------------------------------------------
    def _cx(self, y, fix):
        """Extended concentration vector [B, nvar+1+nfix]."""
        ones = y.new_ones((y.shape[0], 1))
        return torch.cat([y, ones, fix], dim=-1)

    def _cr(self, cx):
        """Reactant concentrations per slot [B, nrxn, 3].  A gather: the
        JAX package's one-hot matmul form of it is a TPU (MXU) layout
        choice with the same values."""
        return cx[:, self.ridx]

    def fun(self, y, k, fix):
        """Tendencies [B, nvar] for concentrations y [B, nvar]."""
        return self.reaction_rates(y, k, fix) @ self.stoich

    def reaction_rates(self, y, k, fix):
        """Per-reaction mass-action rates [B, nrxn] (mol/m3/s), the
        quantity the reference budget files record (bud_g.f A(i)=RCT*...)."""
        return k * torch.prod(self._cr(self._cx(y, fix)), dim=-1)

    def _slot_weights(self, y, k, fix):
        """kw_l[b, r] = k_r * product of the reactants other than slot l."""
        cr = self._cr(self._cx(y, fix))
        p0, p1, p2 = cr[..., 0], cr[..., 1], cr[..., 2]
        return k * p1 * p2, k * p0 * p2, k * p0 * p1

    def jac(self, y, k, fix):
        """Dense Jacobian [B, nvar, nvar]."""
        jac = y.new_zeros((y.shape[0], self.nvar, self.nvar))
        for l, kw in enumerate(self._slot_weights(y, k, fix)):
            # J[b, s, m] = sum_j stoich[j, s] * kw[b, j] * [ridx(j,l) == m]
            jac = jac + torch.einsum("js,bj,jm->bsm", self.stoich, kw,
                                     self.onehot[l])
        return jac

    def jac_slot_values(self, y, k, fix):
        """Jacobian values per LU slot (permuted order) for the sparse
        path: list of [B] tensors (fill-in slots are constant zero)."""
        kw = self._slot_weights(y, k, fix)
        zero = y.new_zeros(y.shape[:1])
        vals = []
        for s in range(self.slu.nnz):
            terms = self._jac_terms[s]
            if not terms:
                vals.append(zero)
                continue
            acc = None
            for (l, r, coeff) in terms:
                t = kw[l][:, r] if coeff == 1.0 else coeff * kw[l][:, r]
                acc = t if acc is None else acc + t
            vals.append(acc)
        return vals

    def kw_weights(self, y, k, fix):
        """Per-slot Jacobian weights kwcat [B, 3*nrxn]:
        kw_l[r] = k_r * product of the other reactant concentrations
        (the quantity every Jacobian entry is linear in)."""
        return torch.cat(self._slot_weights(y, k, fix), dim=-1)

    # ------------------------------------------------------------------
    def integrate(self, y0, k, fix, dt,
                  opts: rosenbrock.RosOptions = rosenbrock.RosOptions()):
        """Advance the batch of cells by dt seconds."""
        fun = lambda y: self.fun(y, k, fix)
        if self.solver == "sparse":
            linop = rosenbrock.SparseLinOp(
                lambda y: self.jac_slot_values(y, k, fix),
                self.slu, self.nvar, self.device)
        elif self.solver == "block":
            solver = self.block
            jac_fn = lambda y: solver.assemble(self.kw_weights(y, k, fix))
            linop = _BoundBlockLinOp(solver, jac_fn)
        else:
            linop = rosenbrock.DenseLinOp(
                lambda y: self.jac(y, k, fix), self.nvar, self.dtype,
                self.device)
        return rosenbrock.integrate(fun, linop, y0, dt, opts)


class _BoundBlockLinOp:
    """BlockArrowSolver bound to a Jacobian-assembly closure."""

    def __init__(self, solver, jac_fn):
        self._solver = solver
        self._jac = jac_fn

    def jac(self, y):
        return self._jac(y)

    def prepare(self, ctx, ghinv):
        return self._solver.prepare(ctx, ghinv)

    def solve(self, fact, rhs):
        return self._solver.solve(fact, rhs)


# --------------------------------------------------------------------------
# species registry (gas_species.csv compatibility)
# --------------------------------------------------------------------------

def load_species_csv(path: str):
    """Parse the reference's gas species CSV (utils.f90 mk_interface input).

    Returns list of dicts: index, name, mass [kg/mol], ground/top mixing
    ratio [ppb], emission rate [molec/cm2/s].
    """
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("!"):
                continue
            toks = line.split()
            if len(toks) < 6:
                continue
            try:
                out.append({
                    "index": int(toks[0]),
                    "name": toks[1],
                    "mass": float(toks[2].replace("E", "e")),
                    "ground_ppb": float(toks[3]),
                    "top_ppb": float(toks[4]),
                    "emission": float(toks[5]),
                })
            except ValueError:
                continue
    return out
