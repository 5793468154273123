"""Chemistry kernel: mechanism arrays -> batched rates and Ros3, on torch.

Port of ``mistra_tpu/chemistry/gas_kernel.py`` (which replaces the
KPP-generated ``Update_RCONST_g``/``Fun_g``/``Jac_SP_g``, gas.f:275-709,
2043-2655, with mechanism-as-data): rate expressions are evaluated against
the torch rate library, species production/loss and the Jacobian's
per-slot weights are products with the packed stoichiometry, and the Ros3
integrator advances all cells in one masked batch, with the block-arrow
stage solver (block_solver.py) for every mechanism; on a CUDA device each
iteration replays CUDA graphs around the solver's inverses.

Concentration units: mol/m3 (the reference's transport unit; bimolecular
rate expressions carry the CONV1 factor in the mechanism file).
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

from ..utils import resolve_device
from ..utils.profiling import count, span
from .block_solver import BlockArrowSolver
from .mech import Mechanism
from .rates import RateEnv, make_namespace
from . import rosenbrock


class GasKernel:
    def __init__(self, mech: Mechanism, dtype=torch.float64, device="cuda"):
        self.mech = mech
        self.dtype = dtype
        self.device = resolve_device(device)
        self.nvar = mech.nvar
        self.nfix = len(mech.fixed)
        self.stoich = torch.as_tensor(mech.stoich, dtype=dtype,
                                      device=self.device)   # [nrxn, nvar]
        self.ridx = torch.as_tensor(mech.ridx, dtype=torch.long,
                                    device=self.device)     # [nrxn, 3]
        self.block = BlockArrowSolver(mech, dtype=dtype, device=self.device)
        # integrate's CUDA graphs: {key: (GraphedLoop, k buffer, fix buffer)}
        self._graphs = {}

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

    def kw_weights(self, y, k, fix):
        """Per-slot Jacobian weights kwcat [B, 3*nrxn]:
        kw_l[r] = k_r * product of the other reactant concentrations
        (the quantity every Jacobian entry is linear in)."""
        cr = self._cr(self._cx(y, fix))
        p0, p1, p2 = cr[..., 0], cr[..., 1], cr[..., 2]
        return torch.cat((k * p1 * p2, k * p0 * p2, k * p0 * p1), dim=-1)

    # ------------------------------------------------------------------
    def integrate(self, y0, k, fix, dt,
                  opts: rosenbrock.RosOptions = rosenbrock.RosOptions()):
        """Advance the batch of cells by dt seconds.

        On a CUDA device the loop replays CUDA graphs
        (``rosenbrock.GraphedLoop``): one set per batch shape, dtype, dt
        and options, captured at the first such call and kept on the
        kernel; each call copies k and fix into the set's buffers.
        Elsewhere it runs op by op (``rosenbrock.integrate``)."""
        if y0.device.type != "cuda":
            return rosenbrock.integrate(*self._problem(k, fix), y0, dt, opts)
        key = (tuple(y0.shape), y0.dtype, tuple(k.shape), k.dtype,
               tuple(fix.shape), fix.dtype, y0.device, float(dt), opts)
        if key not in self._graphs:
            k_s, fix_s = (torch.empty_like(
                x, memory_format=torch.contiguous_format) for x in (k, fix))
            self._graphs[key] = (rosenbrock.GraphedLoop(
                *self._problem(k_s, fix_s), y0, float(dt), opts), k_s, fix_s)
        loop, k_s, fix_s = self._graphs[key]
        k_s.copy_(k)
        fix_s.copy_(fix)
        return loop.run(y0)

    def _problem(self, k, fix):
        """Ros3's (fun, linop) for rate constants k and fixed species fix:
        the tendencies and the block-arrow solver."""
        block = self.block
        linop = SimpleNamespace(
            jac=lambda y: block.assemble(self.kw_weights(y, k, fix)),
            prepare=block.prepare, solve=block.solve, phases=block.phases,
            invert=block.invert)
        return (lambda y: self.fun(y, k, fix)), linop


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
