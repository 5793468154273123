"""Block-arrow stage solver for the multiphase (aer/tot) mechanisms.

Port of ``mistra_tpu/chemistry/block_solver.py``.  The aqueous bins never
couple to each other chemically (the cloned master_aqueous.eqn reacts only
within a bin and exchanges with the gas phase), so in the species order
[bin1.., bin2.., .., gas..] the stage matrix is block-arrow:

    [ A11            A1g ]
    [      A22       A2g ]        A_ff: ma x ma dense per aqueous bin
    [           ..    .. ]        A_fg/A_gf: thin gas-coupling panels
    [ Ag1  Ag2  ..   Agg ]        Agg: mg x mg gas core

The stage solve is dense-block algebra: one batched inverse over all
(cell, bin) diagonal blocks, a Schur complement onto the gas core, a
second inverse there, and batched matmul/matvec solves.  The inverses go
through ``lu.batched_inv`` (the hand-written CUDA kernel for CUDA tensors,
the plain torch version on the CPU); the products are ``torch.einsum``, as
the JAX package leaves them to XLA.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils import resolve_device
from .lu import batched_inv


class BlockFactors(NamedTuple):
    """``prepare``'s factorization of R*(ghinv*I - J): the inverses and
    the products the solve needs (first four, in the JAX package's
    order), the row scales, the scaled blocks, and the Schur complement
    ``s`` whose inverse is ``inv_s``."""
    inv_a: torch.Tensor     # [B, nb, ma, ma]
    gmat: torch.Tensor      # [B, nb, mg, ma]  Agb_f inv(A_f)
    hmat: torch.Tensor      # [B, nb, ma, mg]  inv(A_f) Abg_f
    inv_s: torch.Tensor     # [B, mg, mg]
    r_aq: torch.Tensor      # [B, nb, ma]
    r_g: torch.Tensor       # [B, mg]
    abb: torch.Tensor
    agb: torch.Tensor
    abg: torch.Tensor
    agg: torch.Tensor
    s: torch.Tensor         # [B, mg, mg]


class BlockArrowSolver:
    """Stage-matrix solver  (ghinv*I - J) x = b  for binned mechanisms.

    Implements the rosenbrock.py linop protocol (prepare/solve); the
    Jacobian context is the tuple of dense block arrays from ``assemble``.
    """

    def __init__(self, mech, dtype=torch.float32, device="cuda"):
        self.mech = mech
        self.dtype = dtype
        self.device = resolve_device(device)
        blk = np.asarray(mech.species_bin[:mech.nvar])
        bins = sorted(b for b in set(blk.tolist()) if b != 0)
        self.nbin = len(bins)
        self.nvar = mech.nvar
        bin_idx = [np.nonzero(blk == b)[0] for b in bins]
        gas_idx = np.nonzero(blk == 0)[0]
        self.ma = max(len(ix) for ix in bin_idx)     # padded bin width
        self.mg = len(gas_idx)
        nb, ma, mg = self.nbin, self.ma, self.mg

        def dev(x, dt=None):
            return torch.as_tensor(x, dtype=dt, device=self.device)

        # species -> (category, row) maps; padded rows stay unmapped
        pos = np.zeros(self.nvar, np.int64)          # row within block
        cat = np.zeros(self.nvar, np.int64)          # 0..nb-1 aq, nb gas
        for f, ix in enumerate(bin_idx):
            pos[ix] = np.arange(len(ix))
            cat[ix] = f
        pos[gas_idx] = np.arange(len(gas_idx))
        cat[gas_idx] = nb

        # padded solution vector layout: [nb*ma aqueous | mg gas]
        vpos = np.where(cat < nb, cat * ma + pos, nb * ma + pos)
        self._vpos = vpos                            # old -> padded slot
        npad = nb * ma + mg
        self.npad = npad
        # gather map padded -> old (padded holes read a trailing zero)
        g2o = np.full(npad, self.nvar, np.int64)
        g2o[vpos] = np.arange(self.nvar)
        self._pad_gather = dev(g2o)
        self._out_gather = dev(vpos)                 # padded -> out order

        # ---- Jacobian term lists per storage category -----------------
        # flat dense storage: [bb | gb | bg | gg] concatenated
        off_bb = 0
        off_gb = nb * ma * ma
        off_bg = off_gb + nb * mg * ma
        off_gg = off_bg + nb * ma * mg
        self.flat_size = off_gg + mg * mg
        self._offs = (off_bb, off_gb, off_bg, off_gg)

        st = np.asarray(mech.stoich)
        ridx = np.asarray(mech.ridx)
        nrxn, nvar = st.shape
        lr_list, coeff_list, tgt_list = [], [], []
        for r in range(nrxn):
            outs = np.nonzero(st[r])[0]
            for l in range(ridx.shape[1]):
                j = int(ridx[r, l])
                if j >= nvar:
                    continue
                cj, pj = int(cat[j]), int(pos[j])
                for i in outs:
                    ci, pi = int(cat[i]), int(pos[i])
                    if ci < nb and cj < nb and ci != cj:
                        raise ValueError(
                            f"cross-bin Jacobian entry {i},{j}")
                    if ci < nb and cj < nb:          # aqueous diag block
                        t = off_bb + (ci * ma + pi) * ma + pj
                    elif ci == nb and cj < nb:       # gas rows, aq cols
                        t = off_gb + (cj * mg + pi) * ma + pj
                    elif ci < nb and cj == nb:       # aq rows, gas cols
                        t = off_bg + (ci * ma + pi) * mg + pj
                    else:                            # gas core
                        t = off_gg + pi * mg + pj
                    lr_list.append(l * nrxn + r)
                    coeff_list.append(float(st[r, i]))
                    tgt_list.append(t)
        tgt = np.asarray(tgt_list, np.int64)
        order = np.argsort(tgt, kind="stable")
        tgt = tgt[order]
        self._term_lr = dev(np.asarray(lr_list, np.int64)[order])
        self._term_coeff = dev(np.asarray(coeff_list)[order], dtype)
        self._term_tgt = dev(tgt)
        # deterministic segment sum: the terms are sorted by target, so
        # round q adds the q-th term of every target that has one; within
        # a round the targets are distinct (no atomics, no duplicate
        # indices) and each target sums its terms in the sorted order
        start = np.searchsorted(tgt, tgt, side="left")
        rank = np.arange(len(tgt)) - start
        self._rounds = []
        for q in range(int(rank.max()) + 1 if len(tgt) else 0):
            sel = np.nonzero(rank == q)[0]
            self._rounds.append((dev(sel), dev(tgt[sel])))

        # identity masks for adding ghinv on the real (unpadded) diag;
        # padded diagonal entries get plain 1.0 so the block stays
        # invertible and the padded rows remain decoupled
        bbdiag = np.zeros((nb, ma, ma))
        bbpad = np.zeros((nb, ma, ma))
        for f, ix in enumerate(bin_idx):
            w = len(ix)
            bbdiag[f, :w, :w] = np.eye(w)
            if w < ma:
                bbpad[f, w:, w:] = np.eye(ma - w)
        self._bb_eye = dev(bbdiag, dtype)
        self._bb_pad = dev(bbpad, dtype)
        self._gg_eye = dev(np.eye(mg), dtype)

    # ------------------------------------------------------------------
    def assemble(self, kwcat):
        """Dense block arrays from the per-reaction-slot weights.

        kwcat: [B, 3*nrxn] with kw_l[r] = k_r * prod of the *other*
        reactant concentrations for slot l (gas_kernel.kw_weights).
        Returns (Jbb [B,nb,ma,ma], Jgb [B,nb,mg,ma], Jbg [B,nb,ma,mg],
        Jgg [B,mg,mg]).
        """
        B = kwcat.shape[0]
        vals = self._term_coeff[None, :] * kwcat[:, self._term_lr]
        flat = torch.zeros((B, self.flat_size), dtype=kwcat.dtype,
                           device=kwcat.device)
        for sel, tgt in self._rounds:
            flat[:, tgt] = flat[:, tgt] + vals[:, sel]
        nb, ma, mg = self.nbin, self.ma, self.mg
        o_bb, o_gb, o_bg, o_gg = self._offs
        jbb = flat[:, o_bb:o_gb].reshape(B, nb, ma, ma)
        jgb = flat[:, o_gb:o_bg].reshape(B, nb, mg, ma)
        jbg = flat[:, o_bg:o_gg].reshape(B, nb, ma, mg)
        jgg = flat[:, o_gg:].reshape(B, mg, mg)
        return jbb, jgb, jbg, jgg

    @staticmethod
    def _row_scale(m):
        """Power-of-2 reciprocal of a row-magnitude bound, 2^-floor(log2 m)
        (exact in any binary float; 1.0 for empty/padded rows).  The
        exponent comes from frexp, m = mant * 2^e with mant in [0.5, 1)."""
        safe = torch.where(m > 0.0, m, 1.0)
        _, e = torch.frexp(safe)
        return torch.exp2((1 - e).to(m.dtype))

    def prepare(self, jac_ctx, ghinv) -> BlockFactors:
        """Factorize R*(ghinv*I - J).

        R is a per-row power-of-2 equilibration: aqueous equilibrium
        rate constants reach ~1e27 in mol/m3 units (kef/keb,
        kpp.f90:2954-3369), so raw stage-matrix entries hit ~1e18 and
        their elimination products overflow float32.  Scaling rows to
        O(1) changes no solution.
        """
        jbb, jgb, jbg, jgg = jac_ctx
        B = jbb.shape[0]
        nb, ma, mg = self.nbin, self.ma, self.mg
        g = ghinv[:, None, None, None]
        abb = (g * self._bb_eye[None] + self._bb_pad[None]) - jbb
        agb = -jgb
        abg = -jbg
        agg = ghinv[:, None, None] * self._gg_eye[None] - jgg

        # row equilibration over the FULL system row (diag + coupling)
        r_aq = self._row_scale(torch.maximum(
            abb.abs().amax(dim=-1), abg.abs().amax(dim=-1)))  # [B, nb, ma]
        r_g = self._row_scale(torch.maximum(
            agg.abs().amax(dim=-1), agb.abs().amax(dim=(1, 3))))  # [B, mg]
        abb = abb * r_aq[..., None]
        abg = abg * r_aq[..., None]
        agb = agb * r_g[:, None, :, None]
        agg = agg * r_g[..., None]

        inv_a = batched_inv(abb.reshape(B * nb, ma, ma)).reshape(
            B, nb, ma, ma)
        # G_f = Agb_f inv(A_f);  Schur S = Agg - sum_f G_f Abg_f
        gmat = torch.einsum("bfij,bfjk->bfik", agb, inv_a)
        s = agg - torch.einsum("bfij,bfjk->bik", gmat, abg)
        inv_s = batched_inv(s.contiguous())
        hmat = torch.einsum("bfij,bfjk->bfik", inv_a, abg)
        return BlockFactors(inv_a, gmat, hmat, inv_s, r_aq, r_g,
                            abb, agb, abg, agg, s)

    def _apply_scaled(self, fact, xb, xg):
        """y = A' x for the row-scaled system (block matvecs)."""
        yb = (torch.einsum("bfij,bfj->bfi", fact.abb, xb)
              + torch.einsum("bfij,bj->bfi", fact.abg, xg))
        yg = (torch.einsum("bij,bj->bi", fact.agg, xg)
              + torch.einsum("bfij,bfj->bi", fact.agb, xb))
        return yb, yg

    def _solve_scaled(self, fact, rb, rg):
        tb = torch.einsum("bfij,bfj->bfi", fact.inv_a, rb)
        yg = rg - torch.einsum("bfij,bfj->bi", fact.gmat, rb)
        xg = torch.einsum("bij,bj->bi", fact.inv_s, yg)
        xb = tb - torch.einsum("bfij,bj->bfi", fact.hmat, xg)
        return xb, xg

    def solve(self, fact: BlockFactors, rhs, refine: int = 1):
        """x = (ghinv*I - J)^{-1} rhs via the block factorization, with
        one pass of iterative refinement by default (a single correction
        takes the residual of the block inverse from O(cond*eps) to
        rounding level, which spares the stiff integrator rejections)."""
        B = rhs.shape[0]
        nb, ma = self.nbin, self.ma
        rhs_z = torch.cat([rhs, rhs.new_zeros((B, 1))], dim=-1)
        rp = rhs_z[:, self._pad_gather]
        rb = rp[:, :nb * ma].reshape(B, nb, ma) * fact.r_aq
        rg = rp[:, nb * ma:] * fact.r_g
        xb, xg = self._solve_scaled(fact, rb, rg)
        for _ in range(refine):
            ab, ag = self._apply_scaled(fact, xb, xg)
            db, dg = self._solve_scaled(fact, rb - ab, rg - ag)
            xb = xb + db
            xg = xg + dg
        xp = torch.cat([xb.reshape(B, nb * ma), xg], dim=-1)
        return xp[:, self._out_gather]
