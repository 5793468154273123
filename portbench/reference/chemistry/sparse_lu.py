# Frozen copy of mistra_tpu_torch/chemistry/sparse_lu.py (lines 1-187, commit b2518445).
"""Static-structure sparse LU for the chemistry Jacobians, batched over
cells.

The reference's KPP output factorizes I/(h*gamma) - J with a pivot-free
Doolittle elimination over a fixed symbolic structure (``KppDecomp_g``
gas.f:6142-6177, structure from ``gas_Sparse.h`` LU_CROW/ICOL/DIAG) and
fully unrolled triangular solves (``KppSolve_g`` gas.f:6206+).  Dense
batched LU with partial pivoting costs ~68 ms per Rosenbrock iteration on
TPU at [2048, 102, 102]; the mechanism matrix is ~1% dense, so this
module reproduces the KPP design the TPU way:

* symbolic analysis on the host (numpy): Jacobian pattern from the
  stoichiometry, greedy minimum-degree ordering (KPP relies on its own
  species ordering), symbolic fill-in, and a flat elimination schedule;
* the factorization/solve are *unrolled at trace time* into pure
  elementwise ops on [B]-shaped value slots, so the whole Rosenbrock
  stage becomes one fused VPU loop over the cell batch — no gathers, no
  pivoting, no [B, n, n] materialization.

A copy of ``mistra_tpu/chemistry/sparse_lu.py``: the numerics work on
lists of [B] torch tensors as written.  In PyTorch every slot operation
is one eager launch, so this path suits small (gas-only) mechanisms.
"""

from __future__ import annotations

import numpy as np


class SparseLU:
    """Symbolic no-pivot LU of a sparse pattern, batched numeric kernels.

    Attributes:
      perm: [n] column/row permutation (new order -> old index).
      pattern: set of (i, j) in PERMUTED coordinates incl. fill-in.
      slots: {(i, j): slot} mapping to the packed value vector.
      schedule: elimination ops, list of ("div", kj, jj) and
                ("sub", kl, kj, jl) in slot indices, in execution order.
    """

    def __init__(self, pattern_ij, n, order=True):
        self.n = n
        base = set(map(tuple, pattern_ij))
        for i in range(n):
            base.add((i, i))
        self.perm = self._min_degree_order(base, n) if order \
            else np.arange(n)
        inv = np.empty(n, np.int64)
        inv[self.perm] = np.arange(n)
        pat = {(inv[i], inv[j]) for (i, j) in base}
        # symbolic fill-in (up-looking row elimination)
        rows = [sorted(j for (i, j) in pat if i == r) for r in range(n)]
        cols_of = [set(r) for r in rows]
        for k in range(n):
            for i in range(k + 1, n):
                if k in cols_of[i]:
                    cols_of[i] |= {j for j in cols_of[k] if j > k}
        self.pattern = {(i, j) for i in range(n) for j in cols_of[i]}
        # packed slot order: row-major (KPP's LU_CROW layout)
        entries = sorted(self.pattern)
        self.slots = {ij: s for s, ij in enumerate(entries)}
        self.entries = entries
        self.nnz = len(entries)
        # elimination schedule (Doolittle ikj form, KppDecomp loop shape)
        sched = []
        for i in range(1, n):
            ks = sorted(j for j in cols_of[i] if j < i)
            for k in ks:
                ik = self.slots[(i, k)]
                kk = self.slots[(k, k)]
                sched.append(("div", ik, kk))
                for j in sorted(cols_of[k]):
                    if j > k:
                        sched.append(("sub", self.slots[(i, j)], ik,
                                      self.slots[(k, j)]))
        self.schedule = sched

    @staticmethod
    def _min_degree_order(pattern, n):
        """Greedy minimum-degree (Markowitz) ordering on the symmetrized
        pattern; returns perm with perm[new] = old."""
        adj = [set() for _ in range(n)]
        for (i, j) in pattern:
            if i != j:
                adj[i].add(j)
                adj[j].add(i)
        alive = set(range(n))
        perm = []
        deg = {v: len(adj[v]) for v in alive}
        while alive:
            v = min(alive, key=lambda x: (deg[x], x))
            perm.append(v)
            alive.remove(v)
            nbrs = [u for u in adj[v] if u in alive]
            for a in nbrs:
                adj[a].discard(v)
            # clique the neighbours (elimination graph update)
            for ai in range(len(nbrs)):
                for bi in range(ai + 1, len(nbrs)):
                    a, b = nbrs[ai], nbrs[bi]
                    if b not in adj[a]:
                        adj[a].add(b)
                        adj[b].add(a)
            for a in nbrs:
                deg[a] = len(adj[a])
        return np.asarray(perm, np.int64)

    # ------------------------------------------------------------------
    def decompose(self, vals):
        """Run the elimination schedule on a list of [B] value arrays
        (one per slot, permuted coordinates).  Mutates and returns it."""
        for op in self.schedule:
            if op[0] == "div":
                _, ik, kk = op
                vals[ik] = vals[ik] / vals[kk]
            else:
                _, ij, ik, kj = op
                vals[ij] = vals[ij] - vals[ik] * vals[kj]
        return vals

    def solve(self, vals, b):
        """Triangular solves L y = b; U x = y.  b: list of n [B] arrays
        (permuted).  Returns list of n [B] arrays (permuted)."""
        n = self.n
        y = list(b)
        for i in range(1, n):
            for j in range(i):
                s = self.slots.get((i, j))
                if s is not None:
                    y[i] = y[i] - vals[s] * y[j]
        x = y
        for i in range(n - 1, -1, -1):
            for j in range(i + 1, n):
                s = self.slots.get((i, j))
                if s is not None:
                    x[i] = x[i] - vals[s] * x[j]
            x[i] = x[i] / vals[self.slots[(i, i)]]
        return x


def sparse_jac_terms(mech, slu):
    """Per-LU-slot Jacobian assembly lists.

    Returns terms: {slot: [(l, r, coeff), ...]} so that, given the
    per-reaction-slot weights kw[l][:, r] (= k_r * product of the other
    reactant concentrations, as gas_kernel.jac builds them),
    J_slot = sum coeff * kw[l][:, r].  Slots are in the PERMUTED LU
    coordinates; fill-in slots get empty lists.
    """
    nvar = mech.nvar
    ridx = np.asarray(mech.ridx)
    st = np.asarray(mech.stoich)
    perm = slu.perm
    inv = np.empty(nvar, np.int64)
    inv[perm] = np.arange(nvar)
    terms = {s: [] for s in range(slu.nnz)}
    nrxn = st.shape[0]
    for r in range(nrxn):
        outs = np.nonzero(st[r])[0]
        for l in range(ridx.shape[1]):
            j = int(ridx[r, l])
            if j >= nvar:
                continue
            for i in outs:
                slot = slu.slots.get((int(inv[i]), int(inv[j])))
                if slot is None:
                    raise KeyError(f"missing LU slot for J[{i},{j}]")
                terms[slot].append((l, r, float(st[r, i])))
    return terms


def jac_pattern_from_mech(mech):
    """Jacobian sparsity (i, j): dF_i/dy_j != 0 from the packed mechanism
    stoichiometry (variable-species reactant slots only)."""
    nvar = mech.nvar
    pat = set()
    ridx = mech.ridx
    st = mech.stoich
    for r in range(st.shape[0]):
        reac = [int(c) for c in ridx[r] if c < nvar]
        outs = np.nonzero(st[r])[0]
        for j in reac:
            for i in outs:
                pat.add((int(i), int(j)))
            for i in reac:
                pat.add((int(i), int(j)))
    return pat
