# Frozen copy of mistra_tpu_torch/chemistry/lu.py (lines 1-78, commit b2518445), with the inverse's routing replaced: plain on the CPU, torch.linalg.inv on a card.
"""Batched dense inverse of the block-arrow stage solver.

Counterpart of ``mistra_tpu/chemistry/lu_pallas.py``.  The JAX package
inverts its diagonal blocks with a no-pivot Doolittle LU and an explicit
inverse, as two Pallas TPU kernels (``_lu_kernel``, ``_inv_kernel``) for
float32 on a TPU, and with a pivoted inverse everywhere else
(``jnp.linalg.inv``, or the Gauss-Jordan scan ``_inv_gj_pivot`` in
float64 on a TPU).  The port has one algorithm for both dtypes:
Gauss-Jordan with partial (row) pivoting.

* ``batched_inv_plain``: the plain torch version, counterpart of
  ``_inv_gj_pivot``; the CPU path and the reference the kernel is held
  against.
* ``lu_cuda.batched_inv``: the hand-written CUDA kernel
  (``csrc/lu.cu``), which replaces both Pallas kernels: one block per
  matrix, the matrix in registers up to m = 128 and in shared memory
  above (``lu_cuda.launch_plan``).
* ``batched_inv``: the router, as ``physics.growth`` routes the Bott
  kernels: a CUDA tensor goes to the kernel, a CPU tensor to the plain
  version, and any other device raises.
"""

from __future__ import annotations

import torch



def batched_inv_plain(a: torch.Tensor) -> torch.Tensor:
    """inv(A) for [N, m, m] by Gauss-Jordan with partial pivoting.

    Step k takes as pivot the row p with the largest |a[., k]| among the
    rows not yet used (the first such row on a tie), scales it by the
    pivot and eliminates column k from every other row.  The work is done
    in place on one [N, m, m] array: column k, once eliminated, holds the
    column of the inverse that the augmented form [A | I] would carry in
    its right half (right column p), so
    ``inv[k, p_j] = c[p_k, j]`` undoes the row permutation at the end.
    The arithmetic, operation by operation, is that of the CUDA kernel:
    new pivot row c[p, j] / piv, with 1 / piv at column k; every other
    row c[i, j] - f_i * row[j], with f_i = c[i, k] and c[i, k] read as 0.
    A zero pivot gives non-finite output; it is not an error.
    """
    n, m, m2 = a.shape
    if m != m2:
        raise ValueError(f"batched_inv takes [N, m, m], got {tuple(a.shape)}")
    c = a.clone()
    rows = torch.arange(n, device=a.device)
    used = torch.zeros((n, m), dtype=torch.bool, device=a.device)
    perm = torch.empty((n, m), dtype=torch.long, device=a.device)
    for k in range(m):
        col = c[:, :, k].clone()
        cand = torch.where(used, -1.0, col.abs())
        p = torch.argmax(cand, dim=1)                     # first maximum
        piv = col[rows, p]
        c[:, :, k] = 0.0
        rowp = c[rows, p, :] / piv[:, None]
        rowp[:, k] = 1.0 / piv
        col[rows, p] = 0.0
        c = c - col[:, :, None] * rowp[:, None, :]
        c[rows, p, :] = rowp
        used[rows, p] = True
        perm[:, k] = p
    # r[k, j] = c[p_k, j]; inv[k, p_j] = r[k, j]
    r = torch.gather(c, 1, perm[:, :, None].expand(n, m, m))
    return torch.empty_like(c).scatter_(2, perm[:, None, :].expand(n, m, m),
                                        r)


def batched_inv(a: torch.Tensor) -> torch.Tensor:
    """Inverse of every matrix of a [N, m, m]: the plain pivoted
    Gauss-Jordan on the CPU; on a card, ``torch.linalg.inv`` (pivoted LU,
    the library's), since the plain elimination's m launches per call
    would make the reference outlast the measured window."""
    if a.device.type == "cpu":
        return batched_inv_plain(a)
    return torch.linalg.inv(a)
