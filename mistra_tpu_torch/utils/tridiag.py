"""Implicit vertical diffusion solves (Thomas algorithm) over a column batch.

Torch counterpart of ``mistra_tpu.utils.tridiag``.  Layout is ``[B, n, ...]``:
B independent columns, n levels, any trailing field axes (several
prognostic fields, or the nkt*nka microphysics bins) solved in one sweep.
The two ``lax.scan`` recurrences become Python loops over the levels; each
step is one batched tensor operation over columns and fields.
"""

from __future__ import annotations

import torch


def diffusion_coefficients(atk, detw, deta, dt):
    """Implicit-diffusion coefficients; atk [B, n], detw/deta [n].

    xa[k] = atk[k]*dt/(detw[k]*deta[k]); xc[k] = xa[k-1]*detw[k-1]/detw[k]
    (xc[0] = 0, unused).  Returns (xa, xc), each [B, n].
    """
    xa = atk * dt / (detw * deta)
    xc = torch.cat([torch.zeros_like(xa[:, :1]),
                    xa[:, :-1] * detw[:-1] / detw[1:]], dim=1)
    return xa, xc


def _bc(v, like):
    """Per-column [B] values as [B, 1, ...], broadcastable against like."""
    return v.reshape(v.shape + (1,) * (like.dim() - 1))


def implicit_sweep(xa, xc, fields, rhs=None, bottom=None):
    """Solve (I + D) x = rhs with Dirichlet BCs at both ends.

    xa, xc: [B, n].  fields: [B, n, ...]; fields[:, 0] and fields[:, n-1]
    are the boundary values and are returned unchanged.  rhs defaults to
    fields.  bottom ([B, ...]) overrides the bottom value entering the
    forward sweep.  Returns the updated [B, n, ...] fields.
    """
    if rhs is None:
        rhs = fields
    n = fields.shape[1]
    xb = 1.0 + xa + xc

    # forward sweep over k = 1 .. n-2
    f = fields[:, 0] if bottom is None else bottom
    e = torch.zeros_like(xa[:, 0])
    es, fs = [], []
    for k in range(1, n - 1):
        d = xb[:, k] - xc[:, k] * e
        e = xa[:, k] / d
        f = (rhs[:, k] + _bc(xc[:, k], f) * f) / _bc(d, f)
        es.append(e)
        fs.append(f)

    # backward substitution over k = n-2 .. 1
    x = fields[:, n - 1]
    xs = [None] * (n - 2)
    for j in range(n - 3, -1, -1):
        x = _bc(es[j], x) * x + fs[j]
        xs[j] = x
    return torch.cat([fields[:, :1], torch.stack(xs, dim=1),
                      fields[:, n - 1:]], dim=1)


def subsidence(fields, c):
    """Explicit upwind large-scale subsidence update.

    f[k] -= c[k]*(f[k+1]-f[k]) for k = 1..n-2; fields [B, n, ...],
    c [B, n] broadcast over trailing dims.
    """
    cb = c.reshape(c.shape + (1,) * (fields.dim() - 2))
    upd = fields[:, 1:-1] - cb[:, 1:-1] * (fields[:, 2:] - fields[:, 1:-1])
    return torch.cat([fields[:, :1], upd, fields[:, -1:]], dim=1)
