# Frozen copy of mistra_tpu_torch/physics/microphysics.py (lines 1-127, commit b2518445).
"""Koehler equilibrium of the 2-D spectral bin microphysics over a column
batch (torch counterpart of ``mistra_tpu.physics.microphysics``).

Reference parity: ``rgl`` (str.f90:2164-2255) Newton iteration for the
equilibrium radius, ``equil`` (str.f90:4801-4981) redistribution of each dry
bin's particles onto the equilibrium water bin.  The spectrum is
``ff [B, nkt, nka, n]``.
"""

from __future__ import annotations

import torch

from ..constants import PI, RHO3, RHOW
from ..parallel.bins import BinShard

ZRHO_FRAC = RHO3 / RHOW
Z4PI3 = 4.0e-9 * PI / 3.0
FEU_MAX = 0.99999
RGL_ITERS = 100


def rgl(r_dry, a, b, feu):
    """Equilibrium particle radius at relative humidity feu (< 1).

    Newton iteration on x = r/r_dry solving
    (x^3-1)(x ln rH - a/r_dry) + b x = 0, broadcast over all inputs, with
    the reference's fixed 100-iteration bound and 1e-7 relative tolerance
    as a masked loop (converged entries are frozen).
    """
    r_dry, a, b, feu = torch.broadcast_tensors(r_dry, a, b, feu)
    feu_safe = torch.clamp(feu, max=1.0 - 1.0e-12)
    zlogf = torch.log(feu_safe)
    alpha = a / r_dry
    x = torch.exp(feu_safe)
    done = torch.zeros_like(x, dtype=torch.bool)
    for _ in range(RGL_ITERS):
        falt = (x ** 3 - 1.0) * (x * zlogf - alpha) + b * x
        fstralt = (4.0 * x ** 3 - 1.0) * zlogf - 3.0 * x ** 2 * alpha + b
        xneu = x - falt / fstralt
        new_done = done | (torch.abs(xneu - x) < 1.0e-7 * x)
        x = torch.where(done, x, xneu)
        done = new_done
    r_eq = r_dry * x
    # at/above saturation the reference returns the dry radius
    return torch.where(feu >= 1.0, r_dry, r_eq)


def _level_mask(mask):
    """An [n] or [B, n] level mask, broadcast against ff [B, nkt, nka, n]."""
    return mask[None, None, None, :] if mask.dim() == 1 \
        else mask[:, None, None, :]


def equil_redistribute(ff, t, feu, micro_grid, a0m, b0m, level_mask,
                       collapse=True):
    """Place each dry bin's particles at the Koehler equilibrium water bin.

    ff [B, nkt, nka, n]; t, feu [B, n]; micro_grid holds the [nka]/[nkt]
    arrays rn, ew, e (taken in ff's dtype and device, a no-op for tensors
    already there); b0m [nka]; level_mask [n] or [B, n].
    Returns (ff_new, xm2_eq [B, n]), xm2_eq summed over ff's dry bins
    (a shard's partial sum where ff holds part of the axis).
    """
    def cv(x):
        return torch.as_tensor(x, dtype=ff.dtype, device=ff.device)

    rn, ew, e = cv(micro_grid.rn), cv(micro_grid.ew), cv(micro_grid.e)
    b0 = cv(b0m) * ZRHO_FRAC
    nkt = ff.shape[1]

    total = ff.sum(dim=1) if collapse else ff[:, 0]      # [B, nka, n]

    a0 = a0m / t                                          # [B, n]
    # equilibrium radius per (column, ia, level)
    rg = rgl(rn[None, :, None], a0[:, None, :], b0[None, :, None],
             feu[:, None, :])
    eg = Z4PI3 * (rg ** 3 - rn[None, :, None] ** 3)       # water mass [mg]

    # first water bin with ew[jt] >= eg (reference: while eg > ew(jt))
    jt = (ew < eg[..., None]).sum(dim=-1)
    jt = torch.clamp(jt, 0, nkt - 1)                      # [B, nka, n]

    bins = torch.arange(nkt, device=ff.device)[None, :, None, None]
    one_hot = (jt[:, None] == bins).to(ff.dtype)          # [B, nkt, nka, n]
    ff_eq = one_hot * total[:, None]

    ff_new = torch.where(_level_mask(level_mask), ff_eq, ff)
    xm2_eq = torch.einsum("btan,t->bn", ff_new, e)
    return ff_new, xm2_eq


def equil(met, micro, micro_grid, a0m, b0m, ncase, nf, level=None,
          bins=None):
    """Reference-equivalent equil(ncase[, kk]) over a column batch.

    ncase 0: levels 1..n-1 at initialisation (clamps feu state to 0.99999).
    ncase 1: single ``level``.
    ncase 2: levels nf..n-1.
    ``bins`` (a ``parallel.bins.BinShard``, the whole axis by default)
    says which dry bins ff holds; the sums over the bins (xm2, fsum) take
    one all_reduce over the tp ranks.
    Returns (met', micro').
    """
    n = met.t.shape[1]
    k = torch.arange(n, device=met.t.device)
    if ncase == 0:
        mask = k >= 1
        feu = torch.where(mask, torch.clamp(met.feu, max=FEU_MAX), met.feu)
        met = met.replace(feu=feu)
        collapse = False
    elif ncase == 1:
        mask = k == level
        collapse = True
    elif ncase == 2:
        mask = k >= nf
        collapse = True
    else:
        raise ValueError("ncase must be 0, 1 or 2")

    ff_new, xm2_eq = equil_redistribute(micro.ff, met.t, met.feu, micro_grid,
                                        a0m, b0m, mask, collapse=collapse)
    bins = BinShard(ff_new.shape[2]) if bins is None else bins
    xm2_eq, fsum_eq = bins.sum_bins(xm2_eq, ff_new.sum(dim=(1, 2)))
    xm2 = torch.where(mask, xm2_eq, met.xm2)
    fsum = torch.where(mask, fsum_eq, micro.fsum)
    return met.replace(xm2=xm2), micro.replace(ff=ff_new, fsum=fsum)
