"""Aqueous-phase support physics of the gas-phase path, in torch.

Port of the part of ``mistra_tpu/chemistry/aqueous.py`` that the
gas-phase chemistry driver calls (all kpp.f90):

- ``bin_masks``: the static (nkt, nka, nkc) membership of the 2-D
  particle spectrum in the 4 chemistry bins (host numpy, a copy);
- ``dry_aerosol_rates`` (``dry_cw_rc``/``dry_rates_g``, :4580-5203): het
  chemistry on dry aerosol, batched over columns.

The rest of the liq_parm stack (``cw_rc``, sticking coefficients, mean
speeds, inverse Henry constants, ``fast_k_mt``, ``equil_constants``)
serves the multiphase driver only and is not ported yet (ROADMAP queue 1,
the multiphase drivers).
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import PI
from .driver import henry_molar


def bin_masks(micro_grid):
    """Static (nkt, nka, nkc) membership tensor of the 4 chemistry bins."""
    ka = micro_grid.ka
    kw = np.asarray(micro_grid.kw)
    nka = kw.shape[0]
    nkt = micro_grid.ew.shape[0]
    ia = np.arange(nka)[None, :]
    jt = np.arange(nkt)[:, None]
    small_a = ia < ka           # dry bins 1..ka (0-based < ka)
    small_t = jt < kw[None, :]  # water bins 1..kw(ia)
    masks = np.stack([
        small_a & small_t,            # bin 1: small aerosol
        (~small_a) & small_t,         # bin 2: large aerosol
        small_a & (~small_t),         # bin 3: small droplets
        (~small_a) & (~small_t),      # bin 4: large droplets
    ], axis=-1).astype(np.float64)
    return masks


def dry_aerosol_rates(ff, t, masks, rq, freep):
    """Het-on-dry-aerosol stack of B columns (dry_cw_rc + dry_rates_g).

    ff [B, nkt, nka, n]; t, freep [B, n]; masks [nkt, nka, nkc] and rq
    [nkt, nka] tensors of ff's dtype.  Returns dict with xkmtd (species ->
    [B, 2, n]) for HNO3/N2O5/NH3/H2SO4, henry_dry (species -> [B, n]),
    xeq_hno3 [B, n] and the dry LWC/radius cwd, rcd [B, 2, n] of the two
    aerosol bins.
    """
    m = masks[:, :, :2]                          # aerosol bins only
    vol = 4.0 / 3.0 * PI * rq ** 3
    cwd_raw = torch.einsum("btkn,tkc->bcn", ff, vol[..., None] * m)
    rcd_raw = torch.einsum("btkn,tkc->bcn", ff, (vol * rq)[..., None] * m)
    rcd = torch.where(cwd_raw > 0.0,
                      rcd_raw / torch.clamp(cwd_raw, min=1e-300) * 1.0e-6,
                      0.0)
    cwd = cwd_raw * 1.0e-12

    zgamma = {"HNO3": 0.02, "N2O5": 0.02, "NH3": 0.05, "H2SO4": 0.1}
    vmean_c = {"HNO3": 6.3e-2, "N2O5": 1.08e-1, "NH3": 1.7e-2,
               "H2SO4": 9.8e-2}
    xkmtd = {}
    for name in ("HNO3", "N2O5", "NH3", "H2SO4"):
        zv = torch.sqrt(t / vmean_c[name]) * 4.60138
        g = zgamma[name]
        x1 = torch.where(rcd > 0.0,
                         1.0 / (torch.clamp(rcd, min=1e-300)
                                * (rcd / freep[:, None, :]
                                   + 4.0 / (3.0 * g))),
                         0.0)
        xkmtd[name] = zv[:, None, :] * x1            # [B, 2, n]

    xeq_hno3 = 1.54e1 * torch.exp(8700.0 * (1.0 / t - 3.354e-3))
    fct = 0.0820577 * t
    h_hno3_molar = (2.5e6 / torch.clamp(xeq_hno3, min=1e-300)) \
        * torch.exp(8694.0 * (1.0 / t - 3.3557e-3))
    henry_dry = {"HNO3": 1.0 / (h_hno3_molar * fct)}
    for name in ("N2O5", "NH3", "H2SO4"):
        h = henry_molar(name, t)
        henry_dry[name] = torch.where(h > 0.0,
                                      1.0 / (torch.clamp(h, min=1e-300)
                                             * fct), 0.0)
    return {"xkmtd": xkmtd, "henry_dry": henry_dry, "xeq_hno3": xeq_hno3,
            "cwd": cwd, "rcd": rcd}
