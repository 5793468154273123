"""Semi-implicit vertical diffusion operators over a column batch.

Torch counterpart of ``mistra_tpu.physics.diffusion``: ``difm``
(momentum/heat/moisture/TKE, str.f90:2944-3131) and ``difp`` (the 2-D
particle spectrum, str.f90:3137-3265).  All fields sharing an
exchange-coefficient set are solved in one Thomas sweep with a trailing
field axis.  ``difc`` (chemistry only) is not ported yet.

The JAX ``.at[...]`` updates become out-of-place concatenations.
"""

from __future__ import annotations

import torch

from ..constants import FCOR, R0
from ..utils.tridiag import diffusion_coefficients, implicit_sweep, subsidence
from .thermo import p21
from .turbulence import atk1


def difm(met, turb, surf, micro, grid, dt, ug, vg):
    """Momentum/heat/moisture/TKE implicit diffusion + subsidence.

    Returns (met', turb', kinv [B]).
    """
    detw, deta = grid.detw, grid.deta
    n = detw.shape[0]
    thet = (met.p[:, :1] / met.p) ** 0.286
    theti = 1.0 / thet

    # prognostic updates before the solve
    tke0 = torch.clamp(3.2537 * surf.ustern ** 2, min=1.0e-6)
    tke = torch.cat([tke0[:, None], met.tke[:, 1:]], dim=1)
    rho = met.p / (R0 * met.t * (1.0 + 0.61 * met.xm1))
    theta = met.t * thet
    tke = torch.clamp(tke + met.tkep * dt, min=1.0e-5)
    c = met.w * dt / deta
    met = met.replace(rho=rho, theta=theta, tke=tke)

    # turbulence closure
    met, turb, kinv = atk1(met, turb, surf, micro, grid)

    # --- momentum (atkm): u and v with Coriolis source ---------------------
    xa_m, xc_m = diffusion_coefficients(turb.atkm, detw, deta, dt)
    fdt = FCOR * dt
    uv = torch.stack([met.u, met.v], dim=-1)
    uv_rhs = torch.stack([met.u + fdt * (met.v - vg),
                          met.v - fdt * (met.u - ug)], dim=-1)
    uv_new = implicit_sweep(xa_m, xc_m, uv, rhs=uv_rhs)
    u, v = uv_new[..., 0], uv_new[..., 1]

    # --- TKE (atke) --------------------------------------------------------
    xa_e, xc_e = diffusion_coefficients(turb.atke, detw, deta, dt)
    tke = implicit_sweep(xa_e, xc_e, met.tke)

    # --- heat/moisture (atkh): xm1 and theta ------------------------------
    xa_h, xc_h = diffusion_coefficients(turb.atkh, detw, deta, dt)
    hm = torch.stack([met.xm1, met.theta], dim=-1)
    hm_new = implicit_sweep(xa_h, xc_h, hm)
    xm1, theta = hm_new[..., 0], hm_new[..., 1]

    # --- large-scale subsidence (explicit upwind) --------------------------
    fields = torch.stack([theta, u, v, xm1], dim=-1)
    fields = subsidence(fields, c)
    theta, u, v, xm1 = (fields[..., i] for i in range(4))
    c_tke = 0.5 * (c + torch.cat([c[:, 1:], c[:, -1:]], dim=1))
    tke = subsidence(tke[..., None], c_tke)[..., 0]

    # diagnostic updates on the interior levels 1..n-2
    t_int = theta[:, 1:n - 1] * theti[:, 1:n - 1]
    t = torch.cat([met.t[:, :1], t_int, met.t[:, n - 1:]], dim=1)
    feu_int = xm1[:, 1:n - 1] * met.p[:, 1:n - 1] / (
        (0.62198 + 0.37802 * xm1[:, 1:n - 1]) * p21(t_int))
    feu = torch.cat([met.feu[:, :1], feu_int, met.feu[:, n - 1:]], dim=1)

    met = met.replace(u=u, v=v, tke=tke, xm1=xm1, theta=theta, t=t, feu=feu)
    return met, turb, kinv


def difp(micro, met, turb, grid, dt):
    """Implicit diffusion + subsidence of the 2-D particle spectrum."""
    detw, deta = grid.detw, grid.deta
    B, nkt, nka, n = micro.ff.shape

    # mass-specific conversion (levels 1..n-1; level 0 untouched)
    rho = met.rho
    one = torch.ones_like(rho[:, :1])
    scale = torch.cat([one, 1.0 / rho[:, 1:]], dim=1)
    ff = micro.ff * scale[:, None, None, :]

    fields = ff.reshape(B, nkt * nka, n).transpose(1, 2).contiguous()
    # fields: [B, n, bins]
    xa, xc = diffusion_coefficients(turb.atkh, detw, deta, dt)
    fields = implicit_sweep(xa, xc, fields, bottom=fields[:, 1])

    c = met.w * dt / deta
    fields = subsidence(fields, c)

    ff = fields.transpose(1, 2).reshape(B, nkt, nka, n)
    unscale = torch.cat([one, rho[:, 1:]], dim=1)
    ff = ff * unscale[:, None, None, :]

    fsum = torch.cat([micro.fsum[:, :1], ff[..., 1:].sum(dim=(1, 2))], dim=1)
    return micro.replace(ff=ff, fsum=fsum)
