# Frozen copy of mistra_tpu_torch/physics/sedimentation.py (lines 1-307, commit b2518445).
"""Gravitational settling of the 2-D particle spectrum and particle dry
deposition velocities, over a column batch (torch counterpart of
``mistra_tpu.physics.sedimentation``).

Reference parity: ``vterm`` (str.f90:2793-2869, Stokes/Cunningham +
Beard), ``sedp`` (str.f90:2257-2411, per-bin Courant-split vertical
advection with upstream/Bott-4th order selection by radius), ``advsed0/1``
(str.f90:5522-5696), ``partdep``/``monin`` (str.f90:6233-6502,
Seinfeld & Pandis resistance scheme).

The Bott limiter's top-down flux recurrence (a ``lax.scan`` in JAX) is a
Python loop over levels with bins and columns batched; the Courant
time-splitting while-loop runs while any column has an active bin, and a
column that has stopped keeps its values.
"""

from __future__ import annotations

import torch

from ..constants import CP, G, KAPPA, PI, R0, RHOW

SEDP_MAX_SPLITS = 64


def vterm(a, t, p):
    """Terminal fall velocity [m/s] of a droplet of radius a [m].

    Stokes with Cunningham correction below 10 um, Beard polynomial above
    (Pruppacher & Klett eqs. 10-138..10-145).
    """
    b = [-0.318657e1, 0.992696, -0.153193e-2, -0.987059e-3,
         -0.578878e-3, 0.855176e-4, -0.327815e-5]
    c1 = 2.0 * G / 9.0
    c3 = 1.26 * 6.6e-8 * 101325.0 / 293.15
    c4 = 32.0 * G / 3.0

    rho_a = p / (R0 * t)
    eta = 3.7957e-6 + 4.9e-8 * t

    v_stokes = c1 * a * a * (RHOW - rho_a) / eta * (1.0 + c3 * t / (a * p))

    best = c4 * a ** 3 * (RHOW - rho_a) * rho_a / (eta * eta)
    x = torch.log(torch.clamp(best, min=1e-300))
    y = b[6]
    for coef in (b[5], b[4], b[3], b[2], b[1], b[0]):
        y = y * x + coef
    v_beard = eta * torch.exp(y) / (2.0 * rho_a * a)

    return torch.where(a <= 1.0e-5, v_stokes, v_beard)


# --------------------------------------------------------------------------
# vertical advection operators on psi[..., 0..nf-1]
# --------------------------------------------------------------------------

def advsed0(c, y):
    """Upstream sedimentation advection; c, y: [..., nf]."""
    cm = -torch.clamp(c, max=0.0)
    cpos = torch.clamp(c, min=0.0)
    fm = cm[..., :-1] * y[..., 1:]   # fm[i] ~ flux from box i+1 into box i
    fp = cpos[..., :-1] * y[..., :-1]
    interior = y[..., 1:-1] - fm[..., :-1] + fp[..., :-1] \
        + fm[..., 1:] - fp[..., 1:]
    return torch.cat([y[..., :1], interior, y[..., -1:]], dim=-1)


def advsed1(c, y):
    """Bott (1989) 4th-order monotone downward advection; c, y: [..., nf].

    The flux limiter couples levels top-down (fm[j-1] depends on fm[j]):
    a loop over levels, with the level axis moved to the front so each
    step reads contiguous slices.
    """
    nf = y.shape[-1]
    z = y
    zm2 = torch.roll(z, 2, dims=-1)
    zm1 = torch.roll(z, 1, dims=-1)
    zp1 = torch.roll(z, -1, dims=-1)
    zp2 = torch.roll(z, -2, dims=-1)

    # polynomial coefficients per level j (valid for j = 1..nf-2)
    a0_4 = (9.0 * (zp2 + zm2) - 116.0 * (zp1 + zm1) + 2134.0 * z) / 1920.0
    a1_4 = (-5.0 * (zp2 - zm2) + 34.0 * (zp1 - zm1)) / 384.0
    a2_4 = (-zp2 + 12.0 * (zp1 + zm1) - 22.0 * z - zm2) / 384.0
    a3_4 = (zp2 - 2.0 * (zp1 - zm1) - zm2) / 768.0
    a4_4 = (zp2 - 4.0 * (zp1 + zm1) + 6.0 * z + zm2) / 3840.0
    # second-order forms at j=1 and j=nf-2
    a0_2 = (26.0 * z - zp1 - zm1) / 24.0
    a1_2 = (zp1 - zm1) / 16.0
    a2_2 = (zp1 + zm1 - 2.0 * z) / 48.0
    j = torch.arange(nf, device=y.device)
    second = (j == 1) | (j == nf - 2)

    def lead(x):
        return x.movedim(-1, 0).contiguous()

    a0 = lead(torch.where(second, a0_2, a0_4))
    a1 = lead(torch.where(second, a1_2, a1_4))
    a2 = lead(torch.where(second, a2_2, a2_4))
    a3 = lead(torch.where(second, 0.0, a3_4))
    a4 = lead(torch.where(second, 0.0, a4_4))
    yl = lead(y)
    cl_lev = lead(c)

    # boundary flux at the top interior interface
    cl = -cl_lev[nf - 2]
    fm_top = torch.minimum(
        yl[nf - 1],
        cl * (yl[nf - 1] - (1.0 - cl) * (yl[nf - 1] - yl[nf - 2]) * 0.5))

    # j = nf-2 .. 1 producing fm[j-1]
    fm_j = fm_top
    fms = []
    for jj in range(nf - 2, 0, -1):
        yj, yjp1 = yl[jj], yl[jj + 1]
        clm = -cl_lev[jj - 1]
        x1 = 1.0 - 2.0 * cl
        x2 = x1 * x1
        x3 = x1 * x2
        ymin = torch.minimum(yj, yjp1)
        ymax = torch.maximum(yj, yjp1)
        fmim = torch.clamp(a0[jj] * cl - a1[jj] * (1.0 - x2)
                           + a2[jj] * (1.0 - x3) - a3[jj] * (1.0 - x1 * x3)
                           + a4[jj] * (1.0 - x2 * x3), min=0.0)
        fmim = torch.minimum(fmim, yj - ymin + fm_j)
        fmim = torch.maximum(fmim, yj - ymax + fm_j)
        fmim = torch.clamp(fmim - (cl - clm) * yj, min=0.0)
        w = yj / torch.maximum(fmim + 1.0e-15, yj)
        fm_j = fmim * w
        cl = clm
        fms.append(fm_j)
    # fm[j] for j = 0..nf-2
    fm = torch.stack(fms[::-1] + [fm_top], dim=-1)

    ylo = y[..., 0] + fm[..., 0]
    interior = y[..., 1:-1] - fm[..., :-1] + fm[..., 1:]
    ytop = y[..., -1] - fm[..., -1]
    return torch.cat([ylo[..., None], interior, ytop[..., None]], dim=-1)


# --------------------------------------------------------------------------
# sedp: settling of all bins with per-bin Courant time splitting
# --------------------------------------------------------------------------

def sedp(model, state, dt):
    """Settling of ff's bins (the model's ``bins``) on levels 1..nf-1
    with per-bin Courant splitting; the deposit sums and fsum over the
    bins take one all_reduce.  The splitting loop runs while a bin of
    this rank's is active and holds no collective: each bin's update is
    masked, so a rank's own iteration count leaves its bins as one run
    over every bin leaves them."""
    cfg = model.cfg
    gp = cfg.grid
    nf, nkt = gp.nf, gp.nkt
    dtype = state.met.t.dtype
    grid = model.atm
    mg = model.micro
    rq, e, kw = mg.rq, mg.e, mg.kw       # [nkt, nka] um, [nkt], [nka]
    deta = grid.deta
    detw = grid.detw

    met, mic = state.met, state.micro
    vd = mic.vd                          # [B, nkt, nka]

    rq_m = rq * 1.0e-6                   # radius in m
    # first-guess terminal velocity at level nf (0-based nf-1)
    ww = -vterm(rq_m, met.t[:, nf - 1, None, None],
                met.p[:, nf - 1, None, None])           # [B, nkt, nka]

    # per-level terminal velocities [B, nkt, nka, nf-1] on levels 1..nf-1
    t_lv = met.t[:, None, None, 1:nf]
    p_lv = met.p[:, None, None, 1:nf]
    vt_lv = vterm(rq_m[:, :, None], t_lv, p_lv)

    # psi [B, nkt, nka, nf]: entry 0 is the ghost (reference psi(1));
    # entries 1..nf-1 hold the reference's psi(2..nf) = ff*detw
    psi_body = mic.ff[..., 1:nf] * detw[1:nf]
    psi = torch.cat([psi_body[..., :1], psi_body], dim=-1)

    active_bin = psi_body.sum(dim=-1) > 1.0e-6         # [B, nkt, nka]
    small = (rq < 1.0)[..., None]

    x3 = deta[1]  # deta(2), positive
    dt0 = torch.where(active_bin, torch.full_like(ww, dt), 0.0)
    ground = torch.zeros_like(ww)
    it = torch.zeros(ww.shape[0], dtype=torch.int32, device=ww.device)
    zero_top = torch.zeros_like(vt_lv[..., :1])
    while True:
        act = active_bin & (dt0 > 0.1)
        running = act.flatten(1).any(dim=1) & (it < SEDP_MAX_SPLITS)
        if not bool(running.any()):
            break
        dtmax = torch.minimum(dt0, x3 / torch.clamp(-ww, min=1e-300))
        # Courant numbers on levels 1..nf-1 (reference 2..nf)
        c_int = -dtmax[..., None] / deta[1:nf] * vt_lv
        # dry-deposition-limited Courant in the lowest layer
        c1 = torch.minimum(c_int[..., 0], -dtmax / deta[1] * vd)
        c = torch.cat([c1[..., None], c1[..., None], c_int[..., 1:nf - 2],
                       zero_top], dim=-1)
        # ghost level: psi[0] = psi[1]
        psi_in = torch.cat([psi[..., 1:2], psi[..., 1:]], dim=-1)
        x1 = psi_in[..., 1]

        psi_new = torch.where(small, advsed0(c, psi_in), advsed1(c, psi_in))

        upd = act & running[:, None, None]
        psi = torch.where(upd[..., None], psi_new, psi)
        ground = torch.where(upd, ground + psi_new[..., 0] - x1, ground)
        dt0 = torch.where(upd, dt0 - dtmax, dt0)
        it = it + running.to(torch.int32)

    # write back: ff(2..nf-1) = psi/detw; ff(nf) = ff(nf-1)
    ff = mic.ff
    upd = psi[..., 1:nf - 1] / detw[1:nf - 1]
    new_mid = torch.where(active_bin[..., None], upd, ff[..., 1:nf - 1])
    top = torch.where(active_bin, new_mid[..., -1], ff[..., nf - 1])
    ff = torch.cat([ff[..., :1], new_mid, top[..., None], ff[..., nf:]],
                   dim=-1)

    # surface deposit accounting per column
    x2 = ground * e[:, None] * detw[1]       # [B, nkt, nka] kg water / m2
    jt_idx = torch.arange(nkt, device=ff.device)[:, None]
    small_bin = jt_idx <= (kw[None, :] - 1)  # reference jt<=kw(ia), 1-based
    dep_total, dep1, dep2, fsum = model.bins.sum_bins(
        x2.sum(dim=(1, 2)), torch.where(small_bin, x2, 0.0).sum(dim=(1, 2)),
        torch.where(~small_bin, x2, 0.0).sum(dim=(1, 2)),
        ff.sum(dim=(1, 2)))
    surf = state.surf
    surf = surf.replace(ajs=dep_total / dt, trdep=surf.trdep + dep_total,
                        ds1=surf.ds1 + dep1, ds2=surf.ds2 + dep2)

    mic = mic.replace(ff=ff, fsum=fsum)
    return state.replace(micro=mic, surf=surf)


# --------------------------------------------------------------------------
# partdep / monin: particle dry deposition velocities (once per minute)
# --------------------------------------------------------------------------

def _at(x, k):
    """x[b, k[b]] for x [B, n] and per-column indices k [B]."""
    return x.gather(1, k[:, None])[:, 0]


def monin(met, turb, surf, grid, kinv):
    """Monin-Obukhov stability correction phi for the aerodynamic
    resistance (S&P 19.14); per column, returns (phi [B], z [B])."""
    eta = grid.eta
    n = eta.shape[0]
    kinv = torch.clamp(kinv.long(), min=2)
    z = 0.1 * eta[kinv]
    # first level with eta >= z (reference linear search)
    ge = eta[None, :] >= z[:, None]
    k = ge.to(torch.int32).argmax(dim=1)
    k = torch.clamp(k, 1, n - 2)

    theta = met.theta
    deta = grid.deta
    dtdz = ((_at(theta, k + 1) - _at(theta, k)) / deta[k]
            + (_at(theta, k) - _at(theta, k - 1)) / deta[k - 1]) / 2.0
    q3 = _at(met.rho, k) * CP * (-1.0) * _at(turb.atkh, k) * dtdz
    xmo = -_at(met.rho, k) * CP * met.t[:, 0] * surf.ustern ** 3 \
        / (KAPPA * G * q3)

    zeta = z / xmo
    zeta0 = surf.z0 / xmo
    phi_stable = 4.7 * (zeta - zeta0)
    xeta0 = torch.clamp(1.0 - 15.0 * zeta0, min=1e-12) ** 0.25
    xeta = torch.clamp(1.0 - 15.0 * zeta, min=1e-12) ** 0.25
    phi_unstable = torch.log((xeta0 ** 2 + 1.0) * (xeta0 + 1.0) ** 2
                             / ((xeta ** 2 + 1.0) * (xeta + 1.0) ** 2)) \
        + 2.0 * (torch.atan(xeta) - torch.atan(xeta0))
    phi = torch.where(torch.abs(xmo) > 1.0e5, 0.0,
                      torch.where(xmo > 0.0, phi_stable, phi_unstable))
    return phi, z


def partdep(model, state):
    """Particle dry deposition velocities vd [B, nkt, nka] and the
    aerodynamic resistance ra [B]."""
    grid = model.atm
    mg = model.micro
    met, turb, surf = state.met, state.turb, state.surf

    phi, z = monin(met, turb, surf, grid, state.tim.kinv)
    ra = 1.0 / (KAPPA * surf.ustern) * (torch.log(z / surf.z0) + phi)

    def col(x):                         # [B] -> [B, 1, 1]
        return x[:, None, None]

    xk = 1.38066e-23
    t1, p1 = col(met.t[:, 1]), col(met.p[:, 1])
    ustern = col(surf.ustern)
    xeta = 1.8325e-5 * (416.16 / (t1 + 120.0)) * (t1 / 296.16) ** 1.5
    xnu = xeta / col(met.rho[:, 1])
    xlam = 2.28e-5 * t1 / p1

    rx = mg.rq * 1.0e-6                 # [nkt, nka] m
    vs = vterm(rx, t1, p1)
    cc = 1.0 + xlam / rx * (1.257 + 0.4 * torch.exp(-1.1 * rx / xlam))
    xd = xk * t1 * cc / (6.0 * PI * xeta * rx)
    sc = xnu / xd
    st = vs * ustern ** 2 / (G * xnu)
    rb = 1.0 / (ustern * (sc ** (-2.0 / 3.0) + 10.0 ** (-3.0 / st)))
    vd = 1.0 / (col(ra) + rb + col(ra) * rb * vs) + vs
    return vd, ra
