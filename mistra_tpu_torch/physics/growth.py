"""Condensational droplet growth on the 2-D spectral bin grid, over a
column batch (torch counterpart of ``mistra_tpu.physics.growth``).

Reference parity: ``kon`` (str.f90:4478-4795) per-level growth driver,
``subkon`` (str.f90:4987-5204) Davies growth equation with Pruppacher &
Klett kinetic corrections and a Newton iteration on the mean saturation,
``advec`` (str.f90:5321-5516) Bott positive-definite polynomial flux
advection along the water-mass axis with per-bin Courant time splitting.

The Bott advection has two implementations with one contract:

* ``bott_advect_plain`` / ``bott_dwsum_plain``: plain torch, the banded
  closed-form walk and banded deposit of the JAX package
  (``_walk_rightward_banded`` and the banded branch of
  ``bott_bin_advection``), on any device;
* ``physics.bott_cuda``: the hand-written CUDA kernels.

``bott_bin_advection`` / ``bott_dwsum`` dispatch on the tensor's device
only: CUDA tensors go to the kernel (which raises on what it does not
take), CPU tensors to the plain version, anything else raises.
"""

from __future__ import annotations

import torch

from ..constants import CP, PI, R0, R1, RHOW
from ..parallel.bins import BinShard
from ..utils.profiling import count
from . import bott_cuda
from .thermo import p21

# Walk band J: walks longer than J bins per 10-s substep are clamped to the
# band edge (positive-definite and conservative); J >= nkt is exact.
BAND = 32
# Newton iterations of subkon's mean-saturation solve (early exit per column)
NEWTON_ITERS = 10

YMIN = 1.0e-32
_WALK_EPS = 1.0e-7  # remaining-time cutoff of the reference walk


# --- small thermodynamic helper functions (str.f90:7640-7693, 5216-5320) ---

def xl21(t):
    """Latent heat of vaporisation [J/kg]."""
    return 3138708.0 - 2339.4 * t


def diff_wat_vap(t, p):
    """Diffusivity of water vapour in air [m2/s] (P&K 13-3)."""
    cst2 = 0.211e-4 * 101325.0 / (273.15 ** 1.94)
    return cst2 * t ** 1.94 / p


def therm_conduct_air(t):
    """Thermal conductivity of air [J/(m s K)] (S&P 17.71)."""
    return 4.39e-3 + 7.1e-5 * t


# --------------------------------------------------------------------------
# Bott flux-form advection along the (log-equidistant) water-mass axis
# --------------------------------------------------------------------------

def _walk_prefix(u):
    """(pos, S, P) of rows u [..., nkt]: u > 0, and the time after crossing
    bin k (S) and bin k-1 (P) of a particle crossing bin k in time 1/u_k
    (0 where u_k <= 0)."""
    pos = u > 0.0
    inv = torch.where(pos, 1.0 / torch.where(pos, u, 1.0), 0.0)
    # accumulated in float64 whatever the dtype: in float32 the walk's time
    # differences are ill-conditioned against the summation order (tiny |u|
    # give huge 1/u), which differs between a sequential and a parallel
    # scan; a float64 sum rounded once is the same for every order, so the
    # CUDA kernel and this version agree
    S = torch.cumsum(inv, dim=-1, dtype=torch.float64).to(u.dtype)
    return pos, S, S - inv


def _walk_searches(S, target, pos, J):
    """(count, run) of the band searches, as loops over d < J:
    count_d: prefix-monotone indicator S[i+d] < target[i] (kstar = i+count);
    run_d:   consecutive positive-u run from bin i+1 (b = i+1+run)."""
    nkt = S.shape[-1]
    i = torch.arange(nkt, device=S.device)
    count = torch.zeros(S.shape, dtype=torch.int64, device=S.device)
    run = torch.zeros_like(count)
    q = torch.ones_like(pos)
    for d in range(J):
        Sd = torch.roll(S, -d, dims=-1)
        count = count + ((i + d < nkt) & (Sd < target))
        pos_d = torch.roll(pos, -(d + 1), dims=-1) & (i + d + 1 < nkt)
        q = q & pos_d
        run = run + q
    return count, run


def _walk_rightward_banded(dt, u, J):
    """Final position of source bins with u > 0 (others: garbage, masked
    by the caller).  A particle crosses bin k in time 1/u_k while u stays
    positive, then exhausts its time budget (fractional stop), meets a
    zero-velocity bin (integer stop), or enters a negative-velocity bin and
    makes one partial backward segment before the oscillation stop
    (str.f90:5427-5454).  The searches run over a band of J bins ahead of
    the source bin; the looked-up stop and barrier bins always lie within
    J+1 bins of it, so they are read with a direct gather."""
    nkt = u.shape[-1]
    dtype = u.dtype
    i = torch.arange(nkt, device=u.device)
    pos, S, P = _walk_prefix(u)
    count, run = _walk_searches(S, P + (dt - _WALK_EPS), pos, J)
    kstar = i + count
    b = i + 1 + run
    b_inf = b >= nkt                          # all-positive to the grid top
    kstop = torch.minimum(kstar, b)

    ks = torch.clamp(kstop, 0, nkt - 1)
    bs = torch.clamp(b, 0, nkt - 1)
    Pk = torch.gather(P, -1, ks)
    uk = torch.gather(u, -1, ks)
    Pb = torch.gather(P, -1, bs)
    ub = torch.gather(u, -1, bs)

    # fractional stop inside bin kstop (time exhausted before the barrier)
    R_in = dt - (Pk - P)
    seg = torch.minimum(R_in, 1.0 / torch.clamp(uk, min=1e-30))
    x_frac = kstop.to(dtype) + uk * seg

    # barrier cases
    bf = b.to(dtype)
    R = dt - (Pb - P)
    dt0 = torch.minimum(1.0 / torch.clamp(torch.abs(ub), min=1e-30), R)
    xb = bf + ub * dt0
    x_osc = torch.where(R - dt0 > _WALK_EPS, bf - 1.0, xb)
    x_barrier = torch.where(ub == 0.0, bf, x_osc)
    x_barrier = torch.where(b_inf, float(nkt), x_barrier)

    return torch.where(kstar < b, x_frac, x_barrier)


def _walk_banded(dt, u, J):
    """Banded characteristic walk for both directions: the leftward walk
    is the rightward one on the mirrored axis with negated velocities."""
    nkt = u.shape[-1]
    i = torch.arange(nkt, device=u.device).to(u.dtype)
    x_right = _walk_rightward_banded(dt, u, J)
    x_rev = _walk_rightward_banded(dt, -u.flip(-1), J)
    x_left = (nkt - 1.0) - x_rev.flip(-1)
    return torch.where(u == 0.0, i, torch.where(u > 0.0, x_right, x_left))


def _bott_split(dt, u, z, J):
    """(k_low, k_high, w_lo, w_hi) [..., nkt]: the two destination bins of
    each source bin's walk and the contents it deposits there (Bott
    polynomial of order 1/2/4 by source position, 0 for bins with fewer
    than YMIN particles)."""
    nkt = z.shape[-1]
    i = torch.arange(nkt, device=z.device)
    x0 = _walk_banded(dt, u, J)

    k_low = torch.floor(x0)
    c0 = x0 - k_low
    k_low = torch.clamp(k_low.long(), 0, nkt - 1)
    k_high = torch.clamp(k_low + 1, 0, nkt - 1)

    zm2, zm1 = torch.roll(z, 2, dims=-1), torch.roll(z, 1, dims=-1)
    zp1, zp2 = torch.roll(z, -1, dims=-1), torch.roll(z, -2, dims=-1)
    al = 1.0 - 2.0 * c0
    al2 = al * al
    al3 = al2 * al

    # order 1 (first/last bin)
    x1_o1 = c0 * z
    # order 2 (second / second-last bin)
    a0_2 = (26.0 * z - zp1 - zm1) / 24.0
    a1_2 = (zp1 - zm1) / 16.0
    a2_2 = (zp1 + zm1 - 2.0 * z) / 48.0
    x1_o2 = torch.minimum(z, a0_2 * c0 + a1_2 * (1.0 - al2)
                          + a2_2 * (1.0 - al2 * al))
    # order 4 (interior)
    a0_4 = (9.0 * (zp2 + zm2) - 116.0 * (zp1 + zm1) + 2134.0 * z) / 1920.0
    a1_4 = (-5.0 * (zp2 - zm2) + 34.0 * (zp1 - zm1)) / 384.0
    a2_4 = (-zp2 + 12.0 * (zp1 + zm1) - 22.0 * z - zm2) / 384.0
    a3_4 = (zp2 - 2.0 * (zp1 - zm1) - zm2) / 768.0
    a4_4 = (zp2 - 4.0 * (zp1 + zm1) + 6.0 * z + zm2) / 3840.0
    x1_o4 = torch.minimum(z, a0_4 * c0 + a1_4 * (1.0 - al2)
                          + a2_4 * (1.0 - al3) + a3_4 * (1.0 - al2 * al2)
                          + a4_4 * (1.0 - al2 * al3))

    order1 = (i == 0) | (i == nkt - 1)
    order2 = (i == 1) | (i == nkt - 2)
    x1 = torch.where(order1, x1_o1, torch.where(order2, x1_o2, x1_o4))
    x1 = torch.clamp(x1, min=0.0)
    x1 = torch.where(c0 > 0.0, x1, 0.0)

    active_src = z >= YMIN
    return (k_low, k_high, torch.where(active_src, z - x1, 0.0),
            torch.where(active_src, x1, 0.0))


def bott_advect_plain(dt, u, z, band=BAND):
    """Advect bin contents z along the bin axis with velocities u.

    u, z: [..., nkt] (u broadcast to z's shape).  Returns [..., nkt].  Bins
    with fewer than YMIN particles are dropped, matching the reference's
    significance cutoff.  Each source bin's content is traced along the
    characteristic, then deposited onto the two bracketing destination
    bins with a Bott polynomial (order 1/2/4 by source position) for the
    fractional part; the deposit is a banded shift-accumulate over
    offsets |d| <= J+2, with off-band overshoots routed to the edge bins.
    """
    nkt = z.shape[-1]
    dtype = z.dtype
    i = torch.arange(nkt, device=z.device)
    u = torch.broadcast_to(u.to(dtype), z.shape)
    J = min(band, nkt)
    k_low, k_high, w_lo, w_hi = _bott_split(dt, u, z, J)

    # ---- banded shift-accumulate deposit -----------------------------------
    # source bin i deposits at i+d for |d| <= D; a roll wraps a lane only
    # where k_low would lie outside [0, nkt), which the clip excludes.  The
    # only deposits beyond the band are the off-grid overshoots of the
    # walk (x0 = nkt, or -1 mirrored), routed to bins nkt-1 / 0.
    D = J + 2
    dk_lo = k_low - i
    dk_hi = k_high - i
    over_t = ((dk_lo > D).to(dtype) * w_lo
              + (dk_hi > D).to(dtype) * w_hi).sum(dim=-1)
    over_b = ((dk_lo < -D).to(dtype) * w_lo
              + (dk_hi < -D).to(dtype) * w_hi).sum(dim=-1)
    out = torch.zeros_like(z)
    for d in range(-D, D + 1):
        v = (torch.where(dk_lo == d, w_lo, 0.0)
             + torch.where(dk_hi == d, w_hi, 0.0))
        out = out + torch.roll(v, d, dims=-1)
    edge = torch.zeros(nkt, dtype=dtype, device=z.device)
    edge[0] = 1.0
    return (out + over_b[..., None] * edge
            + over_t[..., None] * edge.flip(0))


def bott_dwsum_plain(dt, u, z, e, band=BAND):
    """Per-row water-mass change sum_k (psi - z)[k] * e[k] of the Bott
    advection: advect, then sum."""
    psi = bott_advect_plain(dt, u, z, band)
    e_row = torch.as_tensor(e, dtype=z.dtype, device=z.device)
    return ((psi - z) * e_row).sum(dim=-1)


def _route(z):
    if z.device.type == "cuda":
        return "cuda"
    if z.device.type == "cpu":
        return "cpu"
    raise ValueError(f"Bott advection runs on cuda or cpu, not {z.device}")


def bott_bin_advection(dt, u, z, band=BAND):
    """Bott advection of z [..., nkt] by u (same shape): the CUDA kernel for
    CUDA tensors, the plain version for CPU tensors."""
    if _route(z) == "cuda":
        return bott_cuda.bott_advect(dt, u, z, band)
    return bott_advect_plain(dt, u, z, band)


def bott_dwsum(dt, u, z, e, band=BAND):
    """Row sums sum_k (psi - z)[k] * e[k]: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if _route(z) == "cuda":
        return bott_cuda.bott_dwsum(dt, u, z, e, band)
    return bott_dwsum_plain(dt, u, z, e, band)


# --------------------------------------------------------------------------
# subkon: condensation solve over all columns and levels at once
# --------------------------------------------------------------------------

def subkon(dt, ffk, totr, dfdt, feualt, pp, to_in, tn, xm1o_in, xm1n,
           qabs_kr, sr_coeff, micro, band=BAND, newton_iters=NEWTON_ITERS,
           bins=None, info=None):
    """Condensational growth for a block of levels of B columns.

    Args:
      ffk: [B, L, nkt, nka] spectra.  totr: [B, L, mb] band radiation.
      dfdt, feualt, pp, to_in, tn, xm1o_in, xm1n: [B, L] per-level scalars.
      qabs_kr: [mb, nkt, nka] absorption efficiencies (aerosol type
      already resolved).  sr_coeff: (a0m, b0m[nka]).  micro: MicroGrid
      with tensor fields in the state's dtype.

    The Newton iteration on the mean saturation runs while any column has
    an unconverged level and fewer than ``newton_iters`` iterations; a
    column that has stopped keeps its values (the per-column while-loop of
    the vmapped JAX step).  Returns (ffk' [B, L, nkt, nka], to, xm1o,
    done), the last three [B, L].

    ``bins`` (a ``parallel.bins.BinShard``, the whole axis by default)
    says which dry bins ffk holds: each iteration's water-mass change is
    its partial sum completed by one all_reduce over the tp ranks, and a
    level counts as converged only where it converged on every tp rank
    (a second all_reduce), so every rank takes the same stop decision and
    makes the same collectives.  ``info``,
    a dict, gains "iterations": the Newton iterations per column [B].
    """
    B, L, nkt, nka = ffk.shape
    bins = BinShard(nka) if bins is None else bins
    a0m, b0m = sr_coeff
    e, ew, en, dew, rw = micro.e, micro.ew, micro.en, micro.dew, micro.rw
    dlne = micro.dlne

    def lv(x):                                # [B, L] -> [B, L, 1, 1]
        return x[:, :, None, None]

    to = to_in
    xm1o = xm1o_in

    zxl21 = xl21(to)
    xldcp = zxl21 / CP
    xka = therm_conduct_air(to)
    xdv = diff_wat_vap(to, pp)
    xl = 24.483 * to / pp
    deltav = 1.3 * xl
    deltat = 2.7 * xl
    rho = pp / (R0 * to * (1.0 + 0.61 * xm1o))
    rho21 = p21(to) / (R1 * to)
    rho21s = (zxl21 / (R1 * to) - 1.0) * rho21 / to
    a0 = a0m / to
    xdv0 = xdv * torch.sqrt(2.0 * PI / (R1 * to)) / 3.6e-8
    xka0 = xka * torch.sqrt(2.0 * PI / (R0 * to)) / (7.0e-7 * rho * CP)

    # growth coefficient cd and radiative term cr per bin: [B, L, nkt, nka]
    sr = torch.clamp(torch.exp(lv(a0) / rw - (b0m * en)[None, None, None, :]
                               / ew[None, None, :, None]), min=0.1)
    xdvs = lv(xdv) / (rw / (rw + lv(deltav)) + lv(xdv0) / rw)
    xkas = lv(xka) / (rw / (rw + lv(deltat)) + lv(xka0) / rw)
    x1 = RHOW * (lv(zxl21) + xkas / (xdvs * lv(rho21s) * sr))
    cd = 3.0e12 * lv(rho21) * xkas / (x1 * rw * rw * lv(rho21s) * sr)

    # radiation term: IR-only at night (totr[..., 0] < 1)
    mb = totr.shape[-1]
    ib0_solar = totr[..., 0] >= 1.0                              # [B, L]
    band_w = torch.where(torch.arange(mb, device=totr.device) >= 6, 1.0,
                         torch.where(ib0_solar[..., None], 1.0, 0.0))
    de0 = dew                                   # [nkt]
    dep = torch.cat([dew[1:], dew[-1:]])        # dew[min(jt+1, nkt-1)]
    qabs_p = torch.cat([qabs_kr[:, 1:, :], qabs_kr[:, -1:, :]], dim=1)
    rad = torch.einsum("xlb,btk->xltk", totr * band_w,
                       (qabs_kr * de0[None, :, None]
                        + qabs_p * dep[None, :, None])) \
        / (de0 + dep)[None, :, None]
    cr = rad * 7.5e5 / (rw * x1) - RHOW * 4190.0 * lv(tn - to) / (dt * x1)

    falt_t = ffk.transpose(2, 3).contiguous()          # [B, L, nka, nkt]

    feuneu0 = torch.where(feualt < 0.95,
                          xm1n * pp / (p21(tn) * (0.62198 + 0.37802 * xm1n)),
                          feualt + dfdt * dt)
    fquer0 = 0.5 * (feuneu0 + feualt)
    aa0 = 1.0 / dt

    def velocities(fquer):
        """Staggered growth velocities along the water-mass axis."""
        c = (cd * (lv(fquer) - sr) - cr) / dlne        # [B, L, nkt, nka]
        c_t = c.transpose(2, 3)                        # [B, L, nka, nkt]
        u_mid = 0.5 * (c_t[..., 1:-1] + torch.abs(c_t[..., 1:-1])
                       + c_t[..., :-2] - torch.abs(c_t[..., :-2]))
        return torch.cat([
            torch.clamp(c_t[..., :1], min=0.0), u_mid,
            torch.clamp(c_t[..., -2:-1], max=0.0)], dim=-1)

    # scalar-only Newton iteration: the spectrum update is replayed once
    # after convergence from fquer_used (the advection's water-mass change
    # dwsum is all the iteration needs)
    fquer = fquer_used = fqa = fquer0
    res_prev = torch.zeros_like(fquer0)
    done = torch.zeros_like(fquer0, dtype=torch.bool)
    itk = torch.zeros(B, dtype=torch.int32, device=ffk.device)
    while True:
        running = (itk < newton_iters) & (~done).any(dim=1)     # [B]
        count("sync.newton")
        if not bool(running.any()):
            break
        u = velocities(fquer)
        dwsum = bins.sum_bins(
            bott_dwsum(dt, u, falt_t, e, band).sum(dim=-1))      # [B, L]
        dmsum = dwsum / rho
        dtsum = xldcp * dmsum
        xm1o_new = xm1n - dmsum
        to_new = tn + dtsum
        p1 = xm1o_new * pp / (0.62198 + 0.37802 * xm1o_new)
        feuneu = p1 / p21(to_new)
        res = feuneu + feualt - 2.0 * fquer
        conv = bins.all_agree(torch.abs(res) < 1.0e-6)
        dres = res - res_prev
        aa = torch.where((itk[:, None] > 0) & (torch.abs(dres) > 1.0e-8),
                         (fqa - fquer) / dres, aa0)
        fquer_new = fquer + aa * res

        run = running[:, None]
        upd = ~done & run
        fquer_used = torch.where(upd, fquer, fquer_used)
        to = torch.where(upd, to_new, to)
        xm1o = torch.where(upd, xm1o_new, xm1o)
        fqa = torch.where(upd, fquer, fqa)
        fquer = torch.where(upd, fquer_new, fquer)
        res_prev = torch.where(upd, res, res_prev)
        done = torch.where(run, done | conv, done)
        itk = itk + running.to(torch.int32)

    # replay: one full advection at each level's converged fquer gives
    # exactly the spectrum the in-loop masked update would have kept
    psi = bott_bin_advection(dt, velocities(fquer_used), falt_t, band)
    if info is not None:
        info["iterations"] = itk
    return psi.transpose(2, 3), to, xm1o, done


# --------------------------------------------------------------------------
# kon: growth driver over all prognostic levels
# --------------------------------------------------------------------------

def kon(model, state, dt):
    """Condensation/evaporation update of levels 1..nf (0-based), over
    the model's dry bins (``model.bins``)."""
    from .microphysics import equil_redistribute

    cfg = model.cfg
    gp = cfg.grid
    nf, n = gp.nf, gp.n
    mg = model.micro
    a0m = model.consts["a0m"]
    b0m = model.b0m
    bins = model.bins
    met, mic = state.met, state.micro
    dtype, device = met.t.dtype, met.t.device

    lev = torch.arange(n, device=device)
    sel = (lev >= 1) & (lev <= nf)  # reference levels 2..nf+1

    # recompute rH where it fell below the Koehler branch threshold
    feu_dry = met.xm1 * met.p / ((0.62198 + 0.37802 * met.xm1) * p21(met.t))
    dry = met.feu < 0.7
    feu_eff = torch.where(dry, feu_dry, met.feu)

    # --- dry branch: Koehler equilibrium redistribution --------------------
    ff_eq, xm2_eq = equil_redistribute(
        mic.ff, met.t, feu_eff, mg, a0m, b0m,
        level_mask=sel & dry, collapse=True)

    # --- moist branch: condensational growth -------------------------------
    # Mie absorption efficiencies of the radiation driver, zero without it;
    # the sticky aerosol-type index of the reference (str.f90:5131)
    if model.consts.get("qabs") is None:
        qabs_kr = torch.zeros((gp.mb, gp.nkt, bins.width), dtype=dtype,
                              device=device)
    else:
        kr = int(model.consts.get("nar", [cfg.iaertyp] * n)[1])
        if kr == 3 and model.grids.micro.rn[0] < 0.5:
            kr = 2
        qabs_kr = model.const_tensor("qabs")[:, :, :, kr - 1]

    # only levels 1..nf (reference 2..nf+1) run the growth solve
    lo, hi = 1, nf + 1
    ff_lv = mic.ff[..., lo:hi].permute(0, 3, 1, 2)   # [B, nf, nkt, nka]

    ffk_new, to_sl, xm1o_sl, _ = subkon(
        dt, ff_lv, state.rad.totrad.transpose(1, 2)[:, lo:hi],
        met.dfddt[:, lo:hi], feu_eff[:, lo:hi], met.p[:, lo:hi],
        met.talt[:, lo:hi], met.t[:, lo:hi], met.xm1a[:, lo:hi],
        met.xm1[:, lo:hi], qabs_kr, (a0m, b0m), mg,
        band=model.band, newton_iters=model.newton_iters, bins=bins)

    def back(x_sl, full):
        return torch.cat([full[..., :lo], x_sl, full[..., hi:]], dim=-1)

    to_new = back(to_sl, met.talt)
    xm1o_new = back(xm1o_sl, met.xm1a)
    ff_moist = back(ffk_new.permute(0, 2, 3, 1), mic.ff)
    xm2_moist = torch.einsum("btan,t->bn", ff_moist, mg.e)
    feu_moist = xm1o_new * met.p / ((0.62198 + 0.37802 * xm1o_new)
                                    * p21(to_new))

    # --- merge branches ----------------------------------------------------
    moist = sel & ~dry                                     # [B, n]
    ff = torch.where(moist[:, None, None, :], ff_moist,
                     torch.where((sel & dry)[:, None, None, :], ff_eq,
                                 mic.ff))
    t = torch.where(moist, to_new, met.t)
    talt = torch.where(moist, to_new, met.talt)
    xm1 = torch.where(moist, xm1o_new, met.xm1)
    xm1a = torch.where(moist, xm1o_new, met.xm1a)
    feu = torch.where(moist, feu_moist, feu_eff)
    feu = torch.where(sel, feu, met.feu)
    dfddt = torch.where(moist, (feu_moist - feu_eff) / dt, met.dfddt)

    # the sums over the bins: one all_reduce over the tp ranks
    fsum = ff.sum(dim=(1, 2))
    xm2_moist, xm2_eq, fsum = bins.sum_bins(xm2_moist, xm2_eq, fsum)
    xm2 = torch.where(moist, xm2_moist,
                      torch.where(sel & dry, xm2_eq, met.xm2))

    # --- cloud base / top diagnostics per column (str.f90:4768-4776) -------
    cloudy = (xm2 > 1.0e-5) & (lev <= nf)
    any_cloud = cloudy.any(dim=1)
    lct = torch.where(any_cloud, torch.where(cloudy, lev, 0).amax(dim=1), 0)
    lcl = torch.where(any_cloud,
                      torch.where(cloudy, lev, n + 99).amin(dim=1), lct)
    lcl = torch.minimum(lcl, lct)

    met = met.replace(t=t, talt=talt, xm1=xm1, xm1a=xm1a, feu=feu,
                      dfddt=dfddt, xm2=xm2)
    mic = mic.replace(ff=ff, fsum=fsum,
                      lcl=lcl.to(torch.int32), lct=lct.to(torch.int32))
    return state.replace(met=met, micro=mic)
