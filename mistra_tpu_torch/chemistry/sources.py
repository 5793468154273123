"""Aerosol ion loading and sea-salt aerosol source, in torch.

Port of ``mistra_tpu/chemistry/sources.py``: the initial per-bin soluble
ion composition ``sa1`` and its application ``init_konc``
(kpp.f90:313-460, 3591-3715); the sea-salt emission flux ``aer_source``
with the Monahan-86 / Smith-93 parameterisations (kpp.f90:3722-4069),
batched over columns.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.profiling import count

# sion1-index -> mechanism ion base name (reference ion numbering,
# kpp.f90:3676-3711; Na+ (20) is charge-balance bookkeeping only and has
# no reactions in the mechanism, so it is deliberately not loaded)
ION_NAMES = {1: "Hp", 2: "NH4p", 8: "SO42m", 9: "HCO3m", 13: "NO3m",
             14: "Clm", 19: "HSO4m", 24: "Brm", 34: "Im", 36: "IO3m"}


def ion_loading_table(cfg, grids, fcs, xmol3):
    """sa1: per dry-aerosol bin soluble ion content [mol/particle-ish,
    the reference's en*fcs/xmol3 units]; dict name -> [nka] (host
    numpy)."""
    rn = grids.micro.rn
    en = grids.micro.en
    nka = rn.shape[0]
    x0 = en * 1.0e-3 * np.asarray(fcs) / np.asarray(xmol3)
    xiod = 1.0 if (cfg.iod and cfg.halo) else 0.0

    names = list(ION_NAMES.values()) + ["DOM"]
    sa1 = {name: np.zeros(nka) for name in names}
    if cfg.iaertyp == 3:
        # sub-0.5um: ammonium sulfate mix; larger (or all, for the polar
        # Buys13 case): sea salt (kpp.f90:350-383)
        small = (rn < 0.5) & (not cfg.lp_buys13_0d)
        sa1["NH4p"][small] = x0[small] * 1.34
        sa1["SO42m"][small] = x0[small] * 0.34
        sa1["NO3m"][small] = x0[small] * 0.004
        sa1["HSO4m"][small] = x0[small] * 0.656
        large = ~small
        xso42m, xhco3m, xno3m, xbrm = 0.0485, 4.2e-3, 1.0e-7, 1.45e-3
        xim = 7.4e-8 / 0.545 * xiod
        xio3m = 2.64e-7 / 0.545 * xiod
        xclm = 1.0 - (xso42m + xhco3m + xno3m + xbrm + xim + xio3m)
        sa1["SO42m"][large] = xso42m * x0[large]
        sa1["HCO3m"][large] = xhco3m * x0[large]
        sa1["NO3m"][large] = xno3m * x0[large]
        sa1["Clm"][large] = xclm * x0[large]
        sa1["Brm"][large] = xbrm * x0[large]
        sa1["Im"][large] = xim * x0[large]
        sa1["IO3m"][large] = xio3m * x0[large]
        sa1["DOM"][large] = 0.27 * xbrm * x0[large]
        if cfg.lp_buxmann15alph:
            # chamber: pure NaCl/NaBr salt for rn >= 0.1 um
            for name in names:
                sa1[name][:] = 0.0
            big = rn >= 0.1
            xbrm = 4.76e-2
            sa1["Clm"][big] = (1.0 - xbrm) * x0[big]
            sa1["Brm"][big] = xbrm * x0[big]
    elif cfg.iaertyp == 1 and cfg.lp_joyce14bc:
        small = rn <= 0.5
        sa1["Hp"] = x0 * 0.1868 * 2.0
        sa1["SO42m"] = x0 * 0.1868
        sa1["Clm"] = np.where(small, x0 * 0.0227, 0.0)
        sa1["DOM"] = x0 * 0.6642
    return sa1


def apply_initial_ions(conc, sa1, ff, tot_n2i, ka, nkc):
    """init_konc: load sa1 x particle count into bins 1 (small) / 2
    (large) for all interior levels; conc [B, nvar, n], ff [B, nkt, nka,
    n].  Returns a new conc."""
    n = ff.shape[-1]
    ap = torch.sum(ff, dim=1)                    # [B, nka, n] particles/cm3
    lev = torch.arange(n, device=ff.device)
    interior = (lev >= 1) & (lev <= n - 2)
    conc = conc.clone()
    for name, arr in sa1.items():
        for b, sel in ((1, slice(0, ka)), (2, slice(ka, None))):
            if b > nkc:
                continue
            sp = f"{name}l{b}"
            if sp not in tot_n2i:
                continue
            w = torch.as_tensor(arr[sel], dtype=ff.dtype, device=ff.device)
            load = torch.einsum("bkn,k->bn", ap[:, sel], w) * 1e6
            load = torch.where(interior, load, 0.0)
            i = tot_n2i[sp]
            conc[:, i] = conc[:, i] + load
    return conc


# --------------------------------------------------------------------------
# sea-salt aerosol source (Monahan / Smith)
# --------------------------------------------------------------------------

def aer_source(model, state, dt, k_in=1, d_z=None):
    """Sea-salt particle + ion emission into the lowest interior layer of
    every column.

    Vectorised over the large dry bins: each bin's equilibrium water class
    at the current surface RH receives the emitted particles; ions go to
    chemistry bin 2 (reference kpp.f90:3810-4069).  Over the model's dry
    bins (``model.bins``): the sums over the bins (fsum, the ions) take
    one all_reduce over the tp ranks.
    """
    from ..physics.microphysics import ZRHO_FRAC, Z4PI3, rgl
    cfg = model.cfg
    drv = model._chemistry
    mg = model.micro
    bins = model.bins
    met, chem, micro = state.met, state.chem, state.micro

    # u10: wind interpolated to 10 m (aer_source_init)
    eta = np.asarray(model.grids.atm.eta)
    k10m = int(np.searchsorted(eta, 10.0)) - 1
    k10p = k10m + 1
    w10p = (10.0 - eta[k10m]) / (eta[k10p] - eta[k10m])
    w10m = 1.0 - w10p
    u10 = w10m * torch.sqrt(met.u[:, k10m] ** 2 + met.v[:, k10m] ** 2) \
        + w10p * torch.sqrt(met.u[:, k10p] ** 2 + met.v[:, k10p] ** 2)
    u10 = u10[:, None]                                    # [B, 1]

    rn, ew, rq, rw = mg.rn, mg.ew, mg.rq, mg.rw
    ka = mg.ka
    nkt = ew.shape[0]
    if d_z is None:
        d_z = model.atm.detw[1]

    a0 = (model.consts["a0m"] / met.t[:, k_in])[:, None]
    b0 = model.b0m * ZRHO_FRAC
    feu2 = torch.clamp(met.feu[:, k_in], max=0.99999)[:, None]
    rg = rgl(rn, a0, b0, feu2)                  # [B, nka] equilibrium radius
    eg = Z4PI3 * (rg ** 3 - rn ** 3)
    jt_eq = torch.clamp(torch.searchsorted(ew, eg), 0, nkt - 1)

    # dry-ish radius at RH=0.8 sets the source-function radius rr [um]
    rr = rgl(rn, a0, b0, torch.full_like(feu2, 0.8))
    # jt_low: largest jt with rq <= rr
    below = rq[None] <= rr[:, None, :]
    jt_low = torch.clamp(torch.sum(below, dim=1) - 1, min=0)  # [B, nka]

    if cfg.lpsmith:
        a1 = 10.0 ** (0.0676 * u10 + 2.43)
        a2 = 10.0 ** (0.959 * torch.sqrt(u10) - 1.476)
        df = a1 * torch.exp(-3.1 * torch.log(rr / 2.1) ** 2) \
            + a2 * torch.exp(-3.3 * torch.log(rr / 9.2) ** 2)
    else:  # Monahan et al. 1986
        bb = (0.380 - torch.log10(rr)) / 0.65
        df = 1.373 * u10 ** 3.41 * rr ** (-3.0) \
            * (1.0 + 0.057 * rr ** 1.05) \
            * 10.0 ** (1.19 * torch.exp(-bb ** 2))

    # bin-width factor
    def at(table, jt):
        return table.expand(jt.shape[0], -1, -1).gather(1, jt[:, None])[:, 0]

    width_low = at(rq, torch.clamp(jt_low + 1, max=nkt - 1)) - at(rq, jt_low)
    width_gen = at(rw, jt_low) - at(rw, torch.clamp(jt_low - 1, min=0))
    width = torch.where(jt_low == 0, width_low, width_gen)
    df = df * width / d_z * 1.0e-6              # [1/cm3/s] per bin

    # only the large (sea-salt) bins emit: ka is a global bin index
    ia_mask = bins.lo + torch.arange(bins.width, device=rn.device) >= ka
    df = torch.where(ia_mask, df, 0.0)

    # add particles at their equilibrium water class, level 1
    onehot = (torch.arange(nkt, device=rn.device)[None, :, None]
              == jt_eq[:, None, :]).to(df.dtype)             # [B, nkt, nka]
    ff = micro.ff.clone()
    ff[..., k_in] = ff[..., k_in] + onehot * df[:, None, :] * dt

    # ions into chemistry bin 2: each one's sum over the bins [B]
    ions = [(drv.tot_n2i[f"{name}l2"], bins.take(arr, 0))
            for name, arr in drv.sa1_table.items()
            if f"{name}l2" in drv.tot_n2i]
    count("sync.sea_salt", len(ions))   # each weight copied to the device
    load = torch.stack(
        [torch.sum(df * dt * torch.as_tensor(w, dtype=df.dtype,
                                             device=df.device) * 1.0e6,
                   dim=1) for _, w in ions], dim=1) \
        if ions else df.new_zeros((df.shape[0], 0))
    fsum, load = bins.sum_bins(torch.sum(ff, dim=(1, 2)), load)
    micro = micro.replace(ff=ff, fsum=fsum)
    conc = chem.conc.clone()
    for c, (i, _) in enumerate(ions):
        conc[:, i, k_in] = conc[:, i, k_in] + load[:, c]
    return state.replace(micro=micro, chem=chem.replace(conc=conc))
