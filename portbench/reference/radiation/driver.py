# Frozen copy of mistra_tpu_torch/radiation/driver.py (lines 1-474, commit b2518445).
"""Radiation driver: grid extension, per-call profile loading, band/pair
orchestration, and coupling back to the column state, in torch.

Counterpart of ``mistra_tpu.radiation.driver`` (``radiation``/``initr``/
``load1``/``rotate_in``/``rotate_out``, radinit.f90, and the ``nstrahl``
band x quadrature loop, nrad.f90:55-484).  The static part (radiation grid
and standard atmosphere above the model, ``build_static``) is host numpy,
built once from column 0 of the state of the first call; profiles and the
solve are batched over the state's columns.  The driver keeps bottom-up
model indexing and flips to the solver's top-down convention at the
interface.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..constants import G, R0
from . import solver as S
from . import tables as T


def _p21_np(t):
    return 610.7 * np.exp(17.15 * (t - 273.15) / (t - 38.33))


def rotate_back(x_td, n: int):
    """Solver layers (top-down, last axis nrlay) to model levels
    (bottom-up, last axis n): out[..., j] = x_td[..., nrlay - j] for
    j = 1..n-1, and 0 at the surface level j = 0."""
    nrlay = x_td.shape[-1]
    inner = torch.flip(x_td[..., nrlay - n + 1:], dims=[-1])
    return torch.cat([torch.zeros_like(inner[..., :1]), inner], dim=-1)


class RadiationDriver:
    """PIFM2 radiation of a Model; ``driver(state)`` returns the state
    with ``rad.dtrad``, ``rad.totrad``, ``rad.sk`` and ``rad.sl`` of every
    column.  Reads ``pifm2_171115.dat`` and the six Mie files from
    ``cfg.inpdir`` (raises if they are missing) and installs the Mie
    absorption efficiencies as ``model.consts["qabs"]``."""

    def __init__(self, model):
        cfg = model.cfg
        gp = cfg.grid
        self.model = model
        self.gp = gp
        self.dtype = model.dtype

        self.tb = T.load_pifm2(cfg.inpdir)
        self.pt = S.PairTables(self.tb)
        mie = T.load_mie_tables(cfg.inpdir)
        rn = model.grids.micro.rn
        rq = model.grids.micro.rq
        qabs, qext, asym = T.interpolate_particle_optics(mie, rn, rq)
        model.consts["qabs"] = qabs  # used by the droplet-growth solver

        # per-bin aerosol-type selection for the optics sums (load1 rule:
        # small dry bins of ocean type use the rural table)
        nar1 = int(model.consts.get("nar", [cfg.iaertyp] * gp.n)[1]) \
            if model.consts.get("nar") is not None else cfg.iaertyp
        ka0 = min(nar1, 3)  # background handled as rural upstream
        type_of_bin = np.full(rn.shape[0], ka0 - 1)
        if ka0 == 3:
            type_of_bin[rn < 0.5] = 1  # rural
        sel = np.arange(3)[None, None, None, :] == \
            type_of_bin[None, None, :, None]
        self.qabs_sel = (qabs * sel).sum(-1)   # [mb, nkt, nka]
        self.qext_sel = (qext * sel).sum(-1)
        self.asym_sel = (asym * sel).sum(-1)

        # albedo / emissivity
        self.albedo = np.full(T.MBS, 0.8 if cfg.jp_albedo_opt == 1 else 0.05)
        self.emis = np.ones(T.MBIR)

        self._static_built = False
        self._tensors = {}

    # ------------------------------------------------------------------
    def build_static(self, state):
        """Radiation grid + standard-atmosphere extension (initr).

        Host-side numpy, executed once at initialisation with the initial
        profiles of column 0; the extension layers then stay constant for
        the run.
        """
        gp = self.gp
        n, nrlay, nrlev = gp.n, gp.nrlay, gp.nrlev
        atm = self.model.grids.atm
        etw = atm.etw

        # level heights (bottom-up): model walls then 7 layers to 11 km,
        # then 20/30/40/50/100 km
        zx = np.zeros(nrlev)
        zx[:n - 1] = etw[1:n]
        dz = (11000.0 - zx[n - 2]) / 7.0
        for k in range(n - 1, n + 6):
            zx[k] = zx[k - 1] + dz
        zx[n + 6] = 20000.0
        zx[n + 7] = 30000.0
        zx[n + 8] = 40000.0
        zx[n + 9] = 50000.0
        zx[n + 10] = 100000.0
        thk = np.diff(zx)

        # dynamic lower profile at init (load1 interpolation)
        def col0(x):
            return x[0].detach().cpu().numpy().astype(np.float64)

        t, p, xm1 = col0(state.met.t), col0(state.met.p), col0(state.met.xm1)
        detw, deta = np.asarray(atm.detw), np.asarray(atm.deta)
        tx = np.zeros(nrlev)
        px = np.zeros(nrlev)
        xm1x = np.zeros(nrlev)
        tx[0], px[0], xm1x[0] = t[1], p[0], xm1[1]
        x0 = 0.5 * detw[1:n - 1] / deta[1:n - 1]
        tx[1:n - 1] = t[1:n - 1] + (t[2:n] - t[1:n - 1]) * x0
        px[1:n - 1] = p[1:n - 1] + (p[2:n] - p[1:n - 1]) * x0
        xm1x[1:n - 1] = xm1[1:n - 1] + (xm1[2:n] - xm1[1:n - 1]) * x0

        # standard atmosphere above the model top (initr:904-975)
        rnaer = np.zeros(nrlev)
        for k in range(n - 1, n + 6):
            gam, rf = 0.0065, 0.3
            tx[k] = tx[k - 1] - gam * thk[k - 1]
            px[k] = px[k - 1] * (tx[k] / tx[k - 1]) ** (G / (R0 * gam))
            xm1x[k] = 0.62198 * rf / (px[k] / _p21_np(tx[k]) - 0.37802 * rf)
            rnaer[k] = 100.0
        k = n + 6
        tx[k] = tx[k - 1]
        px[k] = px[k - 1] * np.exp(-G * (zx[k] - zx[k - 1]) / (R0 * tx[k]))
        xm1x[k] = 0.62198 * 0.02 / (px[k] / _p21_np(tx[k]) - 0.37802 * 0.02)
        for k, (gam, rf) in zip(range(n + 7, n + 10),
                                [(-0.001, 0.005), (-0.0026, 5e-5),
                                 (-0.0018, 2e-6)]):
            tx[k] = tx[k - 1] - gam * thk[k - 1]
            px[k] = px[k - 1] * (tx[k] / tx[k - 1]) ** (G / (R0 * gam))
            xm1x[k] = 0.62198 * rf / (px[k] / _p21_np(tx[k]) - 0.37802 * rf)
        tx[nrlev - 1] = 210.0
        px[nrlev - 1] = 0.0
        xm1x[nrlev - 1] = 0.0

        # ozone path (initr:995-1021): interpolate the Craig table
        o3un = self.tb.o3un
        eta_o3 = np.zeros(nrlev)
        for jz in range(nrlev):
            i_inf = min(int(zx[jz] // 1000.0) + 1, 51)
            if i_inf < 51:
                zlo = (i_inf - 1) * 1000.0
                dz3 = (zx[jz] - zlo) / 1000.0
                eta_o3[jz] = o3un[i_inf - 1] \
                    + (o3un[i_inf] - o3un[i_inf - 1]) * dz3
        qmo3 = np.zeros(nrlev)
        u_o3 = (eta_o3[:-1] - eta_o3[1:]) * 0.01
        with np.errstate(divide="ignore", invalid="ignore"):
            q = u_o3 / (2.3808 * (px[:nrlay] - px[1:nrlay + 1]))
        qmo3[:nrlay] = np.where(np.isfinite(q), q, 0.0)
        qmo3[nrlev - 1] = 0.0

        # background aerosol optics above the model domain (initr:1024-1056)
        bea_up = np.zeros((T.MB, nrlay))
        baa_up = np.zeros((T.MB, nrlay))
        ga_up = np.zeros((T.MB, nrlay))
        feux = self.tb.feux
        for jz in range(n - 1, nrlay):
            if rnaer[jz] > 0.0:
                rf = xm1x[jz] * px[jz] / (_p21_np(tx[jz])
                                          * (0.62198 + 0.37802 * xm1x[jz]))
                ih = min(np.searchsorted(feux, rf, side="right"), 7)
                ih = max(ih, 1)
                drh = (rf - feux[ih - 1]) / (feux[ih] - feux[ih - 1])
                xn = rnaer[jz] * 1.0e6
                # type 4 = background/tropospheric (0-based 3)
                bea_up[:, jz] = xn * ((1 - drh) * self.tb.seanew[ih - 1, :, 3]
                                      + drh * self.tb.seanew[ih, :, 3])
                baa_up[:, jz] = xn * ((1 - drh) * self.tb.saanew[ih - 1, :, 3]
                                      + drh * self.tb.saanew[ih, :, 3])
                ga_up[:, jz] = ((1 - drh) * self.tb.ganew[ih - 1, :, 3]
                                + drh * self.tb.ganew[ih, :, 3])

        self.zx = zx
        self.thk = thk
        self.qmo3 = qmo3
        self.t_up = tx[n - 1:]
        self.p_up = px[n - 1:]
        self.xm1_up = xm1x[n - 1:]
        self.bea_up = bea_up
        self.baa_up = baa_up
        self.ga_up = ga_up
        self._static_built = True
        self._tensors = {}

    # ------------------------------------------------------------------
    def _consts(self, device):
        """The static arrays as tensors of the model's dtype on device,
        made once per device."""
        key = torch.device(device)
        c = self._tensors.get(key)
        if c is None:
            n = self.gp.n
            t = self._tensor_on(key)
            detw, deta = t(self.model.grids.atm.detw), \
                t(self.model.grids.atm.deta)
            c = dict(
                x0=0.5 * detw[1:n - 1] / deta[1:n - 1],
                t_up=t(self.t_up), p_up=t(self.p_up), xm1_up=t(self.xm1_up),
                # the prescribed background aerosol of every layer: with
                # mic=T the model layers' part is computed per call
                bea_up=t(self.bea_up), baa_up=t(self.baa_up),
                ga_up=t(self.ga_up),
                qmo3_td=t(self.qmo3[::-1].copy()),
                thk_td=t(self.thk[::-1].copy()),
                albedo=t(self.albedo), emis=t(self.emis),
                berayl=t(self.tb.berayl))
            self._tensors[key] = c
        return c

    def _optics(self, device, bins):
        """The particle optics of the dry bins of ``bins`` (a
        ``parallel.bins.BinShard``) on device, made once per device and
        bins (the whole axis for the column ``Model.init_state`` builds,
        the model's bins later): the squared radii rq2 and the
        absorption, extinction and asymmetry numerator's weight stacked
        as q3 for one contraction with the spectra."""
        key = (torch.device(device), bins.lo, bins.hi)
        c = self._tensors.get(key)
        if c is None:
            t = self._tensor_on(key[0])
            qa, qe, asy = t(self.qabs_sel), t(self.qext_sel), \
                t(self.asym_sel)
            c = dict(rq2=bins.take(t(self.model.grids.micro.rq), -1) ** 2,
                     q3=bins.take(torch.cat([qa, qe, asy * (qe - qa)]), -1))
            self._tensors[key] = c
        return c

    def _tensor_on(self, device):
        def t(x):
            return torch.as_tensor(np.asarray(x), dtype=self.dtype,
                                   device=device)
        return t

    def load_profile(self, state):
        """Per-call lower-atmosphere profile + particle optics (load1) of
        every column: tx, px, rhox, xm1x [B, nrlev] bottom-up, ts [B],
        bea, baa, ga [B, mb, nrlay].  The optics sums over the dry bins of
        a shard of ff take one all_reduce, before their ratio."""
        n, nrlev = self.gp.n, self.gp.nrlev
        met = state.met
        B = met.t.shape[0]
        c = self._consts(met.t.device)

        def low(x, first):
            return torch.cat([x[:, first:first + 1], x[:, 1:n - 1]
                              + (x[:, 2:n] - x[:, 1:n - 1]) * c["x0"]], dim=1)

        tx = torch.cat([low(met.t, 1), c["t_up"].expand(B, -1)], dim=1)
        px = torch.cat([low(met.p, 0), c["p_up"].expand(B, -1)], dim=1)
        xm1x = torch.cat([low(met.xm1, 1), c["xm1_up"].expand(B, -1)], dim=1)
        rhox = px / (R0 * torch.clamp(tx, min=1.0) * (1.0 + 0.608 * xm1x))
        rhox[:, nrlev - 1] = 0.0
        ts = met.t[:, 0]

        # particle optics: the prescribed optics in every layer with mic=F;
        # with mic=T the model layers' (levels 1..n-1 feed layers 0..n-2)
        # from the spectrum
        up = [c[k].expand(B, -1, -1) for k in ("bea_up", "baa_up", "ga_up")]
        if not self.model.cfg.mic:
            return (tx, px, rhox, xm1x, ts, *up)
        ff = state.micro.ff[..., 1:n]                     # [B, nkt, nka, n-1]
        bins = self.model.bins.covering(ff.shape[2])
        o = self._optics(ff.device, bins)
        x0p = math.pi * 1.0e-6 * o["rq2"][:, :, None] * ff
        sums = bins.sum_bins(torch.einsum("qtk,btkz->bqz", o["q3"], x0p))
        baa_low, bea_low, ga_num = sums.chunk(3, dim=1)   # [B, mb, n-1]
        sca = bea_low - baa_low
        ga_low = torch.where(sca > 0.0,
                             ga_num / torch.clamp(sca, min=1e-300), 0.0)
        bea, baa, ga = (torch.cat([part, rest[..., n - 1:]], dim=2)
                        for part, rest in zip((bea_low, baa_low, ga_low), up))
        return tx, px, rhox, xm1x, ts, bea, baa, ga

    # ------------------------------------------------------------------
    def __call__(self, state, init=False):
        if not self._static_built:
            self.build_static(state)
        gp = self.gp
        n, nrlay = gp.n, gp.nrlay

        tx, px, rhox, xm1x, ts, bea, baa, ga = self.load_profile(state)
        B = tx.shape[0]
        c = self._consts(tx.device)

        # flip to top-down
        def flip(x):
            return torch.flip(x, dims=[-1])

        zeros_lay = tx.new_zeros((B, nrlay))
        hr_td, totrad_td, fnseb, flgeg = nstrahl(
            self.pt, flip(tx), flip(px), flip(rhox), flip(xm1x), ts,
            c["qmo3_td"].expand(B, -1), flip(bea), flip(baa), flip(ga),
            zeros_lay, zeros_lay, zeros_lay, c["thk_td"].expand(B, -1),
            state.rad.u0, c["albedo"], c["emis"], c["berayl"])

        rad = state.rad.replace(dtrad=rotate_back(hr_td, n),
                                totrad=rotate_back(totrad_td, n),
                                sk=fnseb, sl=flgeg)
        return state.replace(rad=rad)


# --------------------------------------------------------------------------


def nstrahl(pt, t, p, rho, xm1, ts, qmo3, bea, baa, ga, frac, rew, rho2w,
            thk, u0, albedo, emis, berayl):
    """Full 18-band, 121-pair radiative transfer solve of B columns
    (top-down arrays).

    t, p, rho, xm1, qmo3 [B, nrlev]; ts, u0 [B]; bea, baa, ga
    [B, mb, nrlay]; frac, rew, rho2w, thk [B, nrlay]; albedo [mbs], emis
    [mbir], berayl [mbs].  Returns (hr [B, nrlay], totrad [B, mb, nrlay],
    fnseb [B], flgeg [B]).
    """
    B, nrlev = t.shape
    nrlay = nrlev - 1
    P = pt.npairs
    dt, dev = t.dtype, t.device
    band_idx = pt.tensor("band_of_pair", torch.int64, dev)
    n_solar = int(pt.solar_pair.sum())
    day = (u0 > S.U0MIN)[:, None]                            # [B, 1]

    bb, cc = S.frr(frac)

    # --- per-band optical building blocks ---------------------------------
    # Rayleigh
    zdopr = 2.0 * rho[:, nrlev - 1]
    dtaur_s = berayl[None, :, None] * thk[:, None, :] \
        * (rho[:, :-1] + rho[:, 1:])[:, None, :] / zdopr[:, None, None]
    dtaur = torch.cat([dtaur_s, dtaur_s.new_zeros((B, T.MB - T.MBS, nrlay))],
                      dim=1)                                 # [B, mb, L]

    # aerosol
    taer = bea * thk[:, None, :]
    waer = torch.where(bea > 1.0e-20,
                       1.0 - baa / torch.clamp(bea, min=1e-300), 0.0)
    zbsca = bea - baa
    # solar bands fold Rayleigh into the asymmetry normalisation
    is_solar_band = (torch.arange(T.MB, device=dev) < T.MBS)[:, None]
    denom = zbsca + torch.where(is_solar_band, dtaur / thk[:, None, :], 0.0)
    zgaer = torch.where(denom >= 1.0e-20,
                        ga * zbsca / torch.clamp(denom, min=1e-300), 0.0)
    geff = torch.where(is_solar_band, zgaer, ga)
    plaer = torch.stack([3.0 * geff, 5.0 * geff ** 2], dim=2)  # [B,mb,2,L]
    plaer = torch.where((is_solar_band & (denom < 1e-20))[:, :, None, :],
                        0.0, plaer)

    # droplet optics
    t2w, w2w, pl2w = S.water_optics(pt, frac, rew, rho2w, thk)

    # water vapour continuum (bands 11-17, 1-based)
    tgcon_bands = S.qopcon(pt.tensor("vv_cont", dt, dev)[None, :, None],
                           t[:, None, :], p[:, None, :], xm1[:, None, :])
    tgcon = torch.cat([tgcon_bands.new_zeros((B, 10, nrlay)), tgcon_bands,
                       tgcon_bands.new_zeros((B, T.MB - 17, nrlay))], dim=1)

    # Planck function for IR bands: band b spans wvl[b+1] .. wvl[b]
    wvl = pt.tensor("wvl", dt, dev)
    pib = math.pi * S.plkavg(wvl[1:, None], wvl[:-1, None],
                             t[:, None, :])                  # [B, mbir, L+1]
    pibs_b = math.pi * S.plkavg(wvl[1:], wvl[:-1], ts[:, None])  # [B, mbir]

    # gas absorption for all pairs
    tg, hk = S.gas_tau(pt, p, t, xm1, qmo3)                  # [B, P, L], [P]

    # --- gather per-pair optics and combine -------------------------------
    def by_pair(x):
        return x.index_select(1, band_idx)

    dtau, om, pl = S.total_tau(
        by_pair(dtaur), by_pair(taer), by_pair(waer), by_pair(plaer),
        by_pair(tgcon), tg, by_pair(t2w), by_pair(w2w), by_pair(pl2w))

    # --- solar pairs: coefficients and the direct-beam propagation --------
    sl = slice(0, n_solar)
    alb_pair = albedo.index_select(0, band_idx[sl])
    a1, a2, a3, a4s, a5s, a6 = S.kurzw_coefficients(
        dtau[:, sl], om[:, sl], pl[:, sl], u0)
    sf, sw, ssf, ssw, f1f_s, f1w_s, f2f_s, f2w_s = S.kurzw_propagate(
        a1, a2, a3, a6, bb, cc, u0, alb_pair)

    # --- IR pairs: coefficients and the Planck source ---------------------
    ir = slice(n_solar, P)
    ir_band0 = band_idx[ir] - T.MBS                          # 0..11
    emis_pair = emis.index_select(0, ir_band0)
    pib_pair = pib.index_select(1, ir_band0)                 # [B, Pi, L+1]
    pibs_pair = pibs_b.index_select(1, ir_band0)
    a4i, a5i, a6i = S.langw_coefficients(dtau[:, ir], om[:, ir], pl[:, ir])
    f1f_i, f1w_i, f2f_i, f2w_i = S.langw_rhs(
        a4i, a5i, a6i, pib_pair, pibs_pair, frac, emis_pair, bb)

    # --- one diffuse-flux elimination for the solar and IR pairs: the
    # pairs are independent, so this is jeanfr's solar and IR calls at
    # half the launches
    def both(x_s, x_i):
        return torch.cat([x_s, x_i], dim=1)

    f1f, f1w, f2f, f2w = S.jeanfr(
        both(a4s, a4i), both(a5s, a5i), bb, cc, both(f1f_s, f1f_i),
        both(f1w_s, f1w_i), both(f2f_s, f2f_i), both(f2w_s, f2w_i),
        torch.cat([alb_pair, 1.0 - emis_pair]))

    # --- solar sums -------------------------------------------------------
    hk_s = hk[sl]
    wgt = torch.where(day, 1.0, 0.0) * hk_s                  # [B, Ps]
    f1_s = f1f[:, sl] + f1w[:, sl]
    f2_s = f2f[:, sl] + f2w[:, sl]
    ss = torch.einsum("bp,bpl->bl", wgt, sf + sw)
    sss = torch.einsum("bp,bpl->bl", wgt, ssf + ssw)
    fs1 = torch.einsum("bp,bpl->bl", wgt, f1_s)
    fs2 = torch.einsum("bp,bpl->bl", wgt, f2_s)
    # per-band sums for totrad (one-hot contractions: a fixed summation
    # order, no atomics)
    seg_s = pt.tensor("onehot_s", dt, dev)                   # [Ps, mbs]
    dlam2 = torch.einsum("pk,bp,bpl->bkl", seg_s, wgt, ssf + ssw)
    dlam3 = torch.einsum("pk,bp,bpl->bkl", seg_s, wgt, f1_s)
    dlam4 = torch.einsum("pk,bp,bpl->bkl", seg_s, wgt, f2_s)

    # --- IR sums ----------------------------------------------------------
    hk_i = hk[ir]
    up_ir = pib_pair - f1f[:, ir] - f1w[:, ir]
    dn_ir = pib_pair - f2f[:, ir] - f2w[:, ir]
    fl1 = torch.einsum("p,bpl->bl", hk_i, up_ir)
    fl2 = torch.einsum("p,bpl->bl", hk_i, dn_ir)
    seg_i = pt.tensor("onehot_i", dt, dev)                   # [Pi, mbir]
    dlam5 = torch.einsum("pk,p,bpl->bkl", seg_i, hk_i, up_ir)
    dlam6 = torch.einsum("pk,p,bpl->bkl", seg_i, hk_i, dn_ir)
    dlam7 = torch.einsum("pk,p,bpl->bkl", seg_i, hk_i, pib_pair)

    # --- corrections (nstrahl:417-444) ------------------------------------
    s0 = 1355.3
    zfuq1 = s0 / pt.tb.s0tot
    zfuq2 = pibs_b[:, T.MBIR - 1] * 0.03 * emis[T.MBIR - 1]  # [B]
    ss = ss * zfuq1
    sss = sss * zfuq1
    fs1 = fs1 * zfuq1
    fs2 = fs2 * zfuq1
    dlam2 = dlam2 * zfuq1
    dlam3 = dlam3 * zfuq1
    dlam4 = dlam4 * zfuq1

    totds = torch.where(day, sss + fs2, 0.0)
    fs2 = torch.where(day, totds - ss, 0.0)
    fl1 = fl1 + zfuq2[:, None]
    dlam5[:, T.MBIR - 1] += zfuq2[:, None]

    flgeg = fl2[:, nrlev - 1]
    fnseb = fs2[:, nrlev - 1] + ss[:, nrlev - 1] - fs1[:, nrlev - 1]

    # heating rates
    zfn = fl1 - fl2 + fs1 - ss - fs2                         # [B, L+1]
    zx0 = thk * (rho[:, :-1] + rho[:, 1:]) * 502.5
    hr = (zfn[:, 1:] - zfn[:, :-1]) / zx0

    # totrad for the droplet-growth radiative term (nstrahl:464-482)
    u0_safe = torch.clamp(u0, min=1.0e-4)[:, None, None]
    tot_s = (dlam2[..., :-1] + dlam2[..., 1:]) / (2.0 * u0_safe) \
        + dlam3[..., :-1] + dlam3[..., 1:] + dlam4[..., :-1] + dlam4[..., 1:]
    tot_s = torch.where(day[:, :, None], tot_s, 0.0)
    tot_i = -(dlam7[..., :-1] + dlam7[..., 1:]) * 2.0 \
        + dlam6[..., :-1] + dlam6[..., 1:] + dlam5[..., :-1] + dlam5[..., 1:]
    totrad = torch.cat([tot_s, tot_i], dim=1)                # [B, mb, L]
    return hr, totrad, fnseb, flgeg
