# Frozen copy of mistra_tpu_torch/chemistry/rates.py (lines 1-274, commit b2518445).
"""Gas-phase rate-law function library, on torch tensors.

Port of ``mistra_tpu/chemistry/rates.py``: the ~30 rate functions the
mechanism files reference (kpp.f90:7127-8605), vectorized over cells.
Each function takes the per-cell environment ``env`` (temperature te [K],
air number density aircc [molec/cm3], water vapour h2oppm [ppm], pressure
pk [Pa]) bound by the mechanism compiler.

The mechanism strings pass Python floats as well as tensors; every
argument that reaches a torch function goes through ``as_tensor`` on the
environment's device and dtype first (``torch.where`` and ``torch.exp``
take tensors only).
"""

from __future__ import annotations

import re
from dataclasses import dataclass

import torch

from ..constants import CONV1, GAS_CONST, PI


@dataclass
class RateEnv:
    """Per-cell environment for rate evaluation (reference /cb_1/ + more).

    te, aircc, h2oppm, pk: [B] tensors (or broadcastable); they fix the
    device and dtype of every rate constant."""
    te: torch.Tensor        # temperature [K]
    aircc: torch.Tensor     # air number density [molec/cm3]
    h2oppm: torch.Tensor    # water vapour [ppm]
    pk: torch.Tensor        # pressure [Pa]
    ph_rat: torch.Tensor    # [..., nphrxn] photolysis rates [1/s]
    xhal: object = 1.0
    xiod: object = 1.0
    # aqueous-phase environment (filled by the multiphase stage)
    extras: dict = None


def make_namespace(env: RateEnv) -> dict:
    """Build the evaluation namespace binding rate functions to env."""
    te, aircc, h2oppm, pk = env.te, env.aircc, env.h2oppm, env.pk
    dev, dt = te.device, te.dtype

    def t(x):
        return torch.as_tensor(x, dtype=dt, device=dev)

    def exp(x):
        return torch.exp(t(x))

    def where(cond, a, b):
        return torch.where(t(cond).bool(), t(a), t(b))

    def farr(a, b):
        return a * exp(b / te)

    def farr2(a0, b0):
        # Arrhenius with b0 referenced to 298 K
        return a0 * exp(b0 * (1.0 / te - 3.3557e-3))

    def farr_sp(a, b, c, d):
        return a * (te / b) ** c * exp(d / te)

    def _troe(a0, b0, x2):
        lg = torch.log10(t(a0 / b0))
        return (a0 / (1.0 + a0 / b0)) * x2 ** (1.0 / (1.0 + lg * lg))

    def atk_3(a1, a2, b1, b2, fc):
        a0 = a1 * aircc * (te / 300.0) ** a2
        b0 = b1 * (te / 300.0) ** b2
        return _troe(a0, b0, fc)

    def atk_3a(a1, a2, b1, b2, tfc):
        a0 = a1 * aircc * (te / 300.0) ** a2
        b0 = b1 * (te / 300.0) ** b2
        return _troe(a0, b0, exp(-te / tfc))

    def atk_3c(a1, b1, fc):
        a0 = a1 * exp(-10000.0 / te) * aircc
        b0 = b1 * exp(-10900.0 / te)
        x2 = exp(-te / 250.0) + exp(-1050.0 / te) if fc == 0.0 else fc
        return _troe(a0, b0, x2)

    def atk_3d(a1, b1, fc):
        a0 = a1 * exp(-8000.0 / te) * aircc
        b0 = b1 * exp(-8820.0 / te)
        return _troe(a0, b0, fc)

    def atk_3e(a1, a2, b1, b2, fc):
        a0 = a1 * aircc * (te / 300.0) ** a2
        b0 = b1 * (te / 300.0) ** b2 * exp(46.0 / te)
        return _troe(a0, b0, fc)

    def atk_3f(a1, a2, b1, b2, fc):
        a0 = a1 * aircc * (te / 298.0) ** a2
        b0 = b1 * (te / 298.0) ** b2
        return _troe(a0, b0, fc)

    def shno3(a1, b1, a2, b2, a3, b3):
        tte = 1.0 / te
        f1 = a1 * exp(b1 * tte)
        f2 = a2 * exp(b2 * tte)
        f3 = a3 * exp(b3 * tte)
        return f1 + f3 * aircc / (1.0 + f3 * aircc / f2)

    def fbck(a1, a2, b1, b2, fc, ak, bk):
        x1 = atk_3(a1, a2, b1, b2, fc)
        return x1 / (ak * exp(bk / te))

    def fbckj(a1, a2, b1, b2, ak, bk):
        return fbck(a1, a2, b1, b2, 0.6, ak, bk)

    def fbck2(a1, a2, b1, b2, fc, ck):
        # BrNO3 thermal decomposition, K_eq of Orlando & Tyndall (1996)
        ak, bk = 5.44e-9, 14192.0
        x1 = atk_3(a1, a2, b1, b2, fc)
        ck = t(ck)
        out = x1 / (ak * exp(bk / te) * 8.314 / 101325.0 * te
                    / where(ck == 0.0, 1.0, ck))
        return where(ck == 0.0, 0.0, out)

    def fbck2b(a1, a2, b1, b2, ak, bk, ck):
        x1 = atk_3(a1, a2, b1, b2, 0.6)
        ck = t(ck)
        out = x1 / (ak * exp(bk / te) * 8.314 / 101325.0 * te
                    / where(ck == 0.0, 1.0, ck))
        return where(ck == 0.0, 0.0, out)

    def sp_17(a, b):
        return a * (1.0 + aircc / b)

    def sp_23(a1, b1, a2, b2, a3, b3):
        tte = 1.0 / te
        return (a1 * exp(b1 * tte) + a2 * aircc * exp(b2 * tte)) \
            * (1.0 + a3 * aircc * h2oppm * 1.0e-6 * exp(b3 * tte))

    def sp_29(a1, b1, a2, b2, c):
        num = aircc * a1 * te ** b1
        den = a2 * te ** b2
        lg = torch.log10(num / den)
        z = 1.0 / (1.0 + lg * lg)
        return num / (1.0 + num / den) * c ** z

    def fcn(x1):
        x2 = 8.314 * te
        xmg = pk / x2
        return 10.0 ** (-6.16) * exp(-90.7e3 / x2) * xmg * x1

    def dms_add():
        o2 = 0.21 * aircc
        tte = 1.0 / te
        return 9.5e-39 * exp(5270.0 * tte) * o2 / (
            1.0 + 7.5e-29 * exp(5610.0 * tte) * o2)

    def het_uptake(gcoeff, molarm):
        asa = 3.0e-6
        molecvel = torch.sqrt(8.0 * GAS_CONST * te / (PI * molarm * 1.0e-3))
        return gcoeff * asa * molecvel * 1.0e2 / 4.0

    def surf_uptake(gcoeff, molarm):
        sa = 5.7e-3
        molecvel = torch.sqrt(8.0 * GAS_CONST * te / (PI * molarm * 1.0e-3))
        return gcoeff * sa * molecvel * 1.0e2 / 6.0

    def dmin2(a):
        return torch.minimum(t(a), t(1.0e10))

    def dmin3(a):
        return torch.minimum(t(a), t(5.0e9))

    def flsc(a, b, c, d):
        c, d = t(c), t(d)
        out = a * b ** 2 * d ** 4 \
            + 1.2e3 * b ** 2 / where(c > 0, c, 1.0) * d ** 3
        return where((d > 0.0) & (c > 0), out, 0.0)

    def flsc4(a, b, c):
        c = t(c)
        return where(c > 0.0, a * b * c ** 3, 0.0)

    def flsc5(a, b, c):
        c = t(c)
        return where(c > 0.0, a * b ** 2 * c ** 4, 0.0)

    def flsc6(a, b):
        b = t(b)
        return where(b > 1.0e-15, a / where(b > 1e-15, b, 1.0), 0.0)

    def fliq_60(a1, b1, c, d):
        d = t(d)
        out = farr2(a1, b1) * c / (c + 0.1 / where(d > 0, d, 1.0))
        return where(d > 0.0, out, 0.0)

    def uplim(a, b, c, d):
        # diffusion-limited 1st-order backward rate (kpp.f90:7862-7881)
        d = t(d)
        out = a / (1.0 + b / 1.0e10 * torch.clamp(t(c), min=0.0) * d)
        return where(d > 0.0, out, 0.0)

    def uparm(a0, b0, c, d, e):
        # Arrhenius (298K ref) with diffusion limit (kpp.f90:7885-7907)
        d = t(d)
        out = farr2(a0, b0) / (1.0 + c / 1.0e10 * d * e)
        return where(d > 0.0, out, 0.0)

    def uplip(a, b, c):
        # diffusion-limited 3rd-order forward rate (kpp.f90:7909-7927)
        c = t(c)
        out = a / (1.0 + a / 1.0e10 * torch.clamp(t(b), min=0.0) * c) \
            * c ** 2
        return where(c > 0.0, out, 0.0)

    def uparp(a0, b0, c, d):
        d = t(d)
        k0 = farr2(a0, b0)
        out = k0 / (1.0 + k0 / 1.0e10 * c * d) * d ** 2
        return where(d > 0.0, out, 0.0)

    ns = {
        "farr": farr, "farr2": farr2, "farr_sp": farr_sp,
        "atk_3": atk_3, "atk_3a": atk_3a, "atk_3c": atk_3c,
        "atk_3d": atk_3d, "atk_3e": atk_3e, "atk_3f": atk_3f,
        "shno3": shno3, "fbck": fbck, "fbckj": fbckj, "fbck2": fbck2,
        "fbck2b": fbck2b, "sp_17": sp_17, "sp_23": sp_23, "sp_29": sp_29,
        "fcn": fcn, "dms_add": dms_add, "het_uptake": het_uptake,
        "surf_uptake": surf_uptake, "dmin2": dmin2, "dmin3": dmin3,
        "flsc": flsc, "flsc4": flsc4, "flsc5": flsc5, "flsc6": flsc6,
        "fliq_60": fliq_60, "uplim": uplim, "uplip": uplip,
        "uparm": uparm, "uparp": uparp,
        "conv1": CONV1,
        "te": te, "aircc": aircc, "h2oppm": h2oppm, "pk": pk,
        "xhal": env.xhal, "xiod": env.xiod,
        "ph_rat": lambda i: env.ph_rat[..., i - 1],
    }
    if env.extras:
        ns.update(env.extras)
    return ns


def probe_dry_extras(mech, env: RateEnv, zeros, max_passes: int = 10):
    """Namespace extras that zero out every aqueous/heterogeneous hook.

    For running a multiphase mechanism on *dry* cells (no aqueous bins
    bound — benchmarks, gas-only towers): iteratively evaluates every
    rate expression, mapping each unresolved name to ``zeros`` (scalars
    like ``xliq1``/``xhet1`` switches) or to a zero-returning callable
    (``yxkmt``/``ycw``/``fdhet*`` hooks, kpp.f90:8198-8349).  Matches
    the reference where those switches are 0 for cloud-free layers
    (kpp.f90:4451-4468).
    """
    extras: dict = {}
    for _ in range(max_passes):
        trial = RateEnv(te=env.te, aircc=env.aircc, h2oppm=env.h2oppm,
                        pk=env.pk, ph_rat=env.ph_rat, xhal=env.xhal,
                        xiod=env.xiod, extras=dict(extras))
        ns = make_namespace(trial)
        missing = set()
        for rx in mech.reactions:
            try:
                eval(rx.rate_expr, {"__builtins__": {}}, dict(ns))
            except NameError as exc:
                missing.add(str(exc).split("'")[1])
            except Exception:
                pass
        missing -= set(extras)
        if not missing:
            break
        for nm in missing:
            is_fn = any(re.search(rf"\b{nm}\s*\(", rx.rate_expr)
                        for rx in mech.reactions)
            extras[nm] = (lambda *a: 0.0) if is_fn else zeros
    return extras
