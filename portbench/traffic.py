"""The general generator: a sensitivity ensemble of B columns from a seed.

A traffic mix (``traffic/<name>.json``) fixes

* ``columns``: the ensemble size B;
* ``noon_share``: the share of the columns (the last ones) that start at
  12:00 local solar time; the others start at 00:00, the BTZ96 start;
* ``warmup_minutes``: minutes run in set-up, before the window;
* ``profile``: the slice of the window that ``--trace 1`` profiles, as
  ``{"minutes": k}`` or ``{"substeps": k}`` from the window's start.

The configuration's ``assumed.perturbation`` sizes each column's
perturbation of its initial temperature and humidity profiles: a sum of
``modes`` sine modes over the levels 1..kinv-1 (zero at the surface and
from the inversion up), with standard normal weights drawn from the
seed, scaled to ``t_K`` kelvin and to a relative ``q_rel`` of the
specific humidity.  The fields that the port's init derives from t and
xm1 (theta, thetl, talt, xm1a, rho, feu; the formulas of
``mistra_tpu_torch/init.py:208-216``) follow them; the pressure is
kept.  Every seed gives the same sizes and the same split.
"""

from __future__ import annotations

import math
import sys

import numpy as np
import torch

from .reference.constants import R0


def perturbations(seed: int, B: int, n: int, kinv: int, pert: dict):
    """(dT [B, n] in K, dq [B, n] relative), float64 numpy, from seed."""
    rng = np.random.default_rng(seed)
    modes = int(pert["modes"])
    g = rng.standard_normal((B, modes))
    h = rng.standard_normal((B, modes))
    k = np.arange(n)
    shape = np.zeros((modes, n))
    for j in range(modes):
        shape[j, 1:kinv] = np.sin((j + 1) * math.pi * k[1:kinv] / kinv)
    norm = 1.0 / math.sqrt(modes)
    return (pert["t_K"] * norm * g @ shape,
            pert["q_rel"] * norm * h @ shape)


def perturb(state, seed: int, pert: dict):
    """state with each column's t and xm1 perturbed, and the fields
    derived from them recomputed (works on the program's state and on the
    reference's alike)."""
    met = state.met
    B, n = met.t.shape
    kinv = int(state.tim.kinv[0])
    dT, dq = perturbations(seed, B, n, kinv, pert)
    dev = met.t.device
    p = met.p.double()
    t = met.t.double() + torch.as_tensor(dT, device=dev)
    xm1 = met.xm1.double() * (1.0 + torch.as_tensor(dq, device=dev))
    theta = t * (p[:, :1] / p) ** 0.286
    es = 610.7 * torch.exp(17.15 * (t - 273.15) / (t - 38.33))
    feu = xm1 * p / ((0.62198 + 0.37802 * xm1) * es)
    rho = p / (R0 * t * (1.0 + 0.61 * xm1))
    thetl = theta * (1.0 + 0.61 * xm1)
    dt = met.t.dtype
    return state.replace(met=met.replace(
        t=t.to(dt), talt=t.to(dt), xm1=xm1.to(dt), xm1a=xm1.to(dt),
        theta=theta.to(dt), thetl=thetl.to(dt), rho=rho.to(dt),
        feu=feu.to(dt)))


def split_noon(model, state, noon_share: float):
    """state with its last round(B * noon_share) columns at 12:00, each
    column with its own solar zenith angle and, with chemistry on, its
    own J-rates (chip_smoke.midnight_and_noon's start)."""
    B = state.tim.lst.shape[0]
    noon = int(round(B * noon_share))
    solar_zenith = sys.modules[type(model).__module__].solar_zenith
    lst = state.tim.lst.clone()
    if noon:
        lst[B - noon:] = 12
    u0 = solar_zenith(lst, state.tim.lmin, model.astro.alat,
                      model.astro.declin, model.dtype)
    state = state.replace(tim=state.tim.replace(lst=lst),
                          rad=state.rad.replace(u0=u0))
    if model._photolysis is not None:
        state = model.photolysis_step(
            state, torch.ones_like(u0, dtype=torch.bool))
    return state


def start(model, seed: int, config: dict, mix: dict):
    """The ensemble's start on model (the program's or the reference's):
    init_state(B), the seed's perturbation, the noon split."""
    state = model.init_state(int(mix["columns"]))
    state = perturb(state, seed, config["assumed"]["perturbation"])
    return split_noon(model, state, float(mix["noon_share"]))
