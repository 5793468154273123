"""Shared inputs of the port's chemistry tests: a per-cell environment
made with numpy from a seed, as JAX and as torch rate environments."""

from __future__ import annotations

import numpy as np
import torch

from mistra_tpu_torch.chemistry import rates as trates


def environment(B, seed, fixed_names):
    """Per-cell numpy environment: te over 275-295 K, air at 1 atm, O2/N2
    from the air density, H2O 0.5 mol/m3 and aqueous water 1e-2.
    Returns (env dict, fix [B, len(fixed_names)])."""
    rng = np.random.default_rng(seed)
    te = rng.uniform(275.0, 295.0, B)
    air = 101325.0 / (8.314 * te)
    env = dict(te=te, aircc=air * 6.022e17, h2oppm=np.full(B, 1.2e4),
               pk=rng.uniform(9.0e4, 1.02e5, B),
               ph_rat=rng.uniform(0.0, 1e-4, (B, 5)))
    cols = {"O2": 0.21 * air, "N2": 0.79 * air, "H2O": np.full(B, 0.5)}
    fix = np.zeros((B, len(fixed_names)))
    for i, s in enumerate(fixed_names):
        fix[:, i] = cols.get(s, 1e-2)
    return env, fix


def jax_env(env, **kw):
    import jax.numpy as jnp
    from mistra_tpu.chemistry.rates import RateEnv
    return RateEnv(**{k: jnp.asarray(v) for k, v in env.items()}, **kw)


def torch_env(env, **kw):
    return trates.RateEnv(**{k: torch.tensor(v) for k, v in env.items()},
                          **kw)
