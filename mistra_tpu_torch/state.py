"""Model state as dataclasses of torch tensors with a leading column axis.

Counterpart of ``mistra_tpu.state``.  The JAX package keeps per-column
shapes and adds the ensemble axis with ``jax.vmap``; here the column axis
``B`` is written out as the first dimension of every field, and the
per-column layouts behind it are those of the JAX package (``ff`` is
``[B, nkt, nka, n]``, ``totrad`` is ``[B, mb, n]``, scalars are ``[B]``,
clock and layer indices are int32 ``[B]``).

Updates are out of place: every physics function returns new dataclasses
built with ``replace``, as the JAX functions do.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from .config import MistraConfig


class _Fields:
    """replace / to / map helpers shared by the state dataclasses."""

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    def map(self, fn):
        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            out[f.name] = v.map(fn) if isinstance(v, _Fields) else fn(v)
        return type(self)(**out)

    def to(self, device):
        return self.map(lambda x: x.to(device))


@dataclass
class MetState(_Fields):
    """Meteorological column state, all [B, n]."""
    u: torch.Tensor
    v: torch.Tensor
    w: torch.Tensor
    t: torch.Tensor
    theta: torch.Tensor
    thetl: torch.Tensor
    talt: torch.Tensor
    p: torch.Tensor
    rho: torch.Tensor
    xm1: torch.Tensor
    xm1a: torch.Tensor
    xm2: torch.Tensor
    feu: torch.Tensor
    dfddt: torch.Tensor
    tke: torch.Tensor
    tkep: torch.Tensor
    buoy: torch.Tensor


@dataclass
class TurbState(_Fields):
    """Turbulence closure state, all [B, n]."""
    atke: torch.Tensor
    atkh: torch.Tensor
    atkm: torch.Tensor
    gm: torch.Tensor
    gh: torch.Tensor
    sm: torch.Tensor
    sh: torch.Tensor
    xl: torch.Tensor
    tkeps: torch.Tensor
    tkepb: torch.Tensor
    tkepd: torch.Tensor


@dataclass
class SurfaceState(_Fields):
    """Surface / Prandtl layer state: [B] scalars, tb/eb [B, nb]."""
    tw: torch.Tensor
    ustern: torch.Tensor
    z0: torch.Tensor
    gclu: torch.Tensor
    gclt: torch.Tensor
    tb: torch.Tensor
    eb: torch.Tensor
    ajs: torch.Tensor
    ds1: torch.Tensor
    ds2: torch.Tensor
    trdep: torch.Tensor
    tau: torch.Tensor
    reif: torch.Tensor
    ajb: torch.Tensor
    ajq: torch.Tensor
    ajl: torch.Tensor
    ajt: torch.Tensor
    ajm: torch.Tensor
    ajd: torch.Tensor


@dataclass
class MicroState(_Fields):
    """2-D spectral bin microphysics state."""
    ff: torch.Tensor      # [B, nkt, nka, n]
    fsum: torch.Tensor    # [B, n]
    lcl: torch.Tensor     # [B] int32
    lct: torch.Tensor     # [B] int32
    vd: torch.Tensor      # [B, nkt, nka]
    xra: torch.Tensor     # [B]


@dataclass
class RadState(_Fields):
    dtrad: torch.Tensor   # [B, n]
    totrad: torch.Tensor  # [B, mb, n]
    u0: torch.Tensor      # [B]
    sk: torch.Tensor      # [B]
    sl: torch.Tensor      # [B]


@dataclass
class TimeState(_Fields):
    time: torch.Tensor    # [B] model time [s]
    lday: torch.Tensor    # [B] int32
    lst: torch.Tensor     # [B] int32
    lmin: torch.Tensor    # [B] int32
    kinv: torch.Tensor    # [B] int32


@dataclass
class ModelState(_Fields):
    met: MetState
    turb: TurbState
    surf: SurfaceState
    micro: MicroState
    rad: RadState
    tim: TimeState


_SUBSTATES = {"met": MetState, "turb": TurbState, "surf": SurfaceState,
              "micro": MicroState, "rad": RadState, "tim": TimeState}


def torch_dtype(cfg: MistraConfig) -> torch.dtype:
    return torch.float64 if cfg.dtype == "float64" else torch.float32


def zeros_state(cfg: MistraConfig, B: int) -> ModelState:
    """An all-zero state of B columns with the right shapes and dtypes."""
    gp = cfg.grid
    dt = torch_dtype(cfg)
    n, nb, nka, nkt, mb = gp.n, gp.nb, gp.nka, gp.nkt, gp.mb

    def z(*shape):
        return torch.zeros((B,) + shape, dtype=dt)

    def zi():
        return torch.zeros((B,), dtype=torch.int32)

    return ModelState(
        met=MetState(u=z(n), v=z(n), w=z(n), t=z(n), theta=z(n), thetl=z(n),
                     talt=z(n), p=z(n), rho=z(n), xm1=z(n), xm1a=z(n),
                     xm2=z(n), feu=z(n), dfddt=z(n), tke=z(n), tkep=z(n),
                     buoy=z(n)),
        turb=TurbState(atke=z(n), atkh=z(n), atkm=z(n), gm=z(n), gh=z(n),
                       sm=z(n), sh=z(n), xl=z(n), tkeps=z(n), tkepb=z(n),
                       tkepd=z(n)),
        surf=SurfaceState(tw=z(), ustern=z(), z0=z(), gclu=z(), gclt=z(),
                          tb=z(nb), eb=z(nb), ajs=z(), ds1=z(), ds2=z(),
                          trdep=z(), tau=z(), reif=z(), ajb=z(), ajq=z(),
                          ajl=z(), ajt=z(), ajm=z(), ajd=z()),
        micro=MicroState(ff=z(nkt, nka, n), fsum=z(n), lcl=zi(), lct=zi(),
                         vd=z(nkt, nka), xra=z()),
        rad=RadState(dtrad=z(n), totrad=z(mb, n), u0=z(), sk=z(), sl=z()),
        tim=TimeState(time=z(), lday=zi(), lst=zi(), lmin=zi(), kinv=zi()),
    )


def repeat_columns(state: ModelState, B: int) -> ModelState:
    """B copies of a one-column state (contiguous, not views)."""
    return state.map(lambda x: x.expand((B,) + tuple(x.shape[1:])).clone())


def state_from_numpy(tree, B: int) -> ModelState:
    """B copies of a per-column state given as numpy arrays, on the CPU.

    ``tree`` is any object with the attributes of the per-column JAX
    ``ModelState`` (``tree.met.t`` and so on), for example
    ``jax.tree.map(np.asarray, state)``.  Integer fields become int32;
    floating fields keep their dtype.  Move the result with ``.to(device)``.
    """
    subs = {}
    for sub, cls in _SUBSTATES.items():
        src = getattr(tree, sub)
        vals = {}
        for f in dataclasses.fields(cls):
            a = np.asarray(getattr(src, f.name))
            x = torch.from_numpy(np.array(a))
            if not x.is_floating_point():
                x = x.to(torch.int32)
            vals[f.name] = x.unsqueeze(0).expand(
                (B,) + tuple(x.shape)).clone()
        subs[sub] = cls(**vals)
    return ModelState(**subs)


def state_to_numpy(state: ModelState) -> ModelState:
    """The same dataclasses with numpy arrays ``[B, ...]`` as leaves."""
    return state.map(lambda x: x.detach().cpu().numpy())
