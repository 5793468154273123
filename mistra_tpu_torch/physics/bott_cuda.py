"""Wrappers of the hand-written CUDA Bott advection kernels (csrc/bott.cu).

Counterpart of ``mistra_tpu.physics.bott_pallas``:

* ``bott_advect`` replaces ``_bott_kernel`` (``bott_advect_tpu``): the
  banded characteristic walk, the Bott order-1/2/4 split and the banded
  deposit, returning the advected spectrum;
* ``bott_dwsum`` replaces ``_dwsum_kernel`` (``bott_dwsum_tpu``): the same
  walk and split, returning only each row's water-mass change
  sum_i w_lo*e[k_lo] + w_hi*e[k_hi] - z_i*e[i] (what subkon's Newton
  iteration needs), with e read from an array rather than rebuilt by exp.

Both take CUDA tensors only, in float32 or float64, contiguous, with u and
z of one shape [..., nkt] (nkt <= 1024), and raise on anything else; the
plain torch versions are ``growth.bott_advect_plain`` and
``growth.bott_dwsum_plain``.  Each launch goes on the current stream and
adds one to the wrapper's ``launches`` counter.  The library is built by
nvcc at first use (``kernels.build``), never at import.
"""

from __future__ import annotations

import ctypes

import torch

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_MAX_BINS = 1024


def _check(u, z):
    if not (z.is_cuda and u.is_cuda and u.device == z.device):
        raise ValueError("bott_cuda kernels take CUDA tensors on one device")
    if z.dtype not in _SUFFIX or u.dtype != z.dtype:
        raise TypeError(f"bott_cuda kernels take float32 or float64 u and z "
                        f"of one dtype, got {u.dtype} and {z.dtype}")
    if u.shape != z.shape or z.dim() < 1:
        raise ValueError(f"u and z must have one shape [..., nkt], got "
                         f"{tuple(u.shape)} and {tuple(z.shape)}")
    if not (u.is_contiguous() and z.is_contiguous()):
        raise ValueError("bott_cuda kernels take contiguous tensors")
    nkt = z.shape[-1]
    if not 1 <= nkt <= _MAX_BINS:
        raise ValueError(f"nkt={nkt} outside 1..{_MAX_BINS}")
    return nkt, z.numel() // nkt


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def _stream(t):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def bott_advect(dt, u, z, band):
    """Advected spectrum [..., nkt] of z by u, band J = min(band, nkt)."""
    from ..kernels.build import load_library
    nkt, rows = _check(u, z)
    J = min(int(band), nkt)
    out = torch.empty_like(z)
    name = "bott_advect_" + _SUFFIX[z.dtype]
    fn = getattr(load_library(), name)
    with torch.cuda.device(z.device):
        err = fn(ctypes.c_void_p(u.data_ptr()), ctypes.c_void_p(z.data_ptr()),
                 ctypes.c_void_p(out.data_ptr()), rows, nkt, J, float(dt),
                 _stream(z))
    _raise_on(err, name)
    bott_advect.launches += 1
    return out


def bott_dwsum(dt, u, z, e, band):
    """Row sums [...] of (psi - z) * e for the advection of z by u."""
    from ..kernels.build import load_library
    nkt, rows = _check(u, z)
    J = min(int(band), nkt)
    e = torch.as_tensor(e, dtype=z.dtype, device=z.device).contiguous()
    if e.shape != (nkt,):
        raise ValueError(f"e must be [{nkt}], got {tuple(e.shape)}")
    out = torch.empty(z.shape[:-1], dtype=z.dtype, device=z.device)
    name = "bott_dwsum_" + _SUFFIX[z.dtype]
    fn = getattr(load_library(), name)
    with torch.cuda.device(z.device):
        err = fn(ctypes.c_void_p(u.data_ptr()), ctypes.c_void_p(z.data_ptr()),
                 ctypes.c_void_p(e.data_ptr()),
                 ctypes.c_void_p(out.data_ptr()), rows, nkt, J, float(dt),
                 _stream(z))
    _raise_on(err, name)
    bott_dwsum.launches += 1
    return out


bott_advect.launches = 0
bott_dwsum.launches = 0


def reset_counts() -> None:
    bott_advect.launches = 0
    bott_dwsum.launches = 0
