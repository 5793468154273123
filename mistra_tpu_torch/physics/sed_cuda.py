"""Wrappers of the hand-written CUDA sedimentation kernel (csrc/sed.cu).

The kernel replaces no TPU kernel: it takes the level loop of
``sedimentation.advsed1`` (~3,600 elementwise launches per call) into
one launch.

* ``advsed`` advects each row of y [..., nf] by its Courant numbers c:
  Bott's form (``advsed1``) or, where ``upstream`` is set, the upstream
  form (``advsed0``);
* ``advsed_splits`` makes sedl's fixed Courant splits of psi in one
  launch and returns psi with each row's ground deposit
  (``sedimentation.advsed1_splits_plain``).

Both take CUDA tensors only, in float32 or float64, contiguous, of one
dtype and device, with 3 <= nf <= 400, and raise on anything else; the
results are bit-equal to the plain versions on the card.  Each launch goes
on the current stream and adds one to the wrapper's ``launches`` counter.
The library is built by nvcc at first use (``kernels.build``), never at
import.
"""

from __future__ import annotations

import ctypes

import torch

from .bott_cuda import _raise_on, _stream

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
MAX_LEVELS = 400


def _check(c, y):
    if y.dtype not in _SUFFIX or c.dtype != y.dtype:
        raise TypeError(f"sed_cuda kernels take float32 or float64 c and y "
                        f"of one dtype, got {c.dtype} and {y.dtype}")
    if c.shape != y.shape or y.dim() < 1:
        raise ValueError(f"c and y must have one shape [..., nf], got "
                         f"{tuple(c.shape)} and {tuple(y.shape)}")
    if not (c.is_contiguous() and y.is_contiguous()):
        raise ValueError("sed_cuda kernels take contiguous tensors")
    nf = y.shape[-1]
    if not 3 <= nf <= MAX_LEVELS:
        raise ValueError(f"nf={nf} outside 3..{MAX_LEVELS}")
    rows = y.numel() // nf
    if y.numel() >= 2 ** 31:
        raise ValueError(f"{rows} rows of {nf} levels exceed 2**31 values")
    return nf, rows


def _check_rows(x, y, name, dtype):
    """x: one value per row of y, contiguous."""
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if x.shape != y.shape[:-1]:
        raise ValueError(f"{name} must have shape {tuple(y.shape[:-1])}, "
                         f"got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_device(y, *others):
    if not (y.is_cuda and all(x.device == y.device for x in others)):
        raise ValueError("sed_cuda kernels take CUDA tensors on one device")


def _ptr(t):
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _launch(c, y, upstream, xxxt, dt0, out, ground, rows, nf, nsplit):
    from ..kernels.build import load_library
    name = "sed_advect_" + _SUFFIX[y.dtype]
    fn = getattr(load_library(), name)
    with torch.cuda.device(y.device):
        err = fn(_ptr(c), _ptr(y), _ptr(upstream), _ptr(xxxt), _ptr(dt0),
                 _ptr(out), _ptr(ground), rows, nf, nsplit, _stream(y))
    _raise_on(err, name)


def advsed(c, y, upstream):
    """Each row of y [..., nf] advected by its Courant numbers c [..., nf]:
    ``advsed0`` where the bool ``upstream`` [...] is set, ``advsed1``
    elsewhere."""
    nf, rows = _check(c, y)
    _check_rows(upstream, y, "upstream", torch.bool)
    _check_device(y, c, upstream)
    out = torch.empty_like(y)
    _launch(c, y, upstream, None, None, out, None, rows, nf, 0)
    advsed.launches += 1
    return out


def advsed_splits(c, psi, xxxt, dt0, nsplit):
    """sedl's ``nsplit`` Courant splits of psi [..., nf] in one launch:
    (psi, ground [...]) as ``sedimentation.advsed1_splits_plain``."""
    nf, rows = _check(c, psi)
    for x, name in ((xxxt, "xxxt"), (dt0, "dt0")):
        _check_rows(x, psi, name, psi.dtype)
    nsplit = int(nsplit)
    if nsplit < 1:
        raise ValueError(f"nsplit={nsplit} must be at least 1")
    _check_device(psi, c, xxxt, dt0)
    out = torch.empty_like(psi)
    ground = torch.empty(psi.shape[:-1], dtype=psi.dtype, device=psi.device)
    _launch(c, psi, None, xxxt, dt0, out, ground, rows, nf, nsplit)
    advsed_splits.launches += 1
    return out, ground


advsed.launches = 0
advsed_splits.launches = 0


def reset_counts() -> None:
    advsed.launches = 0
    advsed_splits.launches = 0
