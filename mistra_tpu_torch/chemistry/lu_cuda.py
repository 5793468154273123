"""Wrapper of the hand-written CUDA batched inverse (csrc/lu.cu).

``batched_inv`` replaces both Pallas kernels of
``mistra_tpu/chemistry/lu_pallas.py`` (``_lu_kernel``, the forward
elimination, and ``_inv_kernel``, the inverse from the packed LU) with one
kernel: Gauss-Jordan with partial pivoting, one thread block per matrix,
the matrix in shared memory.  Its plain torch version is
``lu.batched_inv_plain``.

It takes a contiguous CUDA tensor [N, m, m] of float32 or float64 whose
matrix fits in a block's shared memory (m <= 238 in float32, m <= 168 in
float64) and raises on anything else.  Each launch goes on the current
stream and adds one to ``batched_inv.launches``.  The library is built by
nvcc at first use (``kernels.build``), never at import.
"""

from __future__ import annotations

import ctypes

import torch

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
# the shared memory a block may use on Hopper (227 KB)
_SMEM_BYTES = 232448


def smem_bytes(m: int, itemsize: int) -> int:
    """Dynamic shared memory of one block for an m x m matrix: the matrix,
    the pivot row and the multiplier column, the used-row flags and the
    pivot order, and 32 (value, index) pairs of the pivot search."""
    return (m * m + 2 * m) * itemsize + 2 * m * 4 + 32 * (itemsize + 4)


def _check(a):
    if not a.is_cuda:
        raise ValueError("lu_cuda.batched_inv takes a CUDA tensor")
    if a.dtype not in _SUFFIX:
        raise TypeError(f"lu_cuda.batched_inv takes float32 or float64, "
                        f"got {a.dtype}")
    if a.dim() != 3 or a.shape[1] != a.shape[2] or a.shape[1] < 1:
        raise ValueError(f"lu_cuda.batched_inv takes [N, m, m], got "
                         f"{tuple(a.shape)}")
    if not a.is_contiguous():
        raise ValueError("lu_cuda.batched_inv takes a contiguous tensor")
    m = a.shape[1]
    need = smem_bytes(m, a.element_size())
    if need > _SMEM_BYTES:
        raise ValueError(f"m={m} {a.dtype} needs {need} bytes of shared "
                         f"memory, more than a block's {_SMEM_BYTES}")
    return a.shape[0], m


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def batched_inv(a: torch.Tensor) -> torch.Tensor:
    """inv(A) [N, m, m] of a contiguous CUDA batch [N, m, m]."""
    from ..kernels.build import load_library
    n, m = _check(a)
    out = torch.empty_like(a)
    if n == 0:
        return out
    name = "batched_inv_" + _SUFFIX[a.dtype]
    fn = getattr(load_library(), name)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(ctypes.c_void_p(a.data_ptr()),
                 ctypes.c_void_p(out.data_ptr()), n, m,
                 ctypes.c_void_p(stream))
    _raise_on(err, name)
    batched_inv.launches += 1
    return out


batched_inv.launches = 0


def reset_counts() -> None:
    batched_inv.launches = 0
