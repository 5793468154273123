"""Wrapper of the hand-written CUDA batched inverse (csrc/lu.cu).

``batched_inv`` replaces both Pallas kernels of
``mistra_tpu/chemistry/lu_pallas.py`` (``_lu_kernel``, the forward
elimination, and ``_inv_kernel``, the inverse from the packed LU) with one
kernel: Gauss-Jordan with partial pivoting, one thread block per matrix.
Its plain torch version is ``lu.batched_inv_plain``.

Two variants, chosen by m alone (``launch_plan``, which the C side
mirrors; ``kernel_plan`` reads that side's plan):

* ``"regs"``, 1 <= m <= 128: the matrix in registers.  A block of tx
  warps (8 up to m = 80, 16 above) owns one matrix; lane l of warp w
  holds the ry x rx tile of rows l + 32 a and columns w + tx b, the
  smallest of ``TILES`` that covers m.  A few tens of KB of shared memory
  hold the pivot column, the scaled pivot row and a strip of 32 rows that
  the input and output pass through;
* ``"smem"``, 128 < m <= 168 (float64) or 238 (float32): the matrix in a
  block's shared memory, 256 threads.

It takes a contiguous CUDA tensor [N, m, m] of float32 or float64 with m
in those ranges and raises on anything else; ``out=`` names a contiguous
tensor of the same shape to write the inverse into (a buffer that a CUDA
graph reads).  Each launch goes on the
current stream and adds one to ``batched_inv.launches``.  The library is
built by nvcc at first use (``kernels.build``), never at import.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
# the shared memory a block may use on Hopper (227 KB)
_SMEM_BYTES = 232448
# the register tiles of csrc/lu.cu (kTiles): the largest m each takes, its
# warps and its tile rows x columns per thread
TILES = ((32, 8, 1, 4), (64, 8, 2, 8), (80, 8, 3, 10), (96, 16, 3, 6),
         (112, 16, 4, 7), (128, 16, 4, 8))
_SMEM_THREADS = 256


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How csrc/lu.cu inverts m x m matrices: the variant, the thread grid
    of ty lanes (rows) x tx warps (columns) and the tile ry x rx of each
    thread (zeros for "smem"), the threads and the dynamic shared memory
    of one block."""
    variant: str
    ty: int
    tx: int
    ry: int
    rx: int
    threads: int
    smem_bytes: int


def launch_plan(m: int, dtype: torch.dtype) -> LaunchPlan:
    """The plan for m x m matrices of dtype; ValueError if no variant
    takes m."""
    if dtype not in _SUFFIX:
        raise TypeError(f"lu_cuda.batched_inv takes float32 or float64, "
                        f"got {dtype}")
    itemsize = torch.finfo(dtype).bits // 8
    if m < 1:
        raise ValueError(f"lu_cuda.batched_inv takes m >= 1, got {m}")
    for max_m, nw, ry, rx in TILES:
        if m <= max_m:
            # the strip (32 rows of stride m | 1) holds the step buffers:
            # two pivot columns, the warps' scaled rows, two (pivot,
            # 1 / pivot); then two pivot rows, perm and iperm (int32)
            values = max(32 * (m | 1), 2 * 32 * ry + nw * rx + 4)
            return LaunchPlan("regs", 32, nw, ry, rx, 32 * nw,
                              values * itemsize + (2 + 2 * m) * 4)
    # the matrix, the pivot row and the multiplier column, the used-row
    # flags and the pivot order, and 32 (value, index) pairs of the search
    smem = (m * m + 2 * m) * itemsize + 2 * m * 4 + 32 * (itemsize + 4)
    if smem > _SMEM_BYTES:
        raise ValueError(f"m={m} {dtype} needs {smem} bytes of shared "
                         f"memory, more than a block's {_SMEM_BYTES}")
    return LaunchPlan("smem", 0, 0, 0, 0, _SMEM_THREADS, smem)


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
    launch_plan(a.shape[1], a.dtype)
    return a.shape[0], a.shape[1]


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def kernel_plan(m: int, dtype: torch.dtype) -> dict:
    """The C side's plan for m (needs the built library and a card): the
    fields of LaunchPlan and the blocks that fit on one SM
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    from ..kernels.build import load_library
    name = "batched_inv_plan_" + _SUFFIX[dtype]
    buf = (ctypes.c_int * 8)()
    _raise_on(getattr(load_library(), name)(m, buf), name)
    variant, ty, tx, ry, rx, threads, smem, blocks = list(buf)
    return {"plan": LaunchPlan(("regs", "smem")[variant], ty, tx, ry, rx,
                               threads, smem),
            "blocks_per_sm": blocks}


def batched_inv(a: torch.Tensor, out: torch.Tensor | None = None
                ) -> torch.Tensor:
    """inv(A) [N, m, m] of a contiguous CUDA batch [N, m, m], into out (a
    contiguous tensor of a's shape, dtype and device) if given."""
    from ..kernels.build import load_library
    n, m = _check(a)
    if out is None:
        out = torch.empty_like(a)
    elif (out.shape != a.shape or out.dtype != a.dtype
          or out.device != a.device or not out.is_contiguous()):
        raise ValueError("lu_cuda.batched_inv: out must be a contiguous "
                         f"{tuple(a.shape)} {a.dtype} tensor on {a.device}")
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
