"""The yardstick of the kernels' roofline shares, frozen here.

Copied from ``chip_smoke.py`` at commit b2518445: the peaks (lines
233-234), the Bott kernels' operation counts (239-240), ``bound``
(492-498) and ``bott_bounds`` (501-510); the inverse's bytes and
operations from ``compare_inverse`` (line 1019).  A later change to a
kernel does not change what its share is measured against.

A least time is the larger of the bytes over the HBM rate and the
operations over the peak rate of the dtype; each input byte is counted
once and each output byte once, and where the work depends on the data
(the Bott kernels' significant bins) the count is that of the launch's
own inputs.  The peaks are the published ones of one NVIDIA H100 SXM
(data sheet, at 700 W): 3.35 TB/s of HBM, 67 TFLOP/s of float32 outside
the tensor cores, and 67 TFLOP/s of float64 at the tensor cores' rate.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "float64": 67e12}
# a divide and an add per bin and direction for the prefix sums, and about
# 100 per significant source bin for the searched walk (~30) and the
# order-4 Bott split (~70); the deposit's few compares and adds per bin
# are left out (a lower bound)
BOTT_SCAN_OPS_PER_BIN = 4
BOTT_OPS_PER_SOURCE = 100
# a bin holds a significant source from this many particles on (growth.YMIN)
YMIN = 1.0e-32


def least_seconds(nbytes: float, ops: float, dtype: str) -> float:
    """The least time of a launch: bytes over the memory rate or
    operations over the dtype's peak, the larger."""
    return max(nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[dtype])


def bott_ops(rows: int, nkt: int, significant: int) -> float:
    return (BOTT_SCAN_OPS_PER_BIN * rows * nkt
            + BOTT_OPS_PER_SOURCE * significant)


def bott_advect_seconds(rows: int, nkt: int, significant: int, elt: int,
                        dtype: str) -> float:
    """advect reads u and z and writes psi, rows x nkt each."""
    return least_seconds(3 * rows * nkt * elt,
                         bott_ops(rows, nkt, significant), dtype)


def bott_dwsum_seconds(rows: int, nkt: int, significant: int, elt: int,
                       dtype: str) -> float:
    """dwsum reads u, z (rows x nkt) and e (nkt) and writes one value per
    row."""
    return least_seconds((2 * rows * nkt + nkt + rows) * elt,
                         bott_ops(rows, nkt, significant), dtype)


def inverse_seconds(n: int, m: int, elt: int, dtype: str) -> float:
    """The batched inverse of [n, m, m]: reads and writes n m^2 values, and
    Gauss-Jordan takes 2 m^3 operations per matrix."""
    return least_seconds(2 * n * m * m * elt, 2.0 * n * m ** 3, dtype)
