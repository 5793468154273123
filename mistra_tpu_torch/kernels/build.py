"""Build the CUDA sources of ``csrc/`` with nvcc and load them with ctypes.

The sources have a plain C interface (no PyTorch headers): one nvcc per
source compiles them all at once, in parallel, and one more links the
objects into one shared library, in seconds.  The library is cached in
``mistra_tpu_torch/_build/`` under a hash of the sources and the flags,
built at first use and never at import: the package imports on a machine
without nvcc or a GPU.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

# sm_90a (Hopper); -fmad=false keeps every multiply and add separately
# rounded, as in the plain torch versions the kernels are held against
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-fmad=false", "-Xcompiler",
                           "-fPIC", "-Xptxas", "-v"]

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
# C signatures of csrc/bott.cu, csrc/lu.cu and csrc/sed.cu
_SIGNATURES = {
    "bott_advect_f32": [_P, _P, _P, _I, _I, _I, _D, _P],
    "bott_advect_f64": [_P, _P, _P, _I, _I, _I, _D, _P],
    "bott_dwsum_f32": [_P, _P, _P, _P, _I, _I, _I, _D, _P],
    "bott_dwsum_f64": [_P, _P, _P, _P, _I, _I, _I, _D, _P],
    "batched_inv_f32": [_P, _P, _I, _I, _P],
    "batched_inv_f64": [_P, _P, _I, _I, _P],
    "batched_inv_plan_f32": [_I, _P],
    "batched_inv_plan_f64": [_I, _P],
    "sed_advect_f32": [_P] * 7 + [_I, _I, _I, _P],
    "sed_advect_f64": [_P] * 7 + [_I, _I, _I, _P],
}

_lib = None
# filled by the build that produced the loaded library (None when cached)
build_seconds = None
ptxas_log = ""


def sources() -> list:
    return sorted(CSRC_DIR.glob("*.cu"))


def nvcc_path() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return found


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libmistra_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile csrc/*.cu unless the library for these sources exists: one
    nvcc per source, all started together, then one link."""
    global build_seconds, ptxas_log
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    jobs = []
    for src in sources():
        obj = tmp.with_name(f"{tmp.name}.{src.stem}.o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    # wait for every compile before looking at any, so that no nvcc is
    # left running when one fails
    logs = [proc.communicate()[1] for _, _, proc in jobs]
    for (cmd, _, proc), err in zip(jobs, logs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n{err}")
    objs = [str(obj) for _, obj, _ in jobs]
    cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *objs]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n{res.stderr}")
    for obj in objs:
        os.remove(obj)
    os.replace(tmp, so)
    build_seconds = time.perf_counter() - t0
    ptxas_log = "".join(logs)
    return so


def load_library() -> ctypes.CDLL:
    """The kernel library, built on first use and loaded once."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib
