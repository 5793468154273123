"""netCDF output through the native asynchronous writer.

Torch counterpart of ``mistra_tpu.io.netcdf``: the same files,
dimensions, variables, units and record cadence.  The reference writes
one netCDF file per variable group (grid, met, mic, chem_gas, chem_aq,
jrate; ``out_netCDF.f:30-102``) from inside the serial model loop.  Here
``native/mistra_io.cpp`` does it: a C++ background thread drains a
bounded queue of snapshots into libnetcdf (found with dlopen at run
time), so the step never blocks on disk (``mio_put_async``), and the
classic-format files stay readable by the reference's NCL scripts.

The port builds its own copy of the library from ``native/mistra_io.cpp``
with the host's C++ compiler (``$CXX``, else g++) at first use, into
``mistra_tpu_torch/_build/`` under a hash of the source and the flags;
it never writes into ``native/`` and never loads a library found there.
``available()`` is True only where that build succeeded and the library
found libnetcdf; otherwise the run harness takes the numpy writer
(``io/output.py``).

The writers take a batched state and write one column of it (``column``,
0 by default): each tensor is copied to the host as a contiguous float64
numpy array, which the native queue copies again before ``put`` returns.
"""

from __future__ import annotations

import ctypes as ct
import hashlib
import os
import shutil
import subprocess

import numpy as np

from ..chemistry.diagnostics import sulfur_reaction_channels
from ..kernels.build import BUILD_DIR, PKG_DIR
from ..physics.projection import oneD_dist
from .profiles import host

SOURCE = PKG_DIR.parent / "native" / "mistra_io.cpp"
# the flags of native/Makefile
CXXFLAGS = ["-O2", "-std=c++17", "-fPIC", "-Wall", "-Wextra"]
LDFLAGS = ["-shared", "-ldl", "-pthread"]
# the J-rate slots of the photolysis state
NPHRXN = 47

_LIB = None
_LIB_ERR = None


def library_path():
    h = hashlib.sha256(" ".join(CXXFLAGS + LDFLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libmistra_io_{h.hexdigest()[:16]}.so"


def build():
    """Compile native/mistra_io.cpp into _build/ unless the library for
    this source and these flags exists; returns its path."""
    so = library_path()
    if so.exists():
        return so
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("no C++ compiler (set CXX or put g++ on PATH)")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [cxx, *CXXFLAGS, "-o", str(tmp), str(SOURCE), *LDFLAGS]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed:\n{res.stderr}")
    os.replace(tmp, so)
    return so


def _load():
    global _LIB, _LIB_ERR
    if _LIB is not None or _LIB_ERR is not None:
        return _LIB
    try:
        lib = ct.CDLL(str(build()))
    except (OSError, RuntimeError, subprocess.SubprocessError) as exc:
        _LIB_ERR = exc
        return None
    lib.mio_available.restype = ct.c_int
    lib.mio_strerror.restype = ct.c_char_p
    lib.mio_strerror.argtypes = [ct.c_int]
    lib.mio_create.argtypes = [ct.c_char_p, ct.POINTER(ct.c_int)]
    lib.mio_open.argtypes = [ct.c_char_p, ct.POINTER(ct.c_int)]
    lib.mio_def_dim.argtypes = [ct.c_int, ct.c_char_p, ct.c_longlong,
                                ct.POINTER(ct.c_int)]
    lib.mio_def_var.argtypes = [ct.c_int, ct.c_char_p, ct.c_int,
                                ct.POINTER(ct.c_int), ct.POINTER(ct.c_int)]
    lib.mio_put_att.argtypes = [ct.c_int, ct.c_int, ct.c_char_p, ct.c_char_p]
    lib.mio_enddef.argtypes = [ct.c_int]
    lib.mio_inq_varid.argtypes = [ct.c_int, ct.c_char_p, ct.POINTER(ct.c_int)]
    lib.mio_inq_dimlen.argtypes = [ct.c_int, ct.c_char_p,
                                   ct.POINTER(ct.c_longlong)]
    for fn in ("mio_put", "mio_put_async", "mio_get"):
        getattr(lib, fn).argtypes = [
            ct.c_int, ct.c_int, ct.c_int, ct.POINTER(ct.c_longlong),
            ct.POINTER(ct.c_longlong), ct.POINTER(ct.c_double)]
    lib.mio_close.argtypes = [ct.c_int]
    lib.mio_drain.restype = ct.c_int
    lib.mio_pending_bytes.restype = ct.c_longlong
    if not lib.mio_available():
        _LIB_ERR = RuntimeError("libnetcdf not found by the native writer")
        return None
    _LIB = lib
    return lib


def available() -> bool:
    return _load() is not None


def unavailable_reason() -> str:
    """Why ``available()`` is False ("" where it is True)."""
    return "" if _load() is not None else str(_LIB_ERR)


def _check(lib, status: int, what: str):
    if status != 0:
        msg = lib.mio_strerror(status).decode()
        raise IOError(f"netCDF error in {what}: {msg} ({status})")


def _ll(arr):
    a = np.asarray(arr, dtype=np.int64)
    return a.ctypes.data_as(ct.POINTER(ct.c_longlong))


class NcFile:
    """One netCDF file (classic 64-bit-offset format, like the reference)."""

    def __init__(self, path: str):
        self.lib = _load()
        if self.lib is None:
            raise RuntimeError(f"native netCDF unavailable: {_LIB_ERR}")
        ncid = ct.c_int()
        _check(self.lib, self.lib.mio_create(path.encode(), ct.byref(ncid)),
               f"create {path}")
        self.ncid = ncid.value
        self.path = path
        self.dims: dict[str, int] = {}
        self.vars: dict[str, tuple[int, tuple]] = {}  # name -> (varid, dims)

    # -- definition phase ------------------------------------------------
    def def_dim(self, name: str, length: int | None) -> int:
        dimid = ct.c_int()
        ln = -1 if length is None else int(length)
        _check(self.lib, self.lib.mio_def_dim(
            self.ncid, name.encode(), ln, ct.byref(dimid)), f"def_dim {name}")
        self.dims[name] = dimid.value
        return dimid.value

    def def_var(self, name: str, dims: tuple[str, ...], units: str = "",
                long_name: str = ""):
        dimids = np.array([self.dims[d] for d in dims], dtype=np.int32)
        varid = ct.c_int()
        _check(self.lib, self.lib.mio_def_var(
            self.ncid, name.encode(), len(dims),
            dimids.ctypes.data_as(ct.POINTER(ct.c_int)), ct.byref(varid)),
            f"def_var {name}")
        if units:
            self.lib.mio_put_att(self.ncid, varid.value, b"units",
                                 units.encode())
        if long_name:
            self.lib.mio_put_att(self.ncid, varid.value, b"long_name",
                                 long_name.encode())
        self.vars[name] = (varid.value, dims)

    def enddef(self):
        _check(self.lib, self.lib.mio_enddef(self.ncid), "enddef")

    # -- data phase --------------------------------------------------------
    def put(self, name: str, data, record: int | None = None,
            async_: bool = True):
        """Write a variable (a host array); `record` indexes the unlimited
        dimension.  The async queue copies the data before it returns."""
        varid, dims = self.vars[name]
        data = np.ascontiguousarray(data, dtype=np.float64)
        if record is None:
            start = [0] * len(dims)
            count = list(data.shape) if data.ndim else [1]
        else:
            start = [record] + [0] * (len(dims) - 1)
            count = [1] + list(data.shape)
        fn = self.lib.mio_put_async if async_ else self.lib.mio_put
        _check(self.lib, fn(self.ncid, varid, len(dims), _ll(start),
                            _ll(count),
                            data.ctypes.data_as(ct.POINTER(ct.c_double))),
               f"put {name}")

    def drain(self):
        _check(self.lib, self.lib.mio_drain(), "drain")

    def close(self):
        """Close after every queued record of this file is written."""
        self.drain()
        _check(self.lib, self.lib.mio_close(self.ncid), f"close {self.path}")


class NcReader:
    """Minimal reader used by tests and the restart path."""

    def __init__(self, path: str):
        self.lib = _load()
        if self.lib is None:
            raise RuntimeError(f"native netCDF unavailable: {_LIB_ERR}")
        ncid = ct.c_int()
        _check(self.lib, self.lib.mio_open(path.encode(), ct.byref(ncid)),
               f"open {path}")
        self.ncid = ncid.value

    def dimlen(self, name: str) -> int:
        out = ct.c_longlong()
        _check(self.lib, self.lib.mio_inq_dimlen(self.ncid, name.encode(),
                                                 ct.byref(out)),
               f"dimlen {name}")
        return out.value

    def get(self, name: str, shape) -> np.ndarray:
        varid = ct.c_int()
        _check(self.lib, self.lib.mio_inq_varid(self.ncid, name.encode(),
                                                ct.byref(varid)),
               f"varid {name}")
        out = np.empty(shape, dtype=np.float64)
        start = [0] * out.ndim
        count = list(out.shape)
        _check(self.lib, self.lib.mio_get(
            self.ncid, varid.value, out.ndim, _ll(start), _ll(count),
            out.ctypes.data_as(ct.POINTER(ct.c_double))), f"get {name}")
        return out

    def close(self):
        self.lib.mio_close(self.ncid)


def output_mechanism(model):
    """The mechanism whose species the science output names: the tot
    mechanism of the multiphase driver, else the gas mechanism."""
    drv = model._chemistry
    return getattr(drv, "tot", drv.mech)


def budget_levels(cfg) -> np.ndarray:
    """The nlev_bud levels of the per-reaction budgets (rxn group)."""
    nf = cfg.grid.nf
    nlev = min(cfg.grid.nlev_bud, nf)
    return np.unique(np.linspace(1, nf - 1, nlev).astype(int))


class NetCDFOutputWriter:
    """Reference-layout science output: one netCDF file per group.

    Mirrors ``open_netcdf``/``write_netcdf`` (out_netCDF.f:30-102): files
    grid.nc, meteo.nc, mic.nc (+ part.nc), chem.nc, jrat.nc, nuc.nc and
    rxn.nc in ``outdir``, each with an unlimited time axis, of one column
    (``column``) of the batched state.  All record writes go through the
    native async queue.
    """

    def __init__(self, outdir: str, model, column: int = 0):
        os.makedirs(outdir, exist_ok=True)
        self.model = model
        self.outdir = outdir
        self.column = column
        self._irec = 0
        self._irec_part = 0
        self._irec_rxn = 0
        cfg = model.cfg
        n = cfg.grid.n
        nka, nkt = cfg.grid.nka, cfg.grid.nkt

        g = NcFile(os.path.join(outdir, "grid.nc"))
        atm, mic = model.grids.atm, model.grids.micro
        g.def_dim("n", n)
        g.def_dim("nka", nka)
        g.def_dim("nkt", nkt)
        g.def_dim("nrp", len(mic.rpw))
        g.def_var("eta", ("n",), "m", "layer mid heights")
        g.def_var("etw", ("n",), "m", "layer boundary heights")
        g.def_var("rn", ("nka",), "um", "dry aerosol bin radii")
        g.def_var("rq", ("nkt", "nka"), "um", "equivalent total radii")
        g.def_var("en", ("nka",), "mg", "dry aerosol bin masses")
        g.def_var("e", ("nkt",), "mg", "water bin masses")
        g.def_var("rpw", ("nrp",), "um", "1-D output radius grid")
        g.enddef()
        for nm, arr in (("eta", atm.eta), ("etw", atm.etw), ("rn", mic.rn),
                        ("rq", mic.rq), ("en", mic.en), ("e", mic.e),
                        ("rpw", mic.rpw)):
            g.put(nm, arr, async_=False)
        g.close()

        m = NcFile(os.path.join(outdir, "meteo.nc"))
        m.def_dim("time", None)
        m.def_dim("n", n)
        for nm, units in (("u", "m/s"), ("v", "m/s"), ("t", "K"),
                          ("theta", "K"), ("xm1", "kg/kg"), ("xm2", "kg/m3"),
                          ("feu", "1"), ("tke", "m2/s2"), ("rho", "kg/m3"),
                          ("p", "Pa"), ("dtrad", "K/s"), ("atkh", "m2/s")):
            m.def_var(nm, ("time", "n"), units)
        m.def_var("time", ("time",), "s")
        m.def_var("u0", ("time",), "1", "cos solar zenith")
        m.enddef()
        self.met = m

        self.mic = None
        self.part = None
        if cfg.mic:
            f = NcFile(os.path.join(outdir, "mic.nc"))
            f.def_dim("time", None)
            f.def_dim("n", n)
            f.def_dim("nrp1", len(mic.rpw) - 1)
            f.def_dim("nf", cfg.grid.nf)
            f.def_var("fsum", ("time", "n"), "1/cm3", "total particles")
            f.def_var("lcl", ("time",), "1", "cloud base index")
            f.def_var("lct", ("time",), "1", "cloud top index")
            f.def_var("part1D", ("time", "nrp1", "nf"), "1/cm3",
                      "projected 1-D size distribution")
            f.enddef()
            self.mic = f
            # the full 2-D spectrum has its own (30-min ploutp) cadence and
            # its own file: classic netCDF allows one unlimited dim per file
            p = NcFile(os.path.join(outdir, "part.nc"))
            p.def_dim("time", None)
            p.def_dim("nkt", nkt)
            p.def_dim("nka", nka)
            p.def_dim("n", n)
            p.def_var("ff", ("time", "nkt", "nka", "n"), "1/cm3",
                      "2-D particle spectrum")
            p.enddef()
            self.part = p

        self.chem = None
        self.jrat = None
        if model._chemistry is not None:
            species = output_mechanism(model).species
            with open(os.path.join(outdir, "species.txt"), "w") as f:
                f.write("\n".join(species) + "\n")
            c = NcFile(os.path.join(outdir, "chem.nc"))
            c.def_dim("time", None)
            c.def_dim("n", n)
            c.def_dim("nspec", len(species))
            c.def_var("conc", ("time", "nspec", "n"), "mol/m3",
                      "gas + aqueous-bin species (names in species.txt)")
            c.enddef()
            self.chem = c
            j = NcFile(os.path.join(outdir, "jrat.nc"))
            j.def_dim("time", None)
            j.def_dim("n", n)
            j.def_dim("nphrxn", NPHRXN)
            j.def_var("photol_j", ("time", "nphrxn", "n"), "1/s")
            j.enddef()
            self.jrat = j

        # nucleation diagnostics (reference nuc group; nucout1/2,
        # nuc.f90:1492-1687), with the nuc switch
        self.nuc = None
        if cfg.nuc:
            u = NcFile(os.path.join(outdir, "nuc.nc"))
            u.def_dim("time", None)
            u.def_dim("n", n)
            for nm, unit in (("xn_app", "1/(cm3 s)"),
                             ("xn_apacc", "1/cm3"),
                             ("grorate", "nm/h"),
                             ("dnucv", "mol/m3"),
                             ("concnuc", "1/cm3"),
                             ("j_real", "1/(cm3 s)")):
                u.def_var(nm, ("time", "n"), unit)
            u.enddef()
            self.nuc = u
            self._irec_nuc = 0

        # per-reaction budgets (C33; reference rxn group, bud_*.f), with
        # the reference's binout switch
        self.rxn = None
        if model._chemistry is not None and cfg.binout:
            mech = output_mechanism(model)
            self.bud_levels = budget_levels(cfg)
            r = NcFile(os.path.join(outdir, "rxn.nc"))
            r.def_dim("time", None)
            r.def_dim("nrxn", mech.nrxn)
            r.def_dim("nlev", len(self.bud_levels))
            r.def_var("level_index", ("nlev",), "1")
            r.def_var("rate", ("time", "nrxn", "nlev"), "mol/(m3 s)",
                      "instantaneous reaction rates")
            r.def_var("cum", ("time", "nrxn", "nlev"), "mol/m3",
                      "time-integrated reaction turnover")
            # S/DMS species budgets at all levels (bud_s_{g,a,t}.f:
            # /budgs/ bgs(2,122,n)); channels = every S-moving reaction
            self.s_channels, s_labels = sulfur_reaction_channels(mech)
            r.def_dim("nch_s", len(self.s_channels))
            r.def_dim("n", n)
            r.def_var("s_channel_rxn", ("nch_s",), "1",
                      "reaction index of each sulfur budget channel")
            r.def_var("s_rate", ("time", "nch_s", "n"), "mol/(m3 s)",
                      "instantaneous S-family reaction rates")
            r.def_var("s_cum", ("time", "nch_s", "n"), "mol/m3",
                      "time-integrated S-family reaction turnover")
            r.enddef()
            r.put("level_index", self.bud_levels.astype(float),
                  async_=False)
            r.put("s_channel_rxn", self.s_channels.astype(float),
                  async_=False)
            with open(os.path.join(outdir, "s_channels.txt"), "w") as fh:
                for i, lab in zip(self.s_channels, s_labels):
                    fh.write(f"{i} {lab}\n")
            self.rxn = r

    def write_nucleation(self, diag, xn_apacc):
        """Append one nucleation-diagnostics record (nucout1/2); diag's
        entries [B, n], xn_apacc [n] (the writer's column)."""
        if self.nuc is None:
            return
        for nm in ("xn_app", "grorate", "dnucv", "concnuc", "j_real"):
            self.nuc.put(nm, host(diag[nm], self.column),
                         record=self._irec_nuc)
        self.nuc.put("xn_apacc", xn_apacc, record=self._irec_nuc)
        self._irec_nuc += 1

    def write_budgets(self, inst, cum, s_inst=None, s_cum=None):
        """Append one budget record (host arrays [nrxn, nlev]; S-family
        arrays [nch_s, n])."""
        if self.rxn is None:
            return
        self.rxn.put("rate", inst, record=self._irec_rxn)
        self.rxn.put("cum", cum, record=self._irec_rxn)
        if s_inst is not None:
            self.rxn.put("s_rate", s_inst, record=self._irec_rxn)
            self.rxn.put("s_cum", s_cum, record=self._irec_rxn)
        self._irec_rxn += 1

    # ------------------------------------------------------------------
    def snapshot(self, state, particles: bool = False):
        """Write one 15-min record of the writer's column (the 2-D
        spectrum too with particles, every 30 min)."""
        c = self.column
        i = self._irec
        met = state.met
        m = self.met
        m.put("time", host(state.tim.time, c), record=i)
        m.put("u0", host(state.rad.u0, c), record=i)
        for nm in ("u", "v", "t", "theta", "xm1", "xm2", "feu", "tke",
                   "rho", "p"):
            m.put(nm, host(getattr(met, nm), c), record=i)
        m.put("dtrad", host(state.rad.dtrad, c), record=i)
        m.put("atkh", host(state.turb.atkh, c), record=i)

        if self.mic is not None:
            mic = state.micro
            self.mic.put("fsum", host(mic.fsum, c), record=i)
            self.mic.put("lcl", host(mic.lcl, c), record=i)
            self.mic.put("lct", host(mic.lct, c), record=i)
            part1d = oneD_dist(mic.ff[c:c + 1], self.model.grids.micro,
                               self.model.cfg.grid.nf)
            self.mic.put("part1D", host(part1d, 0), record=i)
            if particles and self.part is not None:
                self.part.put("ff", host(mic.ff, c), record=self._irec_part)
                self._irec_part += 1

        if self.chem is not None and state.chem is not None:
            self.chem.put("conc", host(state.chem.sgas, c), record=i)
            self.jrat.put("photol_j", host(state.chem.photol_j, c),
                          record=i)
        self._irec += 1

    def close(self):
        for f in (self.met, self.mic, self.part, self.chem, self.jrat,
                  self.rxn, self.nuc):
            if f is not None:
                f.close()
