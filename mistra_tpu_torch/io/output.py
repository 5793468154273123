"""Science output in numpy files, for hosts without libnetcdf.

Torch counterpart of ``mistra_tpu.io.output``: the JAX package's writer
puts the groups of the reference's netCDF output (``out_netCDF.f``:
grid / met / mic / chem_gas / chem_aq / jrate) into one HDF5 file.  The
port keeps those groups, datasets and cadences (15-min snapshots, the 2-D
spectrum every 30 min; str.f90:479-508) but needs no h5py: each dataset
is one ``.npy`` file, ``<dir>/<group>/<name>.npy``, whose leading (time)
axis grows on disk with every record; nothing of the run is held in
memory.  ``read_output`` reads a directory back as {group: {name:
array}}.  Like the netCDF writer, it also carries the reaction budgets
(``rxn``, with binout) and the nucleation diagnostics (``nuc``, with
nuc).  The writer takes a batched state and writes one column of it.
"""

from __future__ import annotations

import os

import numpy as np

from ..chemistry.diagnostics import sulfur_reaction_channels
from ..physics.projection import oneD_dist
from .netcdf import budget_levels, output_mechanism
from .profiles import host

_MAGIC = b"\x93NUMPY\x01\x00"
# the whole header, magic included: room for any record count and shape
_HEADER_BYTES = 128


def _header(dtype, shape) -> bytes:
    d = {"descr": np.lib.format.dtype_to_descr(np.dtype(dtype)),
         "fortran_order": False, "shape": tuple(shape)}
    text = repr(d).encode("latin1")
    room = _HEADER_BYTES - len(_MAGIC) - 2 - 1
    if len(text) > room:
        raise ValueError(f"npy header of shape {shape} too long")
    text = text + b" " * (room - len(text)) + b"\n"
    return _MAGIC + len(text).to_bytes(2, "little") + text


class NpyAppender:
    """An ``.npy`` file whose leading axis grows by one record per
    ``append``: the record goes to the end of the file, then the header's
    count is rewritten in place."""

    def __init__(self, path: str, record):
        self.path = path
        self.dtype = record.dtype
        self.shape = record.shape
        self.n = 0
        self.fh = open(path, "wb+")
        self.fh.write(_header(self.dtype, (0,) + self.shape))

    def append(self, record):
        if record.shape != self.shape:
            raise ValueError(f"{self.path}: record {record.shape}, "
                             f"file {self.shape}")
        self.fh.seek(0, os.SEEK_END)
        self.fh.write(np.ascontiguousarray(record, self.dtype).tobytes())
        self.n += 1
        self.fh.seek(0)
        self.fh.write(_header(self.dtype, (self.n,) + self.shape))
        self.fh.flush()

    def close(self):
        self.fh.close()


def read_output(path: str) -> dict:
    """{group: {dataset: array}} of a directory the numpy writer wrote."""
    out = {}
    for group in sorted(os.listdir(path)):
        gdir = os.path.join(path, group)
        if not os.path.isdir(gdir):
            continue
        out[group] = {f[:-4]: np.load(os.path.join(gdir, f))
                      for f in sorted(os.listdir(gdir)) if f.endswith(".npy")}
    return out


class OutputWriter:
    """Appends time records of one column (``column``) of the state to the
    numpy files under the directory ``path``."""

    def __init__(self, path: str, model, column: int = 0):
        os.makedirs(path, exist_ok=True)
        self.path = path
        self.model = model
        self.column = column
        self._files: dict[str, NpyAppender] = {}
        self._write_grid()
        # the budget and nucleation groups' directories, where written
        self.rxn = None
        self.nuc = os.path.join(path, "nuc") if model.cfg.nuc else None
        if model._chemistry is not None and model.cfg.binout:
            mech = output_mechanism(model)
            self.bud_levels = budget_levels(model.cfg)
            self.s_channels, _ = sulfur_reaction_channels(mech)
            self.rxn = os.path.join(path, "rxn")
            self._save("rxn", "level_index", self.bud_levels)
            self._save("rxn", "s_channel_rxn", self.s_channels)

    # ------------------------------------------------------------------
    def _save(self, group, name, arr):
        os.makedirs(os.path.join(self.path, group), exist_ok=True)
        np.save(os.path.join(self.path, group, f"{name}.npy"), arr)

    def _write_grid(self):
        atm = self.model.grids.atm
        mic = self.model.grids.micro
        for name, arr in [("eta", atm.eta), ("etw", atm.etw),
                          ("detw", atm.detw), ("deta", atm.deta),
                          ("rn", mic.rn), ("rq", mic.rq), ("rw", mic.rw),
                          ("en", mic.en), ("e", mic.e), ("rpw", mic.rpw)]:
            self._save("grid", name, np.asarray(arr))
        if self.model._chemistry is not None:
            self._save("grid", "gas_species", np.array(
                self.model._chemistry.mech.species, dtype="S"))

    def _append(self, group: str, name: str, arr):
        """Append one record; arr a host array or one column's tensor."""
        key = f"{group}/{name}"
        arr = np.asarray(arr)
        f = self._files.get(key)
        if f is None:
            os.makedirs(os.path.join(self.path, group), exist_ok=True)
            f = NpyAppender(os.path.join(self.path, group, f"{name}.npy"),
                            arr)
            self._files[key] = f
        f.append(arr)

    # ------------------------------------------------------------------
    def snapshot(self, state, particles: bool = False):
        """Write one 15-min snapshot (particle spectra optional, 30-min)."""
        c = self.column
        met = state.met
        self._append("met", "time", host(state.tim.time, c))
        for name in ("u", "v", "t", "theta", "xm1", "xm2", "feu", "tke",
                     "rho", "p"):
            self._append("met", name, host(getattr(met, name), c))
        self._append("met", "dtrad", host(state.rad.dtrad, c))
        self._append("met", "u0", host(state.rad.u0, c))
        self._append("met", "atkh", host(state.turb.atkh, c))

        if self.model.cfg.mic:
            mic = state.micro
            self._append("mic", "fsum", host(mic.fsum, c))
            self._append("mic", "lcl", host(mic.lcl, c))
            self._append("mic", "lct", host(mic.lct, c))
            part1d = oneD_dist(mic.ff[c:c + 1], self.model.grids.micro,
                               self.model.cfg.grid.nf)
            self._append("mic", "part1D", host(part1d, 0))
            if particles:
                self._append("mic", "ff", host(mic.ff, c))

        if state.chem is not None:
            self._append("chem_gas", "sgas", host(state.chem.sgas, c))
            self._append("jrate", "photol_j", host(state.chem.photol_j, c))

    def write_budgets(self, inst, cum, s_inst=None, s_cum=None):
        """Append one budget record (host arrays [nrxn, nlev]; S-family
        arrays [nch_s, n])."""
        if self.rxn is None:
            return
        self._append("rxn", "rate", inst)
        self._append("rxn", "cum", cum)
        if s_inst is not None:
            self._append("rxn", "s_rate", s_inst)
            self._append("rxn", "s_cum", s_cum)

    def write_nucleation(self, diag, xn_apacc):
        """Append one nucleation-diagnostics record (nucout1/2)."""
        if self.nuc is None:
            return
        for nm in ("xn_app", "grorate", "dnucv", "concnuc", "j_real"):
            self._append("nuc", nm, host(diag[nm], self.column))
        self._append("nuc", "xn_apacc", xn_apacc)

    def close(self):
        for f in self._files.values():
            f.close()
