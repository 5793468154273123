"""The port's science output against the JAX package's.

- ``io.netcdf.NetCDFOutputWriter`` against JAX's on the same state (two
  snapshots, a budget record and a nucleation record): every variable of
  every file within 1e-12 of its scale (skipped where the native library
  or libnetcdf is unavailable, as tests/test_io_native.py is);
- the numpy ``io.output.OutputWriter`` read back equal to the state it
  was given, with the JAX HDF5 writer's groups and datasets;
- the native library builds into ``mistra_tpu_torch/_build`` from
  ``native/mistra_io.cpp`` and nothing under ``native/`` changes.
"""

from __future__ import annotations

import hashlib
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_parity import foggy, make_models, to_numpy, to_port_columns
from mistra_tpu.io import netcdf as jnc
from mistra_tpu_torch.io import netcdf as tnc
from mistra_tpu_torch.io.output import OutputWriter, read_output
from mistra_tpu_torch.physics.projection import oneD_dist

ROOT = Path(__file__).resolve().parent.parent
NUC = ("xn_app", "grorate", "dnucv", "concnuc", "j_real")


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """(JAX model, port model, JAX state, port state of two columns whose
    column 1 is the JAX state) with the multiphase chemistry, binout and
    the nuc switch on (the writers read only the switch)."""
    inp = tmp_path_factory.mktemp("inp")
    mech = tmp_path_factory.mktemp("mech")
    jm, tm, js = make_models(inp, radiation=True, mechdir=mech,
                             multiphase=True)
    tm.init_state(1)
    for m in (jm, tm):
        m.cfg.binout = True
        m.cfg.nuc = True
    jf = foggy(js, jm.cfg.grid.nf, seed=4)
    return jm, tm, jf, to_port_columns([js, jf])


def records(writer, n, nrxn_lev, nch, column=None, seed=0):
    """Budget and nucleation records of seeded random numbers; with column,
    the nucleation diagnostics as [2, n] tensors holding them there."""
    rng = np.random.default_rng(seed)
    inst, cum = (rng.uniform(0, 1e-9, nrxn_lev) for _ in range(2))
    s_inst, s_cum = (rng.uniform(0, 1e-9, (nch, n)) for _ in range(2))
    diag = {k: rng.uniform(0, 10, n) for k in NUC}
    if column is not None:
        diag = {k: torch.from_numpy(np.stack([v * 0.5, v])) for k, v in
                diag.items()}
    writer.write_budgets(inst, cum, s_inst, s_cum)
    writer.write_nucleation(diag, rng.uniform(0, 1e3, n))
    return inst, cum, s_inst, s_cum


@pytest.mark.skipif(not (tnc.available() and jnc.available()),
                    reason="native netCDF library or libnetcdf unavailable")
def test_netcdf_writer_matches_jax(models, tmp_path):
    jm, tm, jf, ts = models
    jw = jnc.NetCDFOutputWriter(str(tmp_path / "jax"), jm)
    tw = tnc.NetCDFOutputWriter(str(tmp_path / "port"), tm, column=1)
    assert list(tw.bud_levels) == list(jw.bud_levels)
    assert list(tw.s_channels) == list(jw.s_channels)
    g = jm.cfg.grid
    n, nka, nkt, nf = g.n, g.nka, g.nkt, g.nf
    nrxn = jm._chemistry.tot.nrxn
    nlev, nch = len(jw.bud_levels), len(jw.s_channels)
    for particles in (True, False):
        jw.snapshot(jf, particles=particles)
        tw.snapshot(ts, particles=particles)
    records(jw, n, (nrxn, nlev), nch)
    records(tw, n, (nrxn, nlev), nch, column=1)
    jw.close()
    tw.close()
    nspec = len((tmp_path / "port" / "species.txt").read_text().split())
    files = {
        "grid.nc": {"eta": (n,), "etw": (n,), "rn": (nka,),
                    "rq": (nkt, nka), "en": (nka,), "e": (nkt,),
                    "rpw": (nka,)},
        "meteo.nc": {**{k: (2, n) for k in (
            "u", "v", "t", "theta", "xm1", "xm2", "feu", "tke", "rho", "p",
            "dtrad", "atkh")}, "time": (2,), "u0": (2,)},
        "mic.nc": {"fsum": (2, n), "lcl": (2,), "lct": (2,),
                   "part1D": (2, nka - 1, nf)},
        "part.nc": {"ff": (1, nkt, nka, n)},
        "chem.nc": {"conc": (2, nspec, n)},
        "jrat.nc": {"photol_j": (2, tnc.NPHRXN, n)},
        "rxn.nc": {"level_index": (nlev,), "s_channel_rxn": (nch,),
                   "rate": (1, nrxn, nlev), "cum": (1, nrxn, nlev),
                   "s_rate": (1, nch, n), "s_cum": (1, nch, n)},
        "nuc.nc": {k: (1, n) for k in NUC + ("xn_apacc",)},
    }
    for name, shapes in files.items():
        ra = tnc.NcReader(str(tmp_path / "jax" / name))
        rb = tnc.NcReader(str(tmp_path / "port" / name))
        for k, shape in shapes.items():
            a, b = ra.get(k, shape), rb.get(k, shape)
            scale = max(np.abs(a).max(), 1e-300)
            assert np.abs(a - b).max() <= 1e-12 * scale, (name, k)
        ra.close()
        rb.close()
    for name in ("species.txt", "s_channels.txt"):
        assert (tmp_path / "jax" / name).read_text() == \
            (tmp_path / "port" / name).read_text()


def test_numpy_writer_reads_back_the_state(models, tmp_path):
    jm, tm, jf, ts = models
    w = OutputWriter(str(tmp_path / "out"), tm, column=1)
    for particles in (True, False):
        w.snapshot(ts, particles=particles)
    g = tm.cfg.grid
    nrxn = tm._chemistry.tot.nrxn
    nlev, nch = len(w.bud_levels), len(w.s_channels)
    inst, cum, s_inst, s_cum = records(w, g.n, (nrxn, nlev), nch, column=1)
    w.close()
    out = read_output(str(tmp_path / "out"))
    # the JAX HDF5 writer's groups and datasets, plus rxn and nuc
    assert set(out) == {"grid", "met", "mic", "chem_gas", "jrate", "rxn",
                        "nuc"}
    assert set(out["met"]) == {"time", "u", "v", "t", "theta", "xm1",
                               "xm2", "feu", "tke", "rho", "p", "dtrad",
                               "u0", "atkh"}
    assert set(out["mic"]) == {"fsum", "lcl", "lct", "part1D", "ff"}
    assert set(out["grid"]) == {"eta", "etw", "detw", "deta", "rn", "rq",
                                "rw", "en", "e", "rpw", "gas_species"}
    col = to_numpy(jf)
    for name in ("u", "t", "xm1", "tke", "p"):
        np.testing.assert_array_equal(out["met"][name],
                                      np.stack([getattr(col.met, name)] * 2))
    np.testing.assert_array_equal(out["met"]["time"], [col.tim.time] * 2)
    np.testing.assert_array_equal(out["met"]["atkh"],
                                  np.stack([col.turb.atkh] * 2))
    np.testing.assert_array_equal(out["mic"]["ff"], col.micro.ff[None])
    assert out["mic"]["lcl"].dtype == np.int32
    p1 = oneD_dist(ts.micro.ff, tm.grids.micro, g.nf)[1].numpy()
    np.testing.assert_array_equal(out["mic"]["part1D"], np.stack([p1] * 2))
    np.testing.assert_array_equal(out["chem_gas"]["sgas"],
                                  np.stack([col.chem.conc] * 2))
    np.testing.assert_array_equal(out["jrate"]["photol_j"],
                                  np.stack([col.chem.photol_j] * 2))
    np.testing.assert_array_equal(out["rxn"]["rate"], inst[None])
    np.testing.assert_array_equal(out["rxn"]["s_cum"], s_cum[None])
    np.testing.assert_array_equal(out["grid"]["rq"], tm.grids.micro.rq)
    assert out["nuc"]["xn_app"].shape == (1, g.n)
    t = np.load(tmp_path / "out" / "met" / "t.npy", mmap_mode="r")
    assert (t.dtype, t.shape) == (np.dtype("float64"), (2, g.n))


def tree_digest(path: Path) -> str:
    h = hashlib.sha256()
    for p in sorted(path.rglob("*")):
        st = p.stat()
        h.update(f"{p.relative_to(path)} {st.st_size} {st.st_mtime_ns}"
                 .encode())
        if p.is_file():
            h.update(p.read_bytes())
    return h.hexdigest()


def test_native_library_builds_into_build_dir(tmp_path, monkeypatch):
    """A fresh build goes to the build directory under a hash of the
    source and the flags, loads, and leaves native/ as it was."""
    native = ROOT / "native"
    before = tree_digest(native)
    assert tnc.SOURCE == native / "mistra_io.cpp"
    assert tnc.library_path().parent == ROOT / "mistra_tpu_torch" / "_build"
    monkeypatch.setattr(tnc, "BUILD_DIR", tmp_path)
    so = tnc.build()
    assert so.parent == tmp_path and so.name.startswith("libmistra_io_")
    assert tnc.build() == so
    import ctypes
    assert ctypes.CDLL(str(so)).mio_available() in (0, 1)
    assert tree_digest(native) == before
