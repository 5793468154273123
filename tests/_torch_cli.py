"""Shared helpers of the run-harness tests (tests/test_torch_cli*.py): a
namelist of the flagship BTZ96 settings in float64, the JAX package's CLI
in a subprocess (``_jax_cli.py``), the port's CLI in this process with
its clock's minute set after ``init_state``, and readers of what both
write."""

from __future__ import annotations

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

import mistra_tpu_torch.model as tmodel
from mistra_tpu_torch import cli
from mistra_tpu_torch.io import netcdf as ncio

ROOT = Path(__file__).resolve().parent.parent
TINY = "nf=20,n_extra=10,nka=16,nkt=16,nb=8,zinv=100"
# __graft_entry__.py:25-27's BTZ96 settings (the inversion inside the tiny
# grid, as --grid's zinv sets it), float64
BTZ96 = dict(chem=".false.", mic=".true.", dtype="'float64'", tw=288.15,
             zinv=100.0, dtinv=7.0, ug=8.5, vg=0.0, nw_prof_opt=1,
             wmax=-0.005, z0=0.0001, alat=55.0)


def write_namelist(path, **settings) -> str:
    body = ",\n".join(f"  {k} = {v}" for k, v in settings.items())
    Path(path).write_text(f"&mistra_cfg\n{body}\n/\n")
    return str(path)


def run_jax_cli(minute, args, env, timeout=600, step="minute_step"):
    """The JAX CLI in a subprocess on the CPU, its clock at ``minute``,
    its minute step ``Model.<step>``."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu", **env)
    out = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "_jax_cli.py"), str(minute),
         step, *args], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=timeout)
    assert out.returncode == 0, out.stdout + out.stderr
    return out.stdout


def run_port_cli(monkeypatch, minute, args, env):
    """The port's CLI on the CPU in this process, its clock's minute set
    after ``init_state`` (never by the CLI)."""
    init = tmodel.Model.init_state

    def init_state(self, B=1):
        s = init(self, B)
        return s.replace(tim=s.tim.replace(
            lmin=torch.full_like(s.tim.lmin, minute)))
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(tmodel.Model, "init_state", init_state)
    assert cli.main([*args, "--platform", "cpu"]) == 0


def numbers(path) -> np.ndarray:
    """The numbers of a text output file's data lines, [lines, fields]
    (header lines, starting with '#', and blank lines left out)."""
    rows = []
    for line in Path(path).read_text().splitlines():
        if not line.strip() or line.startswith("#"):
            continue
        rows.append([float(x) for x in re.findall(
            r"[-+]?\d+\.?\d*(?:[eE][-+]?\d+)?", line)])
    return np.array(rows)


def headers(path) -> list:
    return [ln for ln in Path(path).read_text().splitlines()
            if ln.startswith("#")]


def assert_text_close(want, got, tol=1e-6):
    """Two text outputs: the same header lines, and each numeric field
    (column) within tol of its largest magnitude."""
    assert headers(want) == headers(got)
    a, b = numbers(want), numbers(got)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = np.maximum(np.abs(a).max(axis=0), 1e-300)
    err = (np.abs(a - b) / scale).max()
    assert err <= tol, f"{got}: {err:.3e} of scale > {tol:.0e}"


def nc_vars(path, shapes) -> dict:
    """{name: array} of the variables of a netCDF file, given each one's
    shape with 'T' for the record count."""
    r = ncio.NcReader(str(path))
    try:
        T = r.dimlen("time") if any("T" in s for s in shapes.values()) \
            else 0
        return {k: r.get(k, tuple(T if d == "T" else d for d in s))
                for k, s in shapes.items()}
    finally:
        r.close()


def assert_nc_close(want, got, shapes, tol):
    a, b = nc_vars(want, shapes), nc_vars(got, shapes)
    for k in shapes:
        assert a[k].shape == b[k].shape, (k, a[k].shape, b[k].shape)
        scale = max(np.abs(a[k]).max(), 1e-300)
        err = np.abs(a[k] - b[k]).max() / scale
        assert err <= tol, f"{got}:{k}: {err:.3e} of scale > {tol:.0e}"
