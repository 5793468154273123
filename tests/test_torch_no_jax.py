"""The PyTorch port never imports JAX: the machine that runs it on the GPU
has no JAX.  A fresh interpreter imports the port's package, its
radiation driver, its chemistry kernel, its photolysis driver, its
gas-phase and multiphase chemistry drivers, the aqueous stack beneath
them, the stiff-cell report, the soil surface, nucleation, the box
and chamber modes and the run harness (the CLI, checkpoints, the output
writers and profiles, the chemistry diagnostics, the projection,
profiling and the ensemble mesh), and finds no jax module."""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("module", [
    "mistra_tpu_torch", "mistra_tpu_torch.radiation.driver",
    "mistra_tpu_torch.chemistry.gas_kernel",
    "mistra_tpu_torch.photolysis.jrates",
    "mistra_tpu_torch.chemistry.driver",
    "mistra_tpu_torch.chemistry.driver_aq",
    "mistra_tpu_torch.chemistry.aqueous",
    "mistra_tpu_torch.chemistry.activity",
    "mistra_tpu_torch.chemistry.sources",
    "mistra_tpu_torch.chemistry.stiff_cells",
    "mistra_tpu_torch.physics.surface",
    "mistra_tpu_torch.physics.nucleation",
    "mistra_tpu_torch.boxmodel",
    "mistra_tpu_torch.cli", "mistra_tpu_torch.__main__",
    "mistra_tpu_torch.io.checkpoint", "mistra_tpu_torch.io.output",
    "mistra_tpu_torch.io.netcdf", "mistra_tpu_torch.io.profiles",
    "mistra_tpu_torch.chemistry.diagnostics",
    "mistra_tpu_torch.physics.projection",
    "mistra_tpu_torch.utils.profiling",
    "mistra_tpu_torch.parallel.mesh"])
def test_port_imports_no_jax(module):
    code = (f"import sys, importlib; importlib.import_module({module!r}); "
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'jaxlib', 'mistra_tpu.')) "
            "or m == 'mistra_tpu'); print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
