"""``correct`` on the tests' size: the program passes, and the controls
and every fault that a cell can have fail.

The controls are the reference in the program's place, in a lower
precision (the configuration's ``controls``).  The faults
(``portbench.faults``) break the timed path underneath the harness: a
step that returns its state unchanged, a step that leaves half of the
ensemble's columns out, a step whose answer is altered where it is
produced (one level of one column's temperature), and, with the
multiphase chemistry, a chemistry substep that returns its input.  The
cells run on one card, so no exchange between chips can be left out.
"""

from __future__ import annotations

import json

import pytest

from portbench import faults, registry, run

from ._tiny import tiny_root

BENCH = registry.load_benchmark()
CELLS = ["btz96.ens64", "multiphase.ens8"]


def _root(tmp_path):
    root = tiny_root(tmp_path)
    for t in (root / "traffic").iterdir():
        mix = json.loads(t.read_text())
        mix["warmup_minutes"] = min(mix["warmup_minutes"], 1)
        t.write_text(json.dumps(mix))
    return root


def _judge(root, cell, gaps):
    spec = registry.config(registry.cell(BENCH, cell)["config"], root)
    return run.judge(gaps, spec["limits"])


# bf16: the state held in bfloat16; f32_tot: the multiphase tot solve in
# float32 (tf32 changes nothing on the CPU)
CONTROLS = {"btz96.ens64": ["bf16"], "multiphase.ens8": ["bf16", "f32_tot"]}


@pytest.mark.parametrize("cell", CELLS)
def test_program_passes_and_control_fails(tmp_path, cell):
    root = _root(tmp_path)
    out = run.run_cell(registry.cell(BENCH, cell), 2**31 + 99, 0.01, False,
                       device="cpu", root=root, controls=CONTROLS[cell])
    ok, checks = _judge(root, cell, out["gaps"])
    assert ok, checks
    for name in CONTROLS[cell]:
        ok, checks = _judge(root, cell, out["controls"][name])
        assert not ok, (name, checks)
    assert out["failed"] == 0


FAULTS = {"btz96.ens64": ["altered", "half_batch", "unchanged"],
          "multiphase.ens8": ["altered", "chem_unchanged", "half_batch",
                              "unchanged"],
          "btz96.col1": ["altered", "unchanged"]}   # one column: no half


@pytest.mark.parametrize("cell,fault", [(c, f) for c, fs in FAULTS.items()
                                        for f in fs])
def test_faults_fail(tmp_path, cell, fault):
    root = _root(tmp_path)
    undo = faults.install(fault)
    try:
        out = run.run_cell(registry.cell(BENCH, cell), 2**31 + 98, 0.01,
                           False, device="cpu", root=root)
    finally:
        undo()
    ok, checks = _judge(root, cell, out["gaps"])
    assert not ok, checks
