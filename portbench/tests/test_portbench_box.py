"""The box cell (``buys13_0d.ens1024``, ``BoxModel``) and the single
multiphase column's mix (``col1_chem``) at the tests' size: the cell runs
traced and untraced on the CPU and is correct against the reference's
box, its controls and faults planted in the box fail its limits, its
readers read the box's spans, and the reference's box imports nothing of
the program."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import compare, faults, registry, run, traffic
from portbench.standins import write_inputs

from ._tiny import SMALL_TOT, TINY_GRID

BENCH = registry.load_benchmark()
REPO = Path(__file__).resolve().parents[2]
CELL = "buys13_0d.ens1024"
BOX_METRICS = ("box_solve_ms_per_min", "box_ops_ms_per_min",
               "box_post_minute_ms_per_min")


def box_root(tmp_path, columns: int = 4) -> Path:
    """The box configuration and the two new mixes, shrunk as ``_tiny``
    shrinks the others: the tiny grid with the inversion inside it, the
    small tot stand-in, at most ``columns`` boxes."""
    root = Path(tmp_path) / "bench"
    shutil.copytree(registry.ROOT / "metrics", root / "metrics")
    (root / "configs").mkdir()
    (root / "traffic").mkdir()
    for name in ("buys13_0d", "multiphase"):
        c = registry.config(name)
        c["grid"].update(TINY_GRID)
        c["settings"]["zinv"] = 100.0
        c["inputs"]["tot_mechanism"] = SMALL_TOT
        (root / "configs" / f"{name}.json").write_text(json.dumps(c))
    for name in ("ens1024", "col1_chem"):
        t = registry.traffic(name)
        t["columns"] = min(t["columns"], columns)
        (root / "traffic" / f"{name}.json").write_text(json.dumps(t))
    return root


def test_box_cell_is_the_box_configuration():
    spec = registry.config("buys13_0d")
    s = spec["settings"]
    assert spec["model"] == "boxmodel:BoxModel"
    assert s["box"] and s["lp_buys13_0d"] and s["mic"] and s["chem"]
    assert (s["nkc_l"], s["iaertyp"], s["alat"]) == (4, 3, -75.6)
    assert spec["grid"] == registry.config("multiphase")["grid"]
    assert spec["end_lmin_multiple"] == 2
    assert set(spec["controls"]) == {"bf16", "tf32", "f32_tot"}
    mix = registry.traffic("ens1024")
    assert (mix["columns"], mix["noon_share"]) == (1024, 0.5)
    names = {m["name"] for m in registry.per_layer(BENCH, CELL)}
    assert set(BOX_METRICS) <= names
    col1 = registry.cell(BENCH, "multiphase.col1")
    assert (col1["config"], col1["traffic"]) == ("multiphase", "col1_chem")


@pytest.mark.parametrize("traced", [False, True])
def test_box_cell_runs_and_is_correct(tmp_path, traced):
    root = box_root(tmp_path)
    per_layer = registry.per_layer(BENCH, CELL) if traced else []
    out = run.run_cell(registry.cell(BENCH, CELL), 2**32 + 3, 0.01, traced,
                       device="cpu", root=root, per_layer=per_layer)
    spec = registry.config("buys13_0d", root)
    correct, checks = run.judge(out["gaps"], spec["limits"])
    assert correct, checks
    assert out["gaps"]["init"] == 0.0
    assert out["attempted"] == 4 * out["minutes"] and out["failed"] == 0
    # the window ends on an even minute, one that photolyses
    assert out["minutes"] == 2
    if traced:
        for name in BOX_METRICS:
            value = out["per_layer"][name]["value"]
            assert value > 0.0, name
        assert "photolysis_ms_per_min" in out["per_layer"]
        assert "host_syncs_per_substep" in out["per_layer"]


def test_box_controls_fail(tmp_path):
    """The state held in bfloat16 and the tot solve in float32 fail the
    box's limits (tf32 changes nothing on the CPU)."""
    root = box_root(tmp_path, columns=2)
    out = run.run_cell(registry.cell(BENCH, CELL), 2**31 + 97, 0.01, False,
                       device="cpu", root=root, controls=["bf16", "f32_tot"])
    limits = registry.config("buys13_0d", root)["limits"]
    assert run.judge(out["gaps"], limits)[0]
    for name in ("bf16", "f32_tot"):
        ok, checks = run.judge(out["controls"][name], limits)
        assert not ok, (name, checks)


def _box_fault(monkeypatch, fault):
    """Plant a fault in the program's box (``faults`` plants the column
    model's): a minute that returns its state, one that leaves the second
    half of the boxes out, or a box solve that returns its input."""
    from mistra_tpu_torch.boxmodel import BoxModel
    from mistra_tpu_torch.chemistry.driver_aq import MultiphaseDriver
    if fault == "unchanged":
        monkeypatch.setattr(BoxModel, "minute_step", lambda self, s: s)
    elif fault == "half_batch":
        step = BoxModel.minute_step
        monkeypatch.setattr(BoxModel, "minute_step", lambda self, s: faults
                            ._join(step(self, s), s, s.met.t.shape[0] // 2))
    else:
        monkeypatch.setattr(MultiphaseDriver, "integrate_box",
                            lambda self, state, dt, n_bl=1: state.chem)


@pytest.mark.parametrize("fault", ["unchanged", "half_batch",
                                   "solve_unchanged"])
def test_box_faults_fail(tmp_path, monkeypatch, fault):
    root = box_root(tmp_path, columns=2)
    _box_fault(monkeypatch, fault)
    out = run.run_cell(registry.cell(BENCH, CELL), 2**31 + 96, 0.01, False,
                       device="cpu", root=root)
    ok, checks = run.judge(out["gaps"],
                           registry.config("buys13_0d", root)["limits"])
    assert not ok, checks


def test_box_reference_minute_equals_the_program(tmp_path):
    """Two boxes (00:00 and 12:00) on the tiny grid, on the CPU: the
    program's box and the reference's start alike and step one minute
    alike, every field."""
    import mistra_tpu_torch as prog
    from portbench import reference as ref

    root = box_root(tmp_path, columns=2)
    spec = registry.config("buys13_0d", root)
    mix = registry.traffic("ens1024", root)
    inp, mech = write_inputs(spec["inputs"], str(tmp_path))
    pm = run.model_class("mistra_tpu_torch", spec)(
        run.build_config(prog, spec, inp, mech), device="cpu")
    rm = run.model_class("portbench.reference", spec)(
        run.build_config(ref, spec, inp, mech), device="cpu")
    ps = traffic.start(pm, 13, spec, mix)
    rs = traffic.start(rm, 13, spec, mix)
    assert compare.init_gap(ps, rs) == 0.0
    for _ in range(2):
        ps, rs = pm.minute_step(ps), rm.minute_step(rs)
    fields = dict(spec["compare"], ff={"field": "micro.ff",
                                       "scale": "column"})
    gaps = compare.field_gaps(ps, rs, fields, rm)
    assert all(g == 0.0 for g in gaps.values()), gaps
    assert (ps.chem.photol_j[:, :, 1] > 0.0).any()


def test_col1_chem_cell_runs_and_is_correct(tmp_path):
    root = box_root(tmp_path)
    out = run.run_cell(registry.cell(BENCH, "multiphase.col1"), 2**31 + 9,
                       0.01, False, device="cpu", root=root)
    correct, checks = run.judge(
        out["gaps"], registry.config("multiphase", root)["limits"])
    assert correct, checks
    assert out["attempted"] == out["minutes"] == 2


REFERENCE_BOX = """
import json, sys, tempfile
import torch
torch.set_num_threads(1)
from portbench import registry, run, standins, traffic
from portbench import reference as ref
from portbench.reference import boxmodel
from portbench.tests.test_portbench_box import box_root
assert callable(boxmodel.solar_zenith)
with tempfile.TemporaryDirectory() as tmp:
    root = box_root(tmp, columns=2)
    spec = registry.config("buys13_0d", root)
    inp, mech = standins.write_inputs(spec["inputs"], tmp)
    model = boxmodel.BoxModel(run.build_config(ref, spec, inp, mech),
                              device="cpu")
    state = traffic.start(model, 1, spec, registry.traffic("ens1024", root))
    state = model.substep(model.pre_minute(state), 10.0)
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_reference_box_imports_nothing_of_the_program():
    out = subprocess.run([sys.executable, "-c", REFERENCE_BOX], cwd=REPO,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    mods = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "portbench" in mods
    assert not mods & {"jax", "jaxlib", "flax", "mistra_tpu",
                       "mistra_tpu_torch"}
    source = (REPO / "portbench" / "reference" / "boxmodel.py").read_text()
    for line in source.splitlines():
        s = line.strip()
        if s.startswith(("import ", "from ")):
            assert "mistra_tpu" not in s and "jax" not in s, s
