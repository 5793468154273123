"""In a fresh interpreter the harness loads no JAX and no mistra_tpu, and
the reference loads no module of the program either (top-level names
compared whole: mistra_tpu_torch begins with mistra_tpu)."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

HARNESS = """
import json, sys, tempfile
import torch
torch.set_num_threads(1)
from portbench import registry, run
from portbench.tests._tiny import tiny_root
bench = registry.load_benchmark()
for m in bench["per_layer"]:
    registry.metric_reader(m["name"])
with tempfile.TemporaryDirectory() as tmp:
    root = tiny_root(tmp, columns=2)
    out = run.run_cell(registry.cell(bench, "btz96.col1"), 1, 0.01, True,
                       device="cpu", root=root,
                       per_layer=registry.per_layer(bench, "btz96.col1"))
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""

REFERENCE = """
import json, sys, tempfile
import torch
torch.set_num_threads(1)
from portbench import reference as ref
from portbench import registry, standins, traffic, compare
from portbench.run import build_config
from portbench.tests._tiny import tiny_root
with tempfile.TemporaryDirectory() as tmp:
    root = tiny_root(tmp, columns=2)
    spec = registry.config("multiphase", root)
    inp, mech = standins.write_inputs(spec["inputs"], tmp)
    model = ref.Model(build_config(ref, spec, inp, mech), device="cpu")
    state = traffic.start(model, 1, spec, registry.traffic("ens8", root))
    state = model.substep(model.pre_minute(state), 10.0)
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _modules(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    mods = _modules(HARNESS)
    assert "mistra_tpu_torch" in mods and "portbench" in mods
    assert not mods & {"jax", "jaxlib", "flax", "mistra_tpu"}


def test_reference_loads_nothing_of_the_program():
    mods = _modules(REFERENCE)
    assert "portbench" in mods
    assert not mods & {"jax", "jaxlib", "flax", "mistra_tpu",
                       "mistra_tpu_torch"}


def test_reference_sources_name_no_program_import():
    for path in (REPO / "portbench" / "reference").rglob("*.py"):
        for line in path.read_text().splitlines():
            s = line.strip()
            if s.startswith(("import ", "from ")):
                assert "mistra_tpu" not in s and "jax" not in s, (path, s)
