"""Where the benchmark finds its parts, by the names in ``BENCHMARK.json``.

* a cell: an entry of ``workloads`` (``config``, ``traffic``, ``chips``);
* a configuration: ``configs/<name>.json``;
* a traffic mix: ``traffic/<name>.json``;
* a per-layer metric: ``metrics/<name>.py``, a module with ``LAYER``,
  ``UNIT``, ``SOURCE``, ``MOVES`` and ``read(trace)``, which returns the
  metric's value or None when the trace holds nothing to read; it may
  declare the spans, launch counters and records it reads (``SPANS``,
  ``LAUNCHES``, ``RECORDS``; ``trace.instrument`` installs them).

A configuration file names the model class (``model``), what is compared
(``compare``) with its ``limits``, and its ``controls``; ``run`` and
``compare`` read them, so a configuration of another mode or with other
compared fields is a new file too.

Every function takes the directory that holds those folders (this
package's by default), so a cell made of files elsewhere loads the same
way.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parent
BENCHMARK = ROOT.parent / "BENCHMARK.json"


def load_benchmark(path=BENCHMARK) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in the benchmark; it has "
                   f"{', '.join(w['name'] for w in bench['workloads'])}")


def _json(root, folder: str, name: str) -> dict:
    path = Path(root) / folder / f"{name}.json"
    if not path.exists():
        raise KeyError(f"no {folder[:-1] if folder.endswith('s') else folder}"
                       f" {name!r}: {path} is missing")
    with open(path) as f:
        return json.load(f)


def config(name: str, root=ROOT) -> dict:
    return _json(root, "configs", name)


def traffic(name: str, root=ROOT) -> dict:
    return _json(root, "traffic", name)


def metric_reader(name: str, root=ROOT):
    """The module of ``metrics/<name>.py``."""
    path = Path(root) / "metrics" / f"{name}.py"
    if not path.exists():
        raise KeyError(f"no reader of the metric {name!r}: {path} is missing")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def per_layer(bench: dict, cell_name: str) -> list:
    """The per-layer metrics the cell reports: those that list it under
    ``workloads``, and those without the key whose end-to-end metric it
    reports."""
    e2e = {m["name"] for m in end_to_end(bench, cell_name)}
    return [m for m in bench["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m
                else m["moves"] in e2e)]


def end_to_end(bench: dict, cell_name: str) -> list:
    return [m for m in bench["end_to_end"]
            if "workloads" not in m or cell_name in m["workloads"]]
