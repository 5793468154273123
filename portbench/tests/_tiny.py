"""The benchmark's cells at the tests' size: the same files with the tiny
grid (nf=20, n_extra=10, nka=nkt=16, nb=8; the inversion at 100 m, inside
it), at most 4 columns and the small tot stand-in (12 gas species, 25
aqueous stems), written under a directory of the test's own."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from portbench import registry

TINY_GRID = {"nf": 20, "n_extra": 10, "nka": 16, "nkt": 16, "nb": 8}
SMALL_TOT = {"n_gas": 12, "n_aq": 25}


def tiny_root(tmp_path, columns: int = 4) -> Path:
    root = Path(tmp_path) / "bench"
    shutil.copytree(registry.ROOT / "metrics", root / "metrics")
    (root / "configs").mkdir()
    (root / "traffic").mkdir()
    for name in ("btz96", "multiphase"):
        c = registry.config(name)
        c["grid"].update(TINY_GRID)
        c["settings"]["zinv"] = 100.0
        if c["inputs"]["tot_mechanism"]:
            c["inputs"]["tot_mechanism"] = SMALL_TOT
        (root / "configs" / f"{name}.json").write_text(json.dumps(c))
    for name in ("ens64", "ens8", "col1"):
        t = registry.traffic(name)
        t["columns"] = min(t["columns"], columns)
        (root / "traffic" / f"{name}.json").write_text(json.dumps(t))
    return root
