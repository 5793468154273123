"""The run's entry: no card, no result; the result line's shape."""

from __future__ import annotations

import json

import pytest

from portbench import registry, run

from ._tiny import tiny_root

BENCH = registry.load_benchmark()


def test_no_card_no_result(capsys):
    import torch
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    rc = run.main(["--workload", "btz96.col1", "--seed", "3", "--seconds",
                   "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0
    assert out.out == ""
    assert "CUDA card" in out.err


@pytest.mark.parametrize("traced", [False, True])
def test_result_line_shape(tmp_path, monkeypatch, traced):
    root = tiny_root(tmp_path)
    cell = "btz96.col1"
    per_layer = registry.per_layer(BENCH, cell) if traced else []
    out = run.run_cell(registry.cell(BENCH, cell), 2**32 + 1, 0.01, traced,
                       device="cpu", root=root, per_layer=per_layer)
    line = run.result(BENCH, cell, out, traced, "cpu")
    keys = list(line)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"]
    assert keys[-1] == "checks"
    assert set(line["checks"]) == {"init", *registry.config("btz96")[
        "compare"]}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    assert line["attempted"] == out["minutes"] >= 1
    if traced:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["metrics"]) <= {m["name"] for m in per_layer}
        # the spans and counters a CPU run has: no profile, no kernel
        assert "growth_ms_per_min" in line["metrics"]
        assert "device_idle_pct" not in line["metrics"]
    else:
        assert set(line["metrics"]) == {"column_min_per_s", "setup_s"}
        assert line["metrics"]["column_min_per_s"]["unit"] == "col-min/s"
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert json.loads(json.dumps(line)) == line


def test_multiphase_window_ends_on_a_photolysis_minute(tmp_path):
    """Photolysis recomputes its rates on even minutes only: the window
    runs on past its time to such a minute, so that the compared minute
    recomputes photol_j."""
    root = tiny_root(tmp_path, columns=2)
    cell = "multiphase.ens8"
    assert registry.config("multiphase")["end_lmin_multiple"] == 2
    mix = registry.traffic("ens8", root)
    assert mix["warmup_minutes"] % 2 == 0
    out = run.run_cell(registry.cell(BENCH, cell), 2**31 + 7, 0.01, False,
                       device="cpu", root=root)
    assert out["minutes"] == 2        # lmin 3 is odd, 4 is even
    assert out["gaps"]["photol_j"] >= 0.0
