"""On the card: the single-column cell at its own size passes its
checks, and the control fails them.  Skips without a card.

    python3 -m pytest --noconftest -m gpu portbench/tests/test_portbench_gpu.py
"""

from __future__ import annotations

import pytest
import torch

from portbench import registry, run

BENCH = registry.load_benchmark()


@pytest.mark.gpu
def test_col1_on_the_card_passes_and_its_control_fails():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = registry.cell(BENCH, "btz96.col1")
    per_layer = registry.per_layer(BENCH, "btz96.col1")
    out = run.run_cell(cell, 2**31 + 12345, 2.0, True, controls=["bf16"],
                       per_layer=per_layer)
    limits = registry.config("btz96")["limits"]
    ok, checks = run.judge(out["gaps"], limits)
    assert ok, checks
    ok, checks = run.judge(out["controls"]["bf16"], limits)
    assert not ok, checks
    assert out["failed"] == 0
    assert out["device"]["platform"] == "gpu"
    assert "device_idle_pct" in out["per_layer"]
    assert 0.0 < out["device_trace"]["busy_s"] <= \
        out["device_trace"]["window_s"]
