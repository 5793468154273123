"""The benchmark's files: found by name, within the contract's limits,
and a cell made of new files alone runs."""

from __future__ import annotations

import json
import re

import pytest

from portbench import registry, run

from ._tiny import TINY_GRID, tiny_root

BENCH = registry.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = [m["name"] for m in BENCH["per_layer"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert [m["name"] for m in BENCH["end_to_end"]] == [
        "column_min_per_s", "setup_s"]


def test_names_and_units_use_the_allowed_characters():
    names = ([c["name"] for c in BENCH["configs"]]
             + [w[k] for w in BENCH["workloads"]
                for k in ("name", "config", "traffic")]
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
             + [k for c in BENCH["configs"] for k in c["reduced"]])
    for name in names:
        assert NAME.match(name), name
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for text in ([c["source"] for c in BENCH["configs"]]
                 + [x["why"] for x in BENCH["configs"] + BENCH["workloads"]]
                 + [m["layer"] for m in BENCH["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        got = [x["name"] for x in BENCH[kind]]
        assert len(got) == len(set(got))


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cells_find_their_files(cell):
    w = registry.cell(BENCH, cell)
    spec = registry.config(w["config"])
    mix = registry.traffic(w["traffic"])
    assert spec["name"] == w["config"]
    assert set(spec["limits"]) == {"init", *spec["compare"]}
    assert {"columns", "noon_share", "warmup_minutes", "profile"} <= set(mix)
    assert w["chips"] == 1
    reported = registry.per_layer(BENCH, cell)
    assert reported, "every cell reports a per-layer metric"


@pytest.mark.parametrize("name", METRICS)
def test_readers_declare_what_the_benchmark_says(name):
    entry = next(m for m in BENCH["per_layer"] if m["name"] == name)
    reader = registry.metric_reader(name)
    assert (reader.LAYER, reader.UNIT, reader.SOURCE, reader.MOVES) == (
        entry["layer"], entry["unit"], entry["source"], entry["moves"])
    assert callable(reader.read)


def test_config_files_are_distinct_and_under_paths():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for c in BENCH["configs"]:
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert registry.config(c["name"])["source"] == c["source"]


def test_unknown_names_raise():
    with pytest.raises(KeyError):
        registry.cell(BENCH, "nope.nothing")
    with pytest.raises(KeyError):
        registry.config("nope")
    with pytest.raises(KeyError):
        registry.metric_reader("nope")


def test_a_new_cell_is_new_files_only(tmp_path):
    """A configuration, a traffic mix and a per-layer metric written under
    tmp_path make a cell that loads and runs with no edit of the
    harness."""
    root = tiny_root(tmp_path)
    spec = registry.config("btz96", root)
    spec.update(name="btz96_warm", settings=dict(spec["settings"],
                                                  tw=290.15))
    (root / "configs" / "btz96_warm.json").write_text(json.dumps(spec))
    (root / "traffic" / "pair.json").write_text(json.dumps(
        {"columns": 2, "noon_share": 0.5, "warmup_minutes": 0,
         "profile": {"minutes": 1}}))
    # the reader brings a span of its own, around a call that no other
    # reader wraps: the harness installs it from the declaration
    (root / "metrics" / "window_minutes.py").write_text(
        'LAYER = "Step driver"\nUNIT = "min"\nSOURCE = "program_counter"\n'
        'MOVES = "column_min_per_s"\n'
        'SPANS = {"pre_minute": "model:pre_minute"}\n\n\n'
        'def read(trace):\n'
        '    assert trace["span_calls"]["pre_minute"] == trace["minutes"]\n'
        '    return float(trace["minutes"])\n')
    bench = dict(BENCH, workloads=BENCH["workloads"] + [
        {"name": "btz96_warm.pair", "config": "btz96_warm",
         "traffic": "pair", "chips": 1, "why": "a throwaway cell"}],
        per_layer=BENCH["per_layer"] + [
        {"name": "window_minutes", "unit": "min", "better": "higher",
         "source": "program_counter", "layer": "Step driver",
         "moves": "column_min_per_s", "workloads": ["btz96_warm.pair"]}])
    cell = registry.cell(bench, "btz96_warm.pair")
    wanted = registry.per_layer(bench, "btz96_warm.pair")
    assert [m["name"] for m in wanted] == ["window_minutes"]
    out = run.run_cell(cell, 5, 0.01, True, device="cpu", root=root,
                       per_layer=wanted)
    assert out["attempted"] == 2 * out["minutes"] >= 2
    assert out["per_layer"]["window_minutes"]["value"] == out["minutes"]
    assert out["gaps"]["t"] == 0.0
    assert registry.config("btz96_warm", root)["grid"]["nf"] == \
        TINY_GRID["nf"]
