"""Cells, configurations, mixes and metrics are found by name: a new cell
and a new metric come in as files and entries alone.  And the committed
``BENCHMARK.json`` keeps to the benchmark's format."""
import json
import re

import pytest

from portbench import harness, spec
from portbench.conftest import ROOT, tiny_cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_every_name_of_the_benchmark_has_its_files():
    here = ROOT / "portbench"
    for w in BENCH["workloads"]:
        cell = spec.load_cell(w["name"], ROOT)
        assert cell.config["name"] == w["config"]
        assert (here / "traffic" / f"{w['traffic']}.json").is_file()
        assert float(cell.limits["logit_gap"]) > 0
        for section in ("end_to_end", "per_layer"):
            for m in cell.metrics(section):
                assert callable(cell.reader(m["name"]).read)


def test_benchmark_json_keeps_the_format():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]] + \
        [w["name"] for w in BENCH["workloads"]] + \
        [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(names)) == len(names)
    assert all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/")
        assert all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in SOURCES and m["moves"] in e2e
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells


def test_a_cell_and_a_metric_come_in_as_files(tiny_tree):
    # a further per-layer metric: its reader file and its entry, no code
    (tiny_tree / "portbench" / "metrics" / "steps_in_window.py").write_text(
        "def read(run):\n    return len(run.steps)\n")
    bench = json.loads((tiny_tree / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "steps_in_window", "unit": "steps",
                               "better": "higher", "source": "host_clock",
                               "layer": "engine", "moves": "output_tok_s",
                               "workloads": ["tiny.chat"]})
    (tiny_tree / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = tiny_cell(tiny_tree)
    res = harness.run_cell(cell, 2**31 + 5, 0.15, True, device="cpu",
                           say=lambda m: None)
    assert res["correct"] is True
    assert res["metrics"]["steps_in_window"]["value"] >= 1
    assert list(res)[-1] == "checks"
    # the end-to-end run of the same cell reports its end-to-end metrics
    res = harness.run_cell(cell, 3, 0.15, False, device="cpu",
                           say=lambda m: None)
    assert set(res["metrics"]) == {m["name"] for m in cell.metrics(
        "end_to_end")} == {"setup_s", "output_tok_s", "itl_p95_ms"}
    assert res["attempted"] >= 1 and res["failed"] == 0


def test_an_unknown_cell_is_refused(tiny_tree):
    with pytest.raises(KeyError):
        tiny_cell(tiny_tree, "no.such-cell")
