"""BENCHMARK.json against the benchmark's contract, and every name in it
resolving to its files."""

import json
import re

import pytest

from portbench import harness

SPEC = harness.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["portbench"]
    assert 1 <= len(SPEC["command"]) <= 32
    assert all(not w.startswith("/") and ".." not in w for w in SPEC["command"])
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) <= 64 * 1024


def test_names_units_and_lines():
    names = [c["name"] for c in SPEC["configs"]] + [w["name"] for w in SPEC["workloads"]]
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    names += [m["name"] for m in metrics]
    assert all(NAME.match(n) for n in names), names
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert len({w["name"] for w in SPEC["workloads"]}) == len(SPEC["workloads"])
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for text in ([w["why"] for w in SPEC["workloads"]] + [m["layer"] for m in SPEC["per_layer"]]
                 + [c[k] for c in SPEC["configs"] for k in ("source", "why")]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_entry_keys():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}


PARKED = harness.benchmark(parked=True)


@pytest.mark.parametrize("work", [w["name"] for w in PARKED["workloads"]])
def test_workload_resolves_to_its_files(work):
    """Every cell, the benchmark's and the parked ones."""
    w, config, traffic = harness.cell_files(PARKED, work)
    entry = {c["name"]: c for c in PARKED["configs"]}[w["config"]]
    assert entry["file"].startswith("portbench/configs/")
    assert config["reduced"] == entry["reduced"] == []
    assert harness.driver(traffic["driver"]).Cell
    e2e = harness.metrics_of(PARKED, w, False)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    layer = harness.metrics_of(PARKED, w, True)
    assert layer
    for m in e2e + layer:
        assert callable(harness.reader(m["name"]))
    for m in layer:
        assert m["moves"] in names


def test_a_parked_cell_is_not_the_benchmarks():
    own = {w["name"] for w in SPEC["workloads"]}
    parked = harness.load_json(harness.PKG / "parked.json")
    assert own.isdisjoint(w["name"] for w in parked["workloads"])
    with pytest.raises(KeyError):
        harness.cell_files(SPEC, parked["workloads"][0]["name"])


def test_every_config_is_used_and_layers_are_consistent():
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}
    by_layer = {}
    for m in SPEC["per_layer"]:
        by_layer.setdefault(m["layer"], set()).add(m["name"])
    assert "device" in by_layer


def test_shares_of_a_peak_are_percent():
    for m in SPEC["per_layer"]:
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
