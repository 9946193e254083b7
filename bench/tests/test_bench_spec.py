"""``BENCHMARK.json`` against the rules it is held to: every name found
as its file, names and units in their alphabets, each per-layer metric
moving an end-to-end metric that its cells report."""

import importlib
import json
import re

import pytest

from harness import spec

SPEC = spec.load_json(spec.SPEC_FILE)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) <= 64 * 1024
    for word in SPEC["command"]:
        assert not word.startswith("/") and ".." not in word


@pytest.mark.parametrize("config", SPEC["configs"], ids=lambda c: c["name"])
def test_config_resolves(config):
    assert set(config) == {"name", "source", "file", "reduced", "why"}
    body = spec.load_json(spec.ROOT / config["file"])
    assert config["file"].startswith(tuple(SPEC["paths"]))
    assert set(config["reduced"]) <= set(body["reduced"])
    importlib.import_module(f"engines.{body['engine']}")


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda w: w["name"])
def test_cell_resolves(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] in (1, 4)
    assert cell["config"] in {c["name"] for c in SPEC["configs"]}
    loaded = spec.load_cell(cell["name"])
    importlib.import_module(f"loops.{loaded.mix['kind']}")
    names = {m["name"] for m in loaded.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert loaded.per_layer


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_reader_resolves(metric):
    assert callable(spec.load_reader(metric["name"]))
    assert metric["better"] in ("lower", "higher")


def test_names_and_units():
    names = ([c["name"] for c in SPEC["configs"]]
             + [w["name"] for w in SPEC["workloads"]]
             + [w["traffic"] for w in SPEC["workloads"]]
             + [m["name"] for m in METRICS]
             + [k for c in SPEC["configs"] for k in c["reduced"]])
    assert all(NAME.match(n) for n in names), names
    assert all(UNIT.match(m["unit"]) for m in METRICS)
    for group in ("configs", "workloads"):
        seen = [x["name"] for x in SPEC[group]]
        assert len(seen) == len(set(seen))
    assert len({m["name"] for m in METRICS}) == len(METRICS)
    for text in ([c["why"] for c in SPEC["configs"]]
                 + [c["source"] for c in SPEC["configs"]]
                 + [w["why"] for w in SPEC["workloads"]]
                 + [m["layer"] for m in SPEC["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_bounds():
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("metric", SPEC["per_layer"], ids=lambda m: m["name"])
def test_moves_a_metric_its_cells_report(metric):
    for cell in metric["workloads"]:
        reported = {m["name"] for m in spec.load_cell(cell).end_to_end}
        assert metric["moves"] in reported, (cell, metric["moves"])
