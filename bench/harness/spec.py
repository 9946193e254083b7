"""``BENCHMARK.json`` and the files its names point to.

A cell names a configuration and a traffic mix; each is found by its name
alone: ``bench/configs/<config>.json``, ``bench/traffic/<traffic>.json``,
and each per-layer metric's reader ``bench/metrics/<metric>.py``. So a
later change adds a configuration, a mix or a metric as new files and
entries, and edits none.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
SPEC_FILE = ROOT / "BENCHMARK.json"


def traffic_path(name: str) -> Path:
    return BENCH / "traffic" / f"{name}.json"


def metric_path(name: str) -> Path:
    return BENCH / "metrics" / f"{name}.py"


@dataclasses.dataclass(frozen=True)
class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""

    name: str
    chips: int
    config: dict          # the configuration file's contents
    mix: dict             # the traffic file's contents
    end_to_end: tuple     # metric entries this cell reports with --trace 0
    per_layer: tuple      # metric entries this cell reports with --trace 1


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reported(metric: dict, cell: str, e2e_names: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_names


def load_cell(name: str, spec_file: Path = SPEC_FILE) -> Cell:
    """The workload ``name`` of the benchmark file, resolved."""
    spec = load_json(spec_file)
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {spec_file.name} "
                       f"(have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = load_json(ROOT / configs[w["config"]]["file"])
    e2e = tuple(m for m in spec["end_to_end"]
                if "workloads" not in m or name in m["workloads"])
    e2e_names = {m["name"] for m in e2e}
    layer = tuple(m for m in spec["per_layer"]
                  if _reported(m, name, e2e_names))
    return Cell(name=name, chips=int(w["chips"]), config=config,
                mix=load_json(traffic_path(w["traffic"])),
                end_to_end=e2e, per_layer=layer)


def load_reader(metric: str):
    """The ``read(record)`` function of a per-layer metric's file."""
    path = metric_path(metric)
    mod_spec = importlib.util.spec_from_file_location(
        "bench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module.read
