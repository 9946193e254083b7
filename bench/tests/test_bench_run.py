"""The harness end to end on the CPU at smoke size: each cell's run is
correct against the reference, a run whose timed path is broken is not,
the control reads above the limit, and the inputs are fixed by the
seed."""

import dataclasses
import importlib
import inspect
import itertools
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import control
from harness import data, runner, spec

BENCHMARK_CELLS = [w["name"]
                   for w in spec.load_json(spec.SPEC_FILE)["workloads"]]
SEED = 2**31 + 977          # seeds past 32 signed bits

# cells of a second engine, RAMBO, made here and not in BENCHMARK.json, so
# that the run, the faults and the control are held to an engine besides
# the one the benchmark's cells drive: B 32 buckets, R 10 repetitions
# (RAMBO's sqrt N and log2 N at N 1024), each an IDL filter of m bits
# (cut to the smoke size by conftest.smoke, as every cell is)
RAMBO_CONFIG = {
    "engine": "rambo", "n_files": 1024, "n_buckets": 32, "n_rep": 10,
    "m": 1 << 27, "k": 31, "t": 16, "L": 1 << 17, "eta": 4,
    "scheme": "idl", "minhash_mode": "doph", "align": True,
    "file_bases": [4096, 262144], "repeat_fraction": 0.3,
    "repeat_unit": 500, "build": {"window_bases": 230, "chunk_reads": 512}}
RAMBO_CELLS = {"rambo-smoke.query": ("query", "query_reads_per_s",
                                     "reads/s"),
               "rambo-smoke.build": ("build", "build_mbases_per_s",
                                     "Mbases/s")}
CELLS = BENCHMARK_CELLS + list(RAMBO_CELLS)


def rambo_cell(name: str) -> spec.Cell:
    traffic, metric, unit = RAMBO_CELLS[name]
    return spec.Cell(name=name, chips=1, config=dict(RAMBO_CONFIG),
                     mix=spec.load_json(spec.traffic_path(traffic)),
                     end_to_end=({"name": metric, "unit": unit},
                                 {"name": "setup_s", "unit": "s"}),
                     per_layer=())


@pytest.fixture
def any_cell(smoke_cell, monkeypatch):
    """``smoke_cell`` over the cells of BENCHMARK.json and RAMBO_CELLS."""
    load = spec.load_cell
    monkeypatch.setattr(spec, "load_cell", lambda name: rambo_cell(name)
                        if name in RAMBO_CELLS else load(name))
    return smoke_cell


def run_cpu(cell, seconds=0.4, trace=False):
    return runner.run(cell, SEED, seconds, trace, torch.device("cpu"),
                      time.monotonic())


@pytest.mark.parametrize("name", CELLS)
def test_cell_correct_on_cpu(any_cell, name):
    line = run_cpu(any_cell(name))
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert all(c["value"] == 0 for c in line["checks"].values())
    assert "setup_s" in line["metrics"]


def test_traced_run_without_a_card_reads_host_metrics(smoke_cell):
    line = run_cpu(smoke_cell("bitsliced-idl.query"), trace=True)
    assert line["correct"]
    assert line["metrics"]["service.host_ms.query"]["value"] > 0
    assert line["metrics"]["planner.device_plan_ms.query"]["value"] > 0
    assert "kernels.probe_roofline.query" not in line["metrics"]


# -- faults planted under the timed path: each must turn `correct` false --
# Each is planted on the engine class that the cell's adapter builds
# (its insert_batch) and on the service every engine shares (_finalize).

def _unchanged_state(monkeypatch, adapter, engine):
    monkeypatch.setattr(engine, "insert_batch",
                        lambda self, reads, file_ids=None, **kw: self)


def _half_batch(monkeypatch, adapter, engine):
    from repro_torch.serving import service

    insert = engine.insert_batch

    def half_insert(self, reads, file_ids=None, **kw):
        h = len(reads) // 2
        return insert(self, reads[:h], file_ids[:h], **kw)

    finalize = service.GeneSearchService._finalize

    def half_finalize(self, take, bucket, out):
        results = finalize(self, take, bucket, out)
        for r in results[len(results) // 2:]:     # left out: no hits
            r.matches[:] = False
        return results

    monkeypatch.setattr(engine, "insert_batch", half_insert)
    monkeypatch.setattr(service.GeneSearchService, "_finalize",
                        half_finalize)


def _altered_answer(monkeypatch, adapter, engine):
    from repro_torch.serving import service

    insert = engine.insert_batch
    calls = itertools.count()

    def altered_insert(self, reads, file_ids=None, **kw):
        out = insert(self, reads, file_ids, **kw)
        # a bit of another word each insert, so no two flips cancel
        words = adapter.output_words(out).view(-1)
        words[(7 + 64 * next(calls)) % words.numel()] ^= 1 << 3
        return out

    finalize = service.GeneSearchService._finalize

    def altered_finalize(self, take, bucket, out):
        results = finalize(self, take, bucket, out)
        results[0].matches[5] = not results[0].matches[5]
        return results

    monkeypatch.setattr(engine, "insert_batch", altered_insert)
    monkeypatch.setattr(service.GeneSearchService, "_finalize",
                        altered_finalize)


FAULTS = {"state unchanged": _unchanged_state,
          "half the batch left out": _half_batch,
          "an answer altered where it is produced": _altered_answer}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_fault_fails_the_check(any_cell, monkeypatch, name, fault):
    cell = any_cell(name)
    adapter = importlib.import_module(f"engines.{cell.config['engine']}")
    engine = type(adapter.new_index(cell.config, "cpu"))
    FAULTS[fault](monkeypatch, adapter, engine)
    line = run_cpu(cell)
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_check(any_cell, name):
    """The control (the reference with one guarantee broken, planted in
    the program's place) turns the run's `correct` false, on three seeds,
    through the same check as a run of the program."""
    cell = any_cell(name)
    if cell.mix["kind"] == "closed_loop":
        # thousands of answers compared, as at the cells' own sizes (the
        # control flips about one poisoned read in 115)
        cell = dataclasses.replace(cell, mix=dict(
            cell.mix, batch_reads=64, check_per_batch=64,
            pool_reads_per_s=20000))
    for seed in (11, 12, 2**31 + 5):
        # the window doubles until it holds those answers: the control's
        # pace on a CPU (the reference in the program's place) varies
        # with the engine and with the host's load
        for seconds in (2.0, 4.0, 8.0, 16.0):
            line = control.run(cell, seed, seconds, torch.device("cpu"))
            if cell.mix["kind"] != "closed_loop" or \
                    line["attempted"] >= 4096:
                break
        if cell.mix["kind"] == "closed_loop":
            assert line["attempted"] >= 4096, line["attempted"]
        assert not line["correct"], (seed, line["checks"])


# -- the inputs ------------------------------------------------------------

def test_inputs_fixed_by_seed_and_sized_alike():
    config = {"n_files": 32, "file_bases": [400, 3000],
              "repeat_fraction": 0.3, "repeat_unit": 100}
    a, b = data.archive(config, SEED), data.archive(config, SEED)
    assert all((x == y).all() for x, y in zip(a, b))
    c = data.archive(config, SEED + 1)
    assert sorted(map(len, a)) == sorted(map(len, c))
    assert any((len(x) != len(y)) or (x != y).any() for x, y in zip(a, c))


def test_reads_fixed_by_seed_and_sized_alike():
    genomes = data.archive({"n_files": 16, "file_bases": [400, 3000],
                            "repeat_fraction": 0.3, "repeat_unit": 100}, 3)
    a, b, c = (data.read_pool(genomes, 5, 32, 230, 0.5, 1, s, "cpu",
                              chunk=64)
               for s in (SEED, SEED, SEED + 1))
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    assert not np.array_equal(a[0], c[0])
    assert ((a[1] >= 0).sum(1) == 16).all() and ((c[1] >= 0).sum(1) == 16).all()


def test_reads_half_poisoned():
    genomes = data.archive({"n_files": 16, "file_bases": [400, 3000],
                            "repeat_fraction": 0.3, "repeat_unit": 100}, 3)
    reads, sources = data.read_pool(genomes, 2, 128, 230, 0.5, 1, 1, "cpu")
    assert reads.shape == (2, 128, 230) and (sources >= 0).sum() == 128
    for r, f in zip(reads.reshape(-1, 230), sources.reshape(-1)):
        if f >= 0:
            assert any((genomes[f][s:s + 230] == r).all()
                       for s in range(len(genomes[f]) - 229))


def bench_modules(folder: str) -> list:
    """The modules of one folder of the benchmark, by their import names."""
    return sorted(f"{folder}.{p.stem}" for p in (spec.BENCH / folder).glob(
        "*.py") if p.stem != "__init__")


GUARDED = (bench_modules("engines") + bench_modules("reference")
           + bench_modules("loops") + ["control"])


def test_no_jax_module_loaded():
    """The harness, every adapter, reference and loop, and the program
    load neither JAX nor the JAX package (top-level names compared
    whole)."""
    code = ("import importlib, sys; sys.path[:0] = [%r, %r]\n"
            "from harness import runner\n"
            "for name in %r: importlib.import_module(name)\n"
            "import repro_torch.serving.service, repro_torch.index.ingest\n"
            "import repro_torch.index.engines\n"
            "print(runner.forbidden_loaded())" % (
                str(spec.BENCH), str(spec.ROOT / "src"), GUARDED))
    assert {"engines.bitsliced", "engines.rambo", "reference.rambo",
            "loops.closed_loop"} <= set(GUARDED)
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, check=True)
    assert out.stdout.strip() == "[]"


# the functions the loops and the control call on an engine's adapter:
# the positional parameters in order, then the keyword-only ones
ADAPTER = {
    "new_index": (("config", "device"), ()),
    "build": (("index", "genomes", "read_bases", "chunk_reads"), ()),
    "output_words": (("index",), ()),
    "reference_words": (("config", "genomes", "device"),
                        ("skip_last_kmer",)),
    "reference_verdicts": (("config", "words", "reads", "theta"),
                           ("slack",)),
    "probe_bytes_each": (("config", "batches", "device"), ()),
    "insert_bytes": (("config", "reads", "file_ids", "device"), ()),
    "insert_batches": (("config", "genomes", "read_bases", "chunk_reads"),
                       ()),
}


@pytest.mark.parametrize("module", bench_modules("engines"))
def test_adapter_defines_the_contract(module):
    adapter = importlib.import_module(module)
    for name, (positional, keyword) in ADAPTER.items():
        fn = getattr(adapter, name, None)
        assert callable(fn), f"{module} lacks {name}"
        params = list(inspect.signature(fn).parameters.values())
        pos = [p.name for p in params
               if p.kind is p.POSITIONAL_OR_KEYWORD][:len(positional)]
        assert tuple(pos) == positional, (module, name, pos)
        kw = {p.name for p in params if p.kind is p.KEYWORD_ONLY}
        assert set(keyword) <= kw, (module, name, kw)
        extra = [p for p in params[len(positional):]
                 if p.name not in keyword]
        assert all(p.default is not p.empty for p in extra), (module, name)


def test_forbidden_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_extra", object())
    assert runner.forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "repro.core", object())
    assert runner.forbidden_loaded() == ["repro"]


def test_cli_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run(
        [sys.executable, str(spec.BENCH / "run.py"), "--workload",
         BENCHMARK_CELLS[0], "--seed", "1", "--seconds", "1", "--trace",
         "0"],
        capture_output=True, text=True, cwd=spec.ROOT)
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.cuda
def test_cli_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, str(spec.BENCH / "run.py"), "--workload",
         "bitsliced-idl.query", "--seed", str(SEED), "--seconds", "2",
         "--trace", "1"], capture_output=True, text=True, cwd=spec.ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["busy_s"] > 0
