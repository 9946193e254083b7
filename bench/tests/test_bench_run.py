"""The harness end to end on the CPU at smoke size: each cell's run is
correct against the reference, a run whose timed path is broken is not,
the control reads above the limit, and the inputs are fixed by the
seed."""

import dataclasses
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

CELLS = [w["name"] for w in spec.load_json(spec.SPEC_FILE)["workloads"]]
SEED = 2**31 + 977          # seeds past 32 signed bits


def run_cpu(cell, seconds=0.4, trace=False):
    return runner.run(cell, SEED, seconds, trace, torch.device("cpu"),
                      time.monotonic())


@pytest.mark.parametrize("name", CELLS)
def test_cell_correct_on_cpu(smoke_cell, name):
    line = run_cpu(smoke_cell(name))
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

def _unchanged_state(monkeypatch):
    from repro_torch.index import engines

    monkeypatch.setattr(engines.BitSlicedIndex, "insert_batch",
                        lambda self, reads, file_ids=None, **kw: self)


def _half_batch(monkeypatch):
    from repro_torch.index import engines
    from repro_torch.serving import service

    insert = engines.BitSlicedIndex.insert_batch

    def half_insert(self, reads, file_ids=None, **kw):
        h = len(reads) // 2
        return insert(self, reads[:h], file_ids[:h], **kw)

    finalize = service.GeneSearchService._finalize

    def half_finalize(self, take, bucket, out):
        results = finalize(self, take, bucket, out)
        for r in results[len(results) // 2:]:     # left out: no hits
            r.matches[:] = False
        return results

    monkeypatch.setattr(engines.BitSlicedIndex, "insert_batch", half_insert)
    monkeypatch.setattr(service.GeneSearchService, "_finalize",
                        half_finalize)


def _altered_answer(monkeypatch):
    from repro_torch.index import engines
    from repro_torch.serving import service

    insert = engines.BitSlicedIndex.insert_batch

    def altered_insert(self, reads, file_ids=None, **kw):
        out = insert(self, reads, file_ids, **kw)
        out.words.view(-1)[7] ^= 1 << 3
        return out

    finalize = service.GeneSearchService._finalize

    def altered_finalize(self, take, bucket, out):
        results = finalize(self, take, bucket, out)
        results[0].matches[5] = not results[0].matches[5]
        return results

    monkeypatch.setattr(engines.BitSlicedIndex, "insert_batch",
                        altered_insert)
    monkeypatch.setattr(service.GeneSearchService, "_finalize",
                        altered_finalize)


FAULTS = {"state unchanged": _unchanged_state,
          "half the batch left out": _half_batch,
          "an answer altered where it is produced": _altered_answer}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_fault_fails_the_check(smoke_cell, monkeypatch, name, fault):
    FAULTS[fault](monkeypatch)
    line = run_cpu(smoke_cell(name))
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_check(smoke_cell, name):
    """The control (the reference with one guarantee broken, planted in
    the program's place) turns the run's `correct` false, on three seeds,
    through the same check as a run of the program."""
    cell = smoke_cell(name)
    if cell.mix["kind"] == "closed_loop":
        # thousands of answers compared, as at the cells' own sizes (the
        # control flips about one poisoned read in 115)
        cell = dataclasses.replace(cell, mix=dict(
            cell.mix, batch_reads=64, check_per_batch=64,
            pool_reads_per_s=20000))
    for seed in (11, 12, 2**31 + 5):
        line = control.run(cell, seed, 2.0, torch.device("cpu"))
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


def test_no_jax_module_loaded():
    """The harness, the reference and the program load neither JAX nor
    the JAX package (top-level names compared whole)."""
    code = ("import sys; sys.path[:0] = [%r, %r]\n"
            "from harness import runner\n"
            "import reference.index, engines.bitsliced, loops.closed_loop, "
            "loops.build_passes, control\n"
            "import repro_torch.serving.service, repro_torch.index.ingest\n"
            "print(runner.forbidden_loaded())" % (str(spec.BENCH),
                                                  str(spec.ROOT / "src")))
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, check=True)
    assert out.stdout.strip() == "[]"


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
         CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"],
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
