"""PyTorch port vs the JAX reference for the paper-side modules: the FPR
theory (Theorem 2) and the cache/block-switch model, both exactly equal,
and the three torch examples run on the CPU with the reference examples'
recall and agreement lines."""

import importlib.util
import itertools
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.core import cache_model as j_cache_model  # noqa: E402
from repro.core import idl as j_idl  # noqa: E402
from repro.core import theory as j_theory  # noqa: E402
from repro.data import genome as j_genome  # noqa: E402
from repro.index import registry as j_registry  # noqa: E402
from repro_torch.core import cache_model, theory  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (m, n, eta, L, k, t): filter bits, inserted kmers, repetitions, window,
# kmer and sub-kmer lengths — small and paper-scale, with the degenerate
# corners (a window smaller than w2, a filter smaller than w1·eta)
GRID = list(itertools.product(
    (1 << 10, 1 << 20, 1 << 32), (1, 5_000, 4_600_000), (1, 2, 4, 7),
    (1 << 6, 1 << 15, 1 << 17), (31, 21), (16, 12)))


def test_theory_equals_reference_on_a_grid():
    for m, n, eta, L, k, t in GRID:
        assert theory.bf_fpr(m, n, eta) == j_theory.bf_fpr(m, n, eta)
        assert theory.bf_optimal_eta(m, n) == j_theory.bf_optimal_eta(m, n)
        assert (theory.idl_bf_fpr_bound(m, n, eta, L, k, t)
                == j_theory.idl_bf_fpr_bound(m, n, eta, L, k, t))
        assert (theory.idl_bf_fpr_bound(m, n, eta, L, k, t, w1=k + 1, w2=9)
                == j_theory.idl_bf_fpr_bound(m, n, eta, L, k, t, w1=k + 1,
                                             w2=9))
        assert (theory.idl_bf_fpr_bound_exact(m, n, eta, L, k, t)
                == j_theory.idl_bf_fpr_bound_exact(m, n, eta, L, k, t))
        assert (theory.idl_limit_bound(L, eta, k, t)
                == j_theory.idl_limit_bound(L, eta, k, t))
        assert (theory.grid_best_eta(m, n, L, k, t)
                == j_theory.grid_best_eta(m, n, L, k, t))
        assert (theory.expected_adjacent_jaccard(k, t)
                == j_theory.expected_adjacent_jaccard(k, t))
    for n, eps in itertools.product((1, 1000, 10**9), (0.5, 1e-2, 1e-9)):
        assert theory.bf_size_for_fpr(n, eps) == j_theory.bf_size_for_fpr(n, eps)
    assert theory.idl_bf_fpr_bound_exact(64, 10, 4, 1 << 10) == 1.0


def _traces():
    rng = np.random.default_rng(7)
    cfg = j_idl.IDLConfig(k=31, t=16, L=1 << 12, eta=4, m=1 << 22)
    read = jnp.asarray(j_genome.synthesize_genome(400, seed=5))
    return {
        "random": rng.integers(0, 1 << 26, size=5000, dtype=np.int64),
        "local": np.cumsum(rng.integers(0, 600, size=4000)).astype(np.uint32),
        "empty": np.zeros(0, dtype=np.int64),
        "idl": np.asarray(j_registry.locations(cfg, read, "idl")),
        "rh": np.asarray(j_registry.locations(cfg, read, "rh")),
    }


@pytest.mark.parametrize("as_tensor", [False, True], ids=["numpy", "tensor"])
def test_cache_model_equals_reference(as_tensor):
    def arg(a):
        return torch.as_tensor(np.asarray(a).astype(np.int64)) if as_tensor else a

    for name, tr in _traces().items():
        flat = tr.reshape(-1)
        for block in (64, 512, 1 << 12, 1 << 15):
            assert (cache_model.count_block_dmas(arg(flat), block)
                    == j_cache_model.count_block_dmas(flat, block)), name
            assert (cache_model.count_block_dmas_partitioned(arg(tr), block)
                    == j_cache_model.count_block_dmas_partitioned(tr, block))
        got = cache_model.probe_trace_from_locations(arg(tr))
        want = j_cache_model.probe_trace_from_locations(tr)
        np.testing.assert_array_equal(np.asarray(got), want)
        for l1, l3, line in ((2 << 20, 256 << 20, 64), (1 << 12, 1 << 15, 64),
                             (256, 4096, 32)):
            assert (cache_model.two_level_miss_rates(arg(flat), l1, l3, line)
                    == j_cache_model.two_level_miss_rates(flat, l1, l3, line))
        lru, j_lru = cache_model.LRUCache(1 << 13), j_cache_model.LRUCache(1 << 13)
        half = len(flat) // 2
        for part in (flat[:half], flat[half:]):
            got = lru.access_trace(arg(part))
            want = j_lru.access_trace(part)
            assert (got.accesses, got.misses, got.miss_rate) == (
                want.accesses, want.misses, want.miss_rate)
        misses = [lru.access(int(a)) for a in flat[:64]]
        assert misses == [j_lru.access(int(a)) for a in flat[:64]]
        assert (lru.stats.accesses, lru.stats.misses) == (
            j_lru.stats.accesses, j_lru.stats.misses)
    assert cache_model.CacheStats().miss_rate == 0.0


def test_cache_model_reads_a_trace_once():
    """A tensor trace is copied to the host once, then counted as numpy."""
    locs = torch.arange(0, 40_000, 8, dtype=torch.int64).reshape(4, -1)
    assert (cache_model.count_block_dmas_partitioned(locs, 1024)
            == j_cache_model.count_block_dmas_partitioned(locs.numpy(), 1024))
    assert isinstance(cache_model.probe_trace_from_locations(locs), np.ndarray)


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_torch_quickstart_prints_the_reference_lines(capsys):
    _example("torch_quickstart").main(["--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "indexed 49970 kmers into a 2048 KiB IDL-BF (fill = 0.010)"
    for i in range(3):
        assert f"read {i}: genuine -> True, 1-poisoned -> False" in out
    # the block-switch lines against the reference's own cache model over
    # the reference's locations of the same read
    cfg = j_idl.IDLConfig(k=31, t=16, L=1 << 15, eta=4, m=1 << 24)
    g = j_genome.synthesize_genome(50_000, seed=0)
    read0 = jnp.asarray(j_genome.extract_reads(g, 230, 5, seed=1)[0])
    for name in ("idl", "rh"):
        d = j_cache_model.count_block_dmas_partitioned(
            np.asarray(j_registry.locations(cfg, read0, name)), cfg.L)
        assert (f"{name.upper()}: {d['switches']} block DMAs for "
                f"{d['accesses']} probes "
                f"({d['switches'] / d['accesses']:.2%} per probe)") in out
    assert "idl_probe backend agrees: True" in out
    assert "sharded backend agrees:   True" in out
    assert "idl_insert backend agrees: True" in out
    assert out[-1].startswith("served ragged lengths [230, 120, 90] -> "
                              "matches [True, True, True]")


def test_torch_rambo_scale_recall(capsys):
    _example("torch_rambo_scale").main(["--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert [line[:3] for line in out] == ["rh ", "idl"]
    for line in out:
        assert "2x20 filters, 10.5 MB" in line
        assert "recall 20/20" in line


def test_torch_genesearch_service_live_recall(capsys):
    _example("torch_genesearch_service").main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "before live ingest: recall 0/4" in out
    assert "after live ingest: recall 4/4" in out
    for fid in (3, 17, 40, 59):
        assert f"matched [{fid}]" in out
    assert ("compacted -> base v1 (0 delta batches left); recall still 4/4 "
            "at v1; runners unchanged: True") in out
