"""PyTorch port vs the JAX reference: the membership cache and the service
surface it keys on (version, ``swap_state``, ``cache_stats``), and the
``idl-bbf`` configuration the port refuses.

Inputs are made with numpy and handed to both packages; answers, cached
rows and cache counters are compared exactly. The reference's cases are
those of ``tests/test_kmer_cache.py``, at its sizes.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.core import idl as j_idl  # noqa: E402
from repro.index import engines as j_engines  # noqa: E402
from repro.index import lsm as j_lsm  # noqa: E402
from repro.serving import kmer_cache as j_kc  # noqa: E402
from repro.serving import live as j_live  # noqa: E402
from repro.serving import service as j_service  # noqa: E402
from repro_torch.core import idl  # noqa: E402
from repro_torch.index import engines, lsm, registry  # noqa: E402
from repro_torch.index import state as state_mod  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    AsyncScheduler,
    GeneSearchService,
    KmerCache,
    KmerCacheConfig,
    LiveGeneSearchService,
    LiveReplicaRouter,
    RouterConfig,
    SchedulerConfig,
    ServiceConfig,
    kmer_cache,
    merge_cache_stats,
    pack_codes,
)

ENGINES = ["bloom", "cobs", "rambo", "bitsliced"]
CAPACITY = 1 << 14
TIMEOUT = 60


def _cfg(pkg, m: int = 1 << 16):
    return pkg.IDLConfig(k=31, t=16, L=1 << 10, eta=2, m=m)


@pytest.fixture(scope="module")
def reads():
    return np.random.default_rng(0xC0FFEE).integers(
        0, 4, size=(6, 120), dtype=np.uint8)


@pytest.fixture(scope="module")
def queries(reads):
    lens = [120, 100, 77, 120, 61, 99]
    return [reads[i][:n] for i, n in enumerate(lens)]


def _build(name: str, reads, scheme: str = "idl", port: bool = True):
    """The base index over reads[:3], built by the port (on the CPU) or by
    the reference."""
    e, kw = (engines, {"device": "cpu"}) if port else (j_engines, {})
    cfg = _cfg(idl if port else j_idl)
    r = reads[:3] if port else jnp.asarray(reads[:3])
    if name == "bloom":
        return e.PackedBloomIndex.build(cfg, scheme, **kw).insert_batch(r)
    if name == "cobs":
        return e.CobsIndex.build([100, 200, 150], cfg, scheme=scheme,
                                 n_groups=2, **kw).insert_batch(
                                     r, np.arange(3))
    if name == "rambo":
        return e.RamboIndex.build(5, _cfg(idl if port else j_idl, 1 << 14),
                                  scheme=scheme, B=2, R=2,
                                  **kw).insert_batch(r, np.arange(3))
    return e.BitSlicedIndex.build(cfg, scheme, n_files=40, **kw
                                  ).insert_batch(r, np.asarray([0, 9, 39]))


def _matches(results) -> list:
    return [np.asarray(r.matches) for r in results]


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _msmt_rows(eng, queries) -> list:
    """The port engine's own ``msmt`` row for each query."""
    return [eng.msmt(q[None])[0].numpy() for q in queries]


def _result(target, reads) -> list:
    """Submit every read, then wait on each future with a timeout."""
    futures = [target.submit(r) for r in reads]
    return [f.result(timeout=TIMEOUT) for f in futures]


# -- the data structure ------------------------------------------------------

def _keys(*vals) -> np.ndarray:
    return np.asarray(vals, dtype=np.uint64)


def _rows(*vals) -> np.ndarray:
    return np.asarray([[v, v, v] for v in vals], dtype=np.uint32)


def _lru_scenario(mod):
    c = mod.KmerCache(2)
    c.begin(0)
    out = [c.lookup(_keys(10, 20))]
    c.insert(_keys(10, 20), _rows(1, 2))
    out.append(c.lookup(_keys(10)))
    c.insert(_keys(30), _rows(3))
    out.append(c.lookup(_keys(10, 20, 30)))
    return out, c.stats()


def _generation_scenario(mod):
    c = mod.KmerCache(8)
    c.begin(0)
    c.insert(_keys(1, 2), _rows(1, 2))
    c.begin(0)
    seen = [(len(c), c.invalidations)]
    c.begin(1)
    seen.append((len(c), c.invalidations))
    c.begin(2)
    seen.append((len(c), c.invalidations))
    return seen, c.stats()


def _counters_scenario(mod):
    c = mod.KmerCache(8)
    c.begin(0)
    out = [c.lookup(_keys(7, 8))]
    c.insert(_keys(7), _rows(1))
    out.append(c.lookup(_keys(7, 8)))
    return out, c.stats()


def _nursery_scenario(mod):
    c = mod.KmerCache(16)
    c.begin(0)
    sizes = []
    for start in range(0, 64, 8):
        keys = np.arange(start, start + 8, dtype=np.uint64)
        c.lookup(keys)
        c.insert(keys, _rows(*range(start, start + 8)))
        sizes.append(len(c))
    out = [c.lookup(np.arange(56, 64, dtype=np.uint64))]
    return (out, sizes), c.stats()


def _large_scenario(mod):
    """Past the nursery's merge size and the capacity, with the main
    tier's slot table and its collision fallback in use."""
    rng = np.random.default_rng(5)
    c = mod.KmerCache(6000)
    c.begin(0)
    out = []
    for step in range(6):
        keys = np.unique(rng.integers(0, 1 << 62, size=3000,
                                      dtype=np.uint64))
        if step % 2:                          # re-probe an earlier batch
            keys = np.unique(np.concatenate([keys, out[-1][2]]))
        rows, hit = c.lookup(keys)
        out.append((rows, hit, keys))
        c.insert(keys[~hit], rng.integers(0, 1 << 31, size=(
            int((~hit).sum()), 2)).astype(np.uint32))
    return out, c.stats()


def _same_trace(a, b):
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same_trace(x, y)
    elif a is None or isinstance(a, (int, float, str)):
        assert a == b
    else:
        np.testing.assert_array_equal(a, b)


class TestKmerCacheUnit:
    """Each scenario runs on the reference's cache and the port's; the
    rows, hit masks and stats must be equal, and the port's must show the
    reference test's expectations."""

    @pytest.mark.parametrize("scenario", [
        _lru_scenario, _generation_scenario, _counters_scenario,
        _nursery_scenario, _large_scenario])
    def test_scenario_matches_reference(self, scenario):
        want, want_stats = scenario(j_kc)
        got, got_stats = scenario(kmer_cache)
        _same_trace(got, want)
        assert got_stats == want_stats

    def test_least_recently_hit_is_evicted(self):
        (first, refresh, last), st = _lru_scenario(kmer_cache)
        assert first[0] is None and not first[1].any()
        assert refresh[1].all() and refresh[0][0, 0] == 1
        rows, hit = last
        assert list(hit) == [True, False, True]
        np.testing.assert_array_equal(rows[2], _rows(3)[0])
        assert not rows[1].any()
        assert st["evictions"] == 1 and st["entries"] == 2

    def test_generation_change_drops_everything(self):
        seen, _ = _generation_scenario(kmer_cache)
        assert seen == [(2, 0), (0, 1), (0, 1)]

    def test_counters_and_stats_shape(self):
        _, st = _counters_scenario(kmer_cache)
        assert st["hits"] == 1 and st["misses"] == 3
        assert st["lookups"] == 4 and st["hit_rate"] == 0.25
        assert st["entries"] == 1 and st["capacity"] == 8

    def test_nursery_folds_into_main_tier(self):
        (out, sizes), st = _nursery_scenario(kmer_cache)
        assert max(sizes) <= 16
        rows, hit = out[0]
        assert hit.all() and rows[0, 0] == 56
        assert st["evictions"] == 64 - 16

    @pytest.mark.parametrize("k", [1, 2, 5, 31, 32])
    def test_pack_codes_matches_reference(self, k):
        rng = np.random.default_rng(k)
        reads = rng.integers(0, 4, size=(5, 47), dtype=np.uint8)
        codes = pack_codes(reads, k)
        np.testing.assert_array_equal(codes, j_kc.pack_codes(reads, k))
        wins = np.lib.stride_tricks.sliding_window_view(reads, k, axis=1)
        weights = np.uint64(1) << (np.uint64(2)
                                   * np.arange(k, dtype=np.uint64))
        np.testing.assert_array_equal(
            codes, (wins.astype(np.uint64) * weights).sum(
                -1, dtype=np.uint64))

    def test_pack_codes_rejects_by_name(self):
        with pytest.raises(ValueError, match=r"k <= 32 \(got k=33\)"):
            pack_codes(np.zeros((2, 40), dtype=np.uint8), 33)
        with pytest.raises(ValueError, match="no 32-mers"):
            pack_codes(np.zeros((2, 20), dtype=np.uint8), 32)
        with pytest.raises(ValueError):
            KmerCache(0)
        with pytest.raises(ValueError):
            KmerCacheConfig(capacity=0)

    def test_merge_cache_stats_matches_reference(self):
        part = {"hits": 3, "misses": 1, "lookups": 4, "entries": 2,
                "capacity": 8, "evictions": 0, "invalidations": 0}
        for parts in ([], [None, None], [part, None, part],
                      [part, {"hits": 1, "lookups": 1}],
                      [KmerCache(4).stats(), KmerCache(4).stats()]):
            assert merge_cache_stats(parts) == j_kc.merge_cache_stats(parts)
        merged = merge_cache_stats([part, part])
        merged["hits"] = 999
        assert part["hits"] == 3


# -- the static service ------------------------------------------------------

class TestStaticServiceCache:
    @pytest.mark.parametrize("engine", ENGINES)
    def test_cache_on_equals_cache_off(self, reads, queries, engine):
        """Cached and uncached port services and the reference's cached
        service answer alike over two passes, and the port's cache
        counters equal the reference's (its miss sets are probed without
        the reference's 128-kmer floor)."""
        teng = _build(engine, reads)
        jeng = _build(engine, reads, port=False)
        plain = GeneSearchService(teng, ServiceConfig(max_batch=4))
        cached = GeneSearchService(teng, ServiceConfig(
            max_batch=4, kmer_cache=KmerCacheConfig(CAPACITY)))
        jcached = j_service.GeneSearchService(jeng, j_service.ServiceConfig(
            max_batch=4, kmer_cache=j_kc.KmerCacheConfig(CAPACITY)))
        for _ in range(2):
            want = _matches(jcached.search(queries))
            _assert_same(_matches(plain.search(queries)), want)
            _assert_same(_matches(cached.search(queries)), want)
        st = cached.cache_stats()
        assert st == jcached.cache_stats()
        assert st["hits"] > 0 and plain.cache_stats() is None
        assert all(c == 1 for c in cached.compile_counts().values())

    @pytest.mark.parametrize("engine", ["bitsliced", "rambo"])
    def test_cached_rows_equal_reference_rows(self, reads, queries, engine):
        """The rows the cache holds equal the reference cache's, key for
        key (the bit-sliced masks as the same 32 bits)."""
        teng = _build(engine, reads)
        jeng = _build(engine, reads, port=False)
        cached = GeneSearchService(teng, ServiceConfig(
            max_batch=4, kmer_cache=KmerCacheConfig(CAPACITY)))
        jcached = j_service.GeneSearchService(jeng, j_service.ServiceConfig(
            max_batch=4, kmer_cache=j_kc.KmerCacheConfig(CAPACITY)))
        cached.search(queries)
        jcached.search(queries)
        codes = np.unique(pack_codes(np.stack([q[:61] for q in queries]),
                                     31))
        rows, hit = cached.kmer_cache.lookup(codes)
        jrows, jhit = jcached.kmer_cache.lookup(codes)
        assert hit.all() and jhit.all()
        if engine == "bitsliced":
            rows = rows.view(np.uint32)
        np.testing.assert_array_equal(rows, jrows)

    def test_rh_scheme_parity(self, reads, queries):
        teng = _build("bitsliced", reads, scheme="rh")
        jeng = _build("bitsliced", reads, scheme="rh", port=False)
        cached = GeneSearchService(teng, ServiceConfig(
            max_batch=4, kmer_cache=KmerCacheConfig(CAPACITY)))
        jplain = j_service.GeneSearchService(
            jeng, j_service.ServiceConfig(max_batch=4))
        _assert_same(_matches(cached.search(queries)),
                     _matches(jplain.search(queries)))

    def test_swap_state_invalidates_by_generation(self, reads, queries):
        base = _build("bitsliced", reads)
        grown = base.insert_batch(reads[3:5], np.asarray([5, 17]),
                                  donate=False)
        jbase = _build("bitsliced", reads, port=False)
        jgrown = jbase.insert_batch(jnp.asarray(reads[3:5]),
                                    np.asarray([5, 17]), donate=False)
        svc = GeneSearchService(base, ServiceConfig(
            max_batch=4, kmer_cache=KmerCacheConfig(CAPACITY)))
        jsvc = j_service.GeneSearchService(jbase, j_service.ServiceConfig(
            max_batch=4, kmer_cache=j_kc.KmerCacheConfig(CAPACITY)))
        res = svc.search(queries)
        _assert_same(_matches(res), _matches(jsvc.search(queries)))
        assert {r.version for r in res} == {0}
        assert svc.cache_stats()["invalidations"] == 0
        assert svc.swap_state(grown) == jsvc.swap_state(jgrown) == 1
        assert svc.version == 1 and svc.state.words[0] is grown.words
        for _ in range(2):        # stale rows never answer; then re-warm
            res = svc.search(queries)
            _assert_same(_matches(res), _matches(jsvc.search(queries)))
            _assert_same(_matches(res), _msmt_rows(grown, queries))
            assert {r.version for r in res} == {1}
        assert svc.cache_stats() == jsvc.cache_stats()
        assert svc.cache_stats()["invalidations"] >= 1

    def test_swap_state_refuses_another_k_and_drops_runners(self, reads,
                                                            queries):
        svc = GeneSearchService(_build("bitsliced", reads),
                                ServiceConfig(max_batch=4))
        svc.search(queries)
        assert svc.compile_counts()
        other = engines.BitSlicedIndex.build(
            idl.IDLConfig(k=21, t=12, L=1 << 10, eta=2, m=1 << 16), "idl",
            n_files=8, device="cpu")
        with pytest.raises(ValueError, match="kmer size"):
            svc.swap_state(other)
        assert svc.version == 0
        regrown = engines.BitSlicedIndex.build(_cfg(idl), "idl", n_files=64,
                                               device="cpu")
        assert svc.swap_state(regrown, version=7) == 7
        assert svc.compile_counts() == {}    # another meta: runners dropped

    def test_request_latencies_and_k_limit(self, reads, queries):
        svc = GeneSearchService(_build("bitsliced", reads),
                                ServiceConfig(max_batch=4))
        svc.search(queries)
        lat = svc.request_latencies_ms()
        assert len(lat) == len(queries) and all(x >= 0 for x in lat)
        assert svc.cache_stats() is None


# -- the live service --------------------------------------------------------

def _live_pair(reads):
    """A port and a reference live service over the bit-sliced base, both
    with the cache."""
    cfg = ServiceConfig(max_batch=4, kmer_cache=KmerCacheConfig(CAPACITY))
    jcfg = j_service.ServiceConfig(max_batch=4,
                                   kmer_cache=j_kc.KmerCacheConfig(CAPACITY))
    return (LiveGeneSearchService(lsm.LiveIndex(_build("bitsliced", reads)),
                                  cfg),
            j_live.LiveGeneSearchService(
                j_lsm.LiveIndex(_build("bitsliced", reads, port=False)),
                jcfg))


class TestLiveCacheSemantics:
    def test_write_flips_cached_base_miss(self, reads):
        svc, jsvc = _live_pair(reads)
        probe = reads[3]
        pre = svc.search([probe])[0]
        assert not pre.matches[5]
        svc.search([probe])
        assert svc.kmer_cache.hits > 0
        svc.apply_insert(reads[3:5], [5, 17])
        post = svc.search([probe])[0]
        assert post.matches[5] and post.delta_seq == 1
        assert svc.kmer_cache.invalidations == 1
        assert svc._base_cache.invalidations == 0
        assert svc._base_cache.hits > 0
        jsvc.search([probe])
        jsvc.search([probe])
        jsvc.apply_insert(reads[3:5], [5, 17])
        jpost = jsvc.search([probe])[0]
        np.testing.assert_array_equal(post.matches, np.asarray(jpost.matches))
        assert svc.cache_stats() == jsvc.cache_stats()
        union = _build("bitsliced", reads).insert_batch(
            reads[3:5], np.asarray([5, 17]))
        _assert_same(_matches(svc.search([probe])),
                     _msmt_rows(union, [probe]))

    def test_router_insert_flips_on_every_replica(self, reads, queries):
        base = _build("bitsliced", reads)
        rt = LiveReplicaRouter(
            base, ServiceConfig(max_batch=4,
                                kmer_cache=KmerCacheConfig(CAPACITY)),
            RouterConfig(n_replicas=2, policy="round_robin"))
        with rt:
            probe = reads[3]
            for res in _result(rt, [probe, probe]):
                assert not res.matches[5]
            for f in rt.insert(reads[3:5], np.asarray([5, 17])):
                f.result(timeout=TIMEOUT)
            for res in _result(rt, [probe, probe]):
                assert res.matches[5]
            union = _build("bitsliced", reads).insert_batch(
                reads[3:5], np.asarray([5, 17]))
            _assert_same(_matches(_result(rt, queries * 2)),
                         _msmt_rows(union, queries * 2))
            cs = rt.cache_stats()
            assert cs is not None and cs["hits"] > 0
            assert cs["invalidations"] == 2
            for rep in rt._replicas:
                assert rep.service._base_cache.invalidations == 0

    def test_compaction_publish_invalidates(self, reads, queries):
        svc, jsvc = _live_pair(reads)
        for s in (svc, jsvc):
            s.apply_insert(reads[3:5], [5, 17])
        union = _build("bitsliced", reads).insert_batch(
            reads[3:5], np.asarray([5, 17]))
        want = _msmt_rows(union, queries)
        _assert_same(_matches(svc.search(queries)), want)
        jsvc.search(queries)
        assert svc.compact() == jsvc.compact() == 1
        for _ in range(2):
            res = svc.search(queries)
            _assert_same(_matches(res), want)
            _assert_same(_matches(jsvc.search(queries)), want)
            assert {(r.version, r.delta_seq) for r in res} == {(1, 1)}
        assert svc.cache_stats() == jsvc.cache_stats()
        assert svc.cache_stats()["invalidations"] >= 1

    def test_scheduler_batches_carry_cache_counters(self, reads, queries):
        svc = GeneSearchService(_build("bitsliced", reads), ServiceConfig(
            max_batch=4, kmer_cache=KmerCacheConfig(CAPACITY)))
        sched = AsyncScheduler(svc, SchedulerConfig(max_delay_ms=0.0))
        try:
            want = _msmt_rows(_build("bitsliced", reads), queries * 3)
            _assert_same(_matches(_result(sched, queries * 3)), want)
            recs = list(sched.stats)
            assert sum(r.cache_lookups for r in recs) > 0
            assert sum(r.cache_hits for r in recs) > 0
            assert all(r.cache_hits <= r.cache_lookups for r in recs)
            st = sched.cache_stats()
            assert st["lookups"] == sum(r.cache_lookups for r in recs)
            assert st["hits"] == sum(r.cache_hits for r in recs)
        finally:
            sched.close()


def test_cache_copies_are_counted(reads, queries):
    """The cached path counts the bytes of its two copies: every batch's
    rows up for the postlude, the probed distinct miss rows down; a warm
    pass copies nothing down and as much up."""
    svc = GeneSearchService(_build("bitsliced", reads), ServiceConfig(
        max_batch=4, kmer_cache=KmerCacheConfig(CAPACITY)))
    up, down = svc._obs_bytes_up, svc._obs_bytes_down
    svc.search(queries)
    up1, down1 = up.value, down.value
    # every distinct kmer missed once; a row is W = 2 words of 4 bytes
    assert down1 == svc.cache_stats()["entries"] * 2 * 4
    svc.search(queries)
    assert down.value == down1 and up.value == 2 * up1 > 0
    assert up1 == sum(bs.batch_rows * bs.bucket * 2 * 4
                      for bs in list(svc.batch_stats)[:len(
                          svc.batch_stats) // 2])
    assert svc.cache_copy_bytes() == (2 * up1, down1)


def test_cache_stages_are_timed(reads, queries):
    """Each cached batch times its stages: pack, lookup and upload every
    batch; miss and probe only when something missed."""
    from repro_torch.obs import metrics as obs_metrics

    def calls():
        hists = obs_metrics.DEFAULT.snapshot()["hists"].get(
            "serving.cache_stage_ms", {})
        return {obs_metrics.parse_label_key(k)["stage"]: h["count"]
                for k, h in hists.items()}

    svc = GeneSearchService(_build("bitsliced", reads), ServiceConfig(
        max_batch=4, kmer_cache=KmerCacheConfig(CAPACITY)))
    c0 = calls()
    svc.search(queries)
    c1 = calls()
    n = len(svc.batch_stats)
    for stage in ("pack", "lookup", "upload", "miss", "probe"):
        assert c1.get(stage, 0) - c0.get(stage, 0) == n
    svc.search(queries)                       # warm: nothing misses
    c2 = calls()
    for stage in ("pack", "lookup", "upload"):
        assert c2[stage] - c1[stage] == n
    assert c2["miss"] == c1["miss"] and c2["probe"] == c1["probe"]


# -- the idl-bbf repair ------------------------------------------------------

BBF_SMALL_L = dict(k=31, t=16, L=256, eta=2, m=4096)


def test_idl_bbf_narrow_window_is_refused():
    """idl-bbf with L < 512 (the block): the reference's probes land past
    m, its insert drops them and ``msmt`` of the indexed read answers
    ``[False]``, a false negative; the port refuses the configuration by
    name before any engine allocates words."""
    read = np.random.default_rng(21).integers(0, 4, size=(1, 40),
                                              dtype=np.uint8)
    jeng = j_engines.PackedBloomIndex.build(j_idl.IDLConfig(**BBF_SMALL_L),
                                            "idl-bbf")
    jeng = jeng.insert_batch(jnp.asarray(read))
    assert np.asarray(jeng.msmt(jnp.asarray(read))).tolist() == [False]

    cfg = idl.IDLConfig(**BBF_SMALL_L)
    msg = r"idl-bbf needs L >= block_bits \(512\); got L=256"
    with pytest.raises(ValueError, match=msg):
        registry.check_config(cfg, "idl-bbf")
    with pytest.raises(ValueError, match=msg):
        engines.PackedBloomIndex.build(cfg, "idl-bbf", device="cpu")
    with pytest.raises(ValueError, match=msg):
        engines.CobsIndex.build([100, 200], cfg, "idl-bbf", device="cpu")
    with pytest.raises(ValueError, match=msg):
        engines.RamboIndex.build(4, cfg, "idl-bbf", B=2, R=2, device="cpu")
    with pytest.raises(ValueError, match=msg):
        engines.BitSlicedIndex.build(cfg, "idl-bbf", 8, device="cpu")
    with pytest.raises(ValueError, match=msg):      # snapshots, states
        state_mod.StateMeta(engine="bloom", scheme="idl-bbf", cfgs=(cfg,))
    # other schemes at that L, and idl-bbf at L >= 512, are untouched
    registry.check_config(cfg, "idl")
    wide = idl.IDLConfig(**{**BBF_SMALL_L, "L": 512, "m": 8192})
    eng = engines.PackedBloomIndex.build(wide, "idl-bbf", device="cpu")
    jwide = j_engines.PackedBloomIndex.build(
        j_idl.IDLConfig(**{**BBF_SMALL_L, "L": 512, "m": 8192}), "idl-bbf")
    eng = eng.insert_batch(read)
    jwide = jwide.insert_batch(jnp.asarray(read))
    np.testing.assert_array_equal(eng.words.numpy().view(np.uint32),
                                  np.asarray(jwide.words))
    assert eng.msmt(read).tolist() == [[True]]     # one file's column
