"""PyTorch port vs the JAX reference for the slice as a whole: snapshots
carried across, the serving front end, the launcher, and the port's
independence from JAX. Every comparison is exact."""

import dataclasses
import json
import os
import pkgutil
import re
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

import repro_torch  # noqa: E402
from repro.configs import idl_genesearch as j_configs  # noqa: E402
from repro.data import genome as j_genome  # noqa: E402
from repro.index import engines as j_engines  # noqa: E402
from repro.index import store as j_store  # noqa: E402
from repro.serving import service as j_service  # noqa: E402
from repro_torch.configs import idl_genesearch  # noqa: E402
from repro_torch.data import genome  # noqa: E402
from repro_torch.core import idl  # noqa: E402
from repro_torch.index import engines, ingest, query  # noqa: E402
from repro_torch.index import state as state_mod, store  # noqa: E402
from repro_torch.obs import metrics as obs_metrics  # noqa: E402
from repro_torch.obs import trace as obs_trace  # noqa: E402
from repro_torch.serving import service  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")


@pytest.fixture(scope="module")
def built():
    """The smoke config over 64 synthetic genomes, built by both packages
    (the reference with its jnp backend, the port with idl_insert)."""
    cfg = idl_genesearch.smoke_config()
    jcfg = j_configs.smoke_config()
    archive = genome.synth_archive(cfg.n_files, genome_len=1500, seed=3)
    jeng = j_engines.BitSlicedIndex.build(jcfg.idl_config(), jcfg.scheme,
                                          jcfg.n_files)
    for f in archive:
        jeng = jeng.insert_batch(jnp.asarray(f.genome)[None],
                                 np.asarray([f.file_id], np.int32))
    teng = engines.BitSlicedIndex.build(cfg.idl_config(), cfg.scheme,
                                        cfg.n_files, device="cpu")
    teng = ingest.build_archive(teng, archive, read_len=cfg.read_len,
                                chunk_reads=16)
    return cfg, archive, jeng, teng


def _queries(archive, rng, n=10):
    """Ragged reads: substrings of indexed genomes and random reads."""
    out = []
    for i in range(n):
        length = int(rng.integers(40, 160))
        if i % 3 == 2:
            out.append(rng.integers(0, 4, size=length, dtype=np.uint8))
        else:
            g = archive[int(rng.integers(0, len(archive)))].genome
            s = int(rng.integers(0, len(g) - length))
            out.append(np.asarray(g[s:s + length]))
    return out


def test_synth_archive_matches_reference():
    a = genome.synth_archive(5, genome_len=3000, seed=11)
    b = j_genome.synth_archive(5, genome_len=3000, seed=11)
    for x, y in zip(a, b):
        assert x.file_id == y.file_id
        np.testing.assert_array_equal(x.genome, y.genome)
        np.testing.assert_array_equal(x.reads(100, 3), y.reads(100, 3))
    np.testing.assert_array_equal(genome.window_reads(a[0].genome, 230, 31),
                                  j_genome.window_reads(b[0].genome, 230, 31))


def test_build_archive_matches_reference_engine(built):
    _, _, jeng, teng = built
    np.testing.assert_array_equal(teng.words.numpy().view(np.uint32),
                                  np.asarray(jeng.words))


def test_reference_snapshot_loads_in_port(built, tmp_path, rng):
    cfg, archive, jeng, _ = built
    j_store.save(jeng, str(tmp_path / "snap"))
    for verify in ("eager", "lazy", "off"):
        st = store.load(str(tmp_path / "snap"), device="cpu", verify=verify)
        assert store.check_verified(str(tmp_path / "snap"))
        assert st.meta == store.read_meta(str(tmp_path / "snap"))
        reads = np.stack([q[:100] for q in _queries(archive, rng, 12)
                          if len(q) >= 100])
        for theta in (1.0, 0.6):
            want = np.asarray(jeng.msmt(jnp.asarray(reads), theta=theta))
            got = state_mod.msmt(st, reads, theta=theta)
            np.testing.assert_array_equal(got.numpy(), want)


def test_port_snapshot_loads_in_reference(built, tmp_path):
    _, _, jeng, teng = built
    store.save(teng, str(tmp_path / "snap"))
    back = j_store.load(str(tmp_path / "snap"))
    np.testing.assert_array_equal(np.asarray(back.words[0]),
                                  np.asarray(jeng.words))
    assert json.load(open(tmp_path / "snap" / "manifest.json"))["version"] == 1


def test_from_numpy_carries_reference_state(built):
    _, _, jeng, teng = built
    st = jeng.state
    meta_json = j_store.meta_to_json(st.meta)
    carried = state_mod.from_numpy(meta_json, [np.asarray(w) for w in st.words],
                                   device="cpu")
    assert torch.equal(carried.words[0], teng.words)
    assert carried.meta == teng.state.meta
    assert store.meta_to_json(carried.meta) == meta_json


def test_bad_snapshots_are_rejected(built, tmp_path):
    _, _, jeng, _ = built
    d = str(tmp_path / "snap")
    j_store.save(jeng, d)
    man = os.path.join(d, "manifest.json")
    good = json.load(open(man))
    with pytest.raises(store.SnapshotError):
        store.load(str(tmp_path / "missing"), device="cpu")
    for bad in ({**good, "format": "other"}, {**good, "version": 2}):
        json.dump(bad, open(man, "w"))
        with pytest.raises(store.SnapshotError):
            store.load(d, device="cpu")
    json.dump(good, open(man, "w"))
    arr = np.load(os.path.join(d, "words_0.npy"))
    arr[0, 0] ^= 1
    np.save(os.path.join(d, "words_0.npy"), arr)
    with pytest.raises(store.SnapshotError):
        store.load(d, device="cpu")
    store.load(d, device="cpu", verify="off")      # specs still match
    store.load(d, device="cpu", verify="lazy")
    with pytest.raises(store.SnapshotError):
        store.check_verified(d)


@pytest.mark.parametrize("theta", [1.0, 0.6, 0.25])
@pytest.mark.parametrize("backend", ["idl_probe", "torch"])
def test_service_matches_reference_service(built, theta, backend):
    _, archive, jeng, teng = built
    queries = _queries(archive, np.random.default_rng(int(theta * 100)), 11)
    jsvc = j_service.GeneSearchService(
        jeng, j_service.ServiceConfig(theta=theta, max_batch=4))
    tsvc = service.GeneSearchService(
        teng, service.ServiceConfig(theta=theta, max_batch=4,
                                    backend=backend))
    want = jsvc.search(queries)
    got = tsvc.search(queries)
    buckets = set()
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.matches, np.asarray(b.matches))
        assert (a.file_ids, a.n_kmers, a.bucket) == \
            (b.file_ids, b.n_kmers, b.bucket)
        buckets.add(a.bucket)
    assert len(buckets) > 1                     # ragged reads, padded buckets
    assert tsvc.compile_counts() == {b: 1 for b in sorted(buckets)}
    assert tsvc.requests_served() == len(queries)
    assert 0 < tsvc.occupancy() < 1             # partial batches were padded
    # engine msmt on the unpadded reads agrees with the padded service
    direct = teng.msmt(queries[0][None], theta=theta, backend=backend)
    np.testing.assert_array_equal(direct.numpy()[0], got[0].matches)


def test_service_from_snapshot_and_admission(built, tmp_path):
    cfg, archive, jeng, _ = built
    j_store.save(jeng, str(tmp_path / "snap"))
    svc = service.GeneSearchService.from_snapshot(
        str(tmp_path / "snap"), service.ServiceConfig(max_batch=2),
        device="cpu")
    read = archive[5].reads(cfg.read_len, 1)[0]
    (res,) = svc.search([read])
    assert 5 in res.file_ids and res.matches.shape == (cfg.n_files,)
    with pytest.raises(ValueError):
        svc.submit(np.zeros((2, 50), np.uint8))          # one read per request
    with pytest.raises(ValueError):
        svc.submit(np.zeros(10, np.uint8))               # no 31-mers
    with pytest.raises(ValueError):
        service.ServiceConfig(backend="jnp")
    assert service.bucket_for(70) == j_service.bucket_for(70) == 128


# -- the service's stage timers ------------------------------------------------

STAGES = ("admit", "wait", "decode", "obs")


def _stage_deltas(before, after, name="serving.stage_ms", **match):
    """``{stage: (count, sum)}`` histogram ``name`` added between two
    registry snapshots, over its series whose labels include ``match``."""
    out = {}
    for lk, h in after["hists"].get(name, {}).items():
        labels = obs_metrics.parse_label_key(lk)
        if any(labels.get(k) != v for k, v in match.items()):
            continue
        old = before["hists"].get(name, {}).get(lk, {"count": 0, "sum": 0.0})
        if h["count"] > old["count"]:
            stage = labels["stage"]
            c, t = out.get(stage, (0, 0.0))
            out[stage] = (c + h["count"] - old["count"],
                          t + h["sum"] - old["sum"])
    return out


def _full_batch(built, n=4):
    """``n`` reads of one kmer bucket: one full batch at ``max_batch=n``."""
    cfg, archive, _, _ = built
    return [archive[i].reads(cfg.read_len, 1)[0] for i in range(n)]


@pytest.mark.parametrize("front", ["service", "scheduler"])
def test_one_batch_observes_each_stage_once(built, front):
    from repro_torch.serving import scheduler

    teng = built[3]
    reads = _full_batch(built)
    svc = service.GeneSearchService(teng, service.ServiceConfig(max_batch=4))
    before = obs_metrics.DEFAULT.snapshot()
    if front == "service":
        got = svc.search(reads)
    else:
        with scheduler.AsyncScheduler(
                svc, scheduler.SchedulerConfig(max_delay_ms=500.0)) as s:
            got = [f.result(timeout=60) for f in
                   [s.submit(r) for r in reads]]
    deltas = _stage_deltas(before, obs_metrics.DEFAULT.snapshot())
    assert sorted(deltas) == sorted(STAGES)
    assert all(c == 1 and t >= 0 for c, t in deltas.values())
    assert [r.file_ids for r in got] == [r.file_ids
                                         for r in svc.search(reads)]


def test_wait_and_decode_split_the_finalize_span(built):
    svc = service.GeneSearchService(built[3],
                                    service.ServiceConfig(max_batch=4))
    before = obs_metrics.DEFAULT.snapshot()
    svc.search(_full_batch(built))
    deltas = _stage_deltas(before, obs_metrics.DEFAULT.snapshot())
    (fin,) = [r for r in list(obs_trace.DEFAULT._ring)[-3:]
              if r[3] == "finalize"]
    split_s = (deltas["wait"][1] + deltas["decode"][1]) * 1e-3
    assert abs(split_s - fin[6]) < 1e-6


def test_search_leaves_the_batch_stages_last_in_the_ring(built):
    svc = service.GeneSearchService(built[3],
                                    service.ServiceConfig(max_batch=4))
    svc.search(_full_batch(built))
    tail = list(obs_trace.DEFAULT._ring)[-3:]
    assert [r[3] for r in tail] == ["assemble", "execute", "finalize"]
    assert all(len(r) == 9 for r in tail)
    for prev, nxt in zip(tail, tail[1:]):                 # shared stamps
        assert abs(prev[5] + prev[6] - nxt[5]) < 1e-6


def test_span_epoch_start_is_the_wall_clock():
    trc = obs_trace.Tracer()
    t = obs_trace.now()
    wall_ns = time.time_ns()
    trc.emit("probe", trc.mint_trace(), None, t, t)
    (rec,) = trc.records()
    assert abs(rec["t0"] * 1e9 - wall_ns) < 2e6


def test_build_archive_times_its_stages(built, monkeypatch):
    cfg, archive, _, _ = built
    sent = []
    insert = engines.BitSlicedIndex.insert_batch

    def counted(self, reads, file_ids=None, **kw):
        sent.append(len(reads))
        return insert(self, reads, file_ids, **kw)

    monkeypatch.setattr(engines.BitSlicedIndex, "insert_batch", counted)
    files = archive[:6]
    teng = engines.BitSlicedIndex.build(cfg.idl_config(), cfg.scheme,
                                        cfg.n_files, device="cpu")
    before = obs_metrics.DEFAULT.snapshot()
    ingest.build_archive(teng, files, read_len=cfg.read_len, chunk_reads=16)
    deltas = _stage_deltas(before, obs_metrics.DEFAULT.snapshot(),
                           "planner.stage_ms", op="build")
    assert sorted(deltas) == ["batch", "insert", "window"]
    assert len(sent) > 1 and set(sent) == {16}
    assert deltas["insert"][0] == deltas["batch"][0] == len(sent)
    assert deltas["window"][0] == len(files)


# -- search()'s array path against submit + flush ------------------------------

def _one_length_reads(built, n, seed):
    """``(n, read_len)`` uint8 reads: cut from indexed genomes, every third
    one random."""
    cfg, archive, _, _ = built
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        if i % 3 == 2:
            out.append(rng.integers(0, 4, size=cfg.read_len, dtype=np.uint8))
        else:
            g = archive[int(rng.integers(0, len(archive)))].genome
            s = int(rng.integers(0, len(g) - cfg.read_len))
            out.append(np.asarray(g[s:s + cfg.read_len], dtype=np.uint8))
    return np.stack(out)


def _counter_deltas(before, after, prefix="serving."):
    """``{name: delta}`` of the registry's counters under ``prefix``,
    summed over their series, the ones that moved."""
    out = {}
    for name, series in after["counters"].items():
        if not name.startswith(prefix):
            continue
        old = before["counters"].get(name, {})
        d = sum(v - old.get(lk, 0.0) for lk, v in series.items())
        if d:
            out[name] = d
    return out


def _per_read(svc, reads):
    """The per-read path: ``submit`` each read, ``flush``, the results."""
    ids = [svc.submit(r) for r in reads]
    svc.flush()
    return [svc.result(i) for i in ids]


def _served(svc, serve):
    """``serve()``'s results, with the ``serving.*`` counters' deltas, the
    stage observations' counts, the batch stats without their wall time
    and the tracer's records, all of that call alone."""
    obs_trace.DEFAULT.clear()
    before = obs_metrics.DEFAULT.snapshot()
    results = serve()
    after = obs_metrics.DEFAULT.snapshot()
    stages = {s: c for s, (c, _) in _stage_deltas(before, after).items()}
    stats = [dataclasses.replace(b, wall_ms=0.0) for b in svc.batch_stats]
    return (results, _counter_deltas(before, after), stages, stats,
            list(obs_trace.DEFAULT._ring))


def _assert_same_results(got, want, same_ids=True):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for f in dataclasses.fields(service.SearchResult):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if f.name == "matches":
                np.testing.assert_array_equal(x, y)
                assert x.dtype == y.dtype and x.flags.writeable
            elif f.name != "request_id" or same_ids:
                assert x == y and type(x) is type(y), f.name


@pytest.mark.parametrize("theta", [1.0, 0.8])
@pytest.mark.parametrize("n", [1, 3, 4, 10])   # max_batch 4: 1, <, =, 2.5x
def test_array_search_matches_the_per_read_path(built, n, theta):
    reads = _one_length_reads(built, n, seed=n)
    cfg = service.ServiceConfig(theta=theta, max_batch=4)
    arr_svc = service.GeneSearchService(built[3], cfg)
    one_svc = service.GeneSearchService(built[3], cfg)
    got, got_c, got_st, got_bs, got_ring = _served(
        arr_svc, lambda: arr_svc.search(reads))
    want, want_c, want_st, want_bs, want_ring = _served(
        one_svc, lambda: _per_read(one_svc, reads))
    _assert_same_results(got, want)
    assert [r.request_id for r in got] == list(range(n))
    np.testing.assert_array_equal(                 # the engine's own msmt
        np.stack([r.matches for r in got]),
        built[3].msmt(reads, theta=theta).numpy())
    assert got_bs == want_bs and len(got_bs) == -(-n // 4)
    assert got_c.pop("serving.array_requests") == n
    assert "serving.array_requests" not in want_c
    assert got_c == want_c and got_c["serving.requests"] == n
    assert got_st == want_st == {s: len(got_bs) for s in STAGES}
    # one request chain a read, each under its own trace id, and the ring
    # ending in the last batch's stages
    assert [r[3] for r in got_ring] == [r[3] for r in want_ring]
    roots = [r for r in got_ring if r[3] == "request"]
    assert sorted(dict(r[8])["rid"] for r in roots) == list(range(n))
    assert len({r[0] for r in roots}) == n
    assert [r[3] for r in got_ring[-3:]] == ["assemble", "execute",
                                             "finalize"]


@pytest.mark.parametrize("case", ["ragged", "pending", "own_ids"])
def test_array_path_stays_off(built, case):
    """Ragged reads, reads queued by ``submit()`` and caller-supplied ids
    take the per-read path: ``serving.array_requests`` does not move."""
    teng = built[3]
    reads = list(_one_length_reads(built, 6, seed=7))
    svc = service.GeneSearchService(teng, service.ServiceConfig(max_batch=4))
    before = obs_metrics.DEFAULT.snapshot()
    if case == "ragged":
        reads[2] = reads[2][:60]
        got = svc.search(reads)
        assert [r.request_id for r in got] == list(range(6))
    elif case == "pending":
        first = svc.submit(reads[0])
        rest = svc.search(np.stack(reads[1:]))
        got = [svc.result(first)] + rest
        assert [r.request_id for r in got] == list(range(6))
        assert svc.batch_stats[0].n_requests == 4      # served first
    else:
        got = svc.search([service.SearchRequest(read=r, request_id=100 + i)
                          for i, r in enumerate(reads)])
        assert [r.request_id for r in got] == list(range(100, 106))
    deltas = _counter_deltas(before, obs_metrics.DEFAULT.snapshot())
    assert "serving.array_requests" not in deltas
    assert deltas["serving.requests"] == 6
    for read, res in zip(reads, got):
        np.testing.assert_array_equal(teng.msmt(read[None]).numpy()[0],
                                      res.matches)


@pytest.mark.parametrize("kind", ["live", "shard"])
def test_subclassed_services_answer_alike_either_way(built, kind):
    """``LiveGeneSearchService`` (a written delta: its ``delta_seq``) and a
    row-probe ``ShardSearchService`` give the same results to ``search``
    of an array as to ``submit`` + ``flush``."""
    from repro_torch.index import lsm, shards
    from repro_torch.serving.live import LiveGeneSearchService
    from repro_torch.serving.scatter import ShardSearchService

    cfg, archive, _, teng = built
    conf = service.ServiceConfig(max_batch=4)
    reads = np.concatenate([_one_length_reads(built, 5, seed=9),
                            archive[40].reads(cfg.read_len, 2)])
    if kind == "live":
        base = engines.BitSlicedIndex.build(cfg.idl_config(), cfg.scheme,
                                            cfg.n_files, device="cpu")
        base = ingest.build_archive(base, archive[:32],
                                    read_len=cfg.read_len, chunk_reads=16)
        live = lsm.LiveIndex(base)
        live.insert(archive[40].reads(cfg.read_len, 4), np.full(4, 40))

        def make():
            return LiveGeneSearchService(live, conf)
    else:
        spec, parts = shards.partition_state(teng, 2)
        assert spec.row_probe

        def make():
            return ShardSearchService(spec, 1, parts[1], conf)
    arr_svc, one_svc = make(), make()
    got = arr_svc.search(reads)
    want = _per_read(one_svc, reads)
    _assert_same_results(got, want)
    assert arr_svc.requests_served() == one_svc.requests_served() == 7
    if kind == "live":
        assert {r.delta_seq for r in got} == {1}
        assert all(40 in r.file_ids for r in got[-2:])


# -- RAMBO's fused merge in the service ---------------------------------------

@pytest.fixture(scope="module")
def rambo_built(built):
    """A RAMBO index over the smoke archive (64 files: B 8, R 6)."""
    cfg, archive, _, _ = built
    rcfg = idl.IDLConfig(k=31, t=16, L=1 << 10, eta=3, m=1 << 18)
    eng = engines.RamboIndex.build(len(archive), rcfg, "idl", device="cpu")
    return ingest.build_archive(eng, archive, read_len=cfg.read_len,
                                chunk_reads=16)


def _merges(before, after):
    """``{path: n}`` batches ``index.rambo_merges`` counted in between."""
    return {p: obs_metrics.counter_total(after, "index.rambo_merges",
                                         {"path": p})
            - obs_metrics.counter_total(before, "index.rambo_merges",
                                        {"path": p})
            for p in ("fused", "per_kmer")}


@pytest.mark.parametrize("theta", [1.0, 0.8])
def test_rambo_service_fuses_the_merge(built, rambo_built, theta):
    """The uncached service over a RAMBO index merges and counts in one
    fused call a batch (``index.rambo_merges{path=fused}``), and answers
    as ``member_coverage(query_batch(read))`` of each read alone: reads of
    70-128 kmers in one 128-kmer bucket, three pad rows. With the
    membership cache on, the merge takes the per-kmer route and the
    answers stay the same."""
    from repro_torch.serving import KmerCacheConfig

    _, archive, _, _ = built
    rng = np.random.default_rng(int(10 * theta))
    reads = []
    for i, n in enumerate((100, 131, 158, 117, 145)):
        g = archive[int(rng.integers(0, len(archive)))].genome
        s = int(rng.integers(0, len(g) - n))
        reads.append(rng.integers(0, 4, size=n, dtype=np.uint8) if i == 3
                     else np.asarray(g[s:s + n], dtype=np.uint8))
    want = [query.member_coverage(rambo_built.query_batch(r[None]),
                                  theta)[0].numpy() for r in reads]
    assert any(w.any() for w in want) and not all(w.all() for w in want)
    conf = service.ServiceConfig(theta=theta, max_batch=8)
    svc = service.GeneSearchService(rambo_built, conf)
    before = obs_metrics.DEFAULT.snapshot()
    got = svc.search(reads)
    after = obs_metrics.DEFAULT.snapshot()
    assert [(b.bucket, b.pad_rows) for b in svc.batch_stats] == [(128, 3)]
    assert _merges(before, after) == {"fused": 1, "per_kmer": 0}
    for res, w in zip(got, want):
        np.testing.assert_array_equal(res.matches, w)
    cached = service.GeneSearchService(rambo_built, dataclasses.replace(
        conf, kmer_cache=KmerCacheConfig(1 << 12)))
    before = obs_metrics.DEFAULT.snapshot()
    cold, warm = cached.search(reads), cached.search(reads)
    merges = _merges(before, obs_metrics.DEFAULT.snapshot())
    assert merges["fused"] == 0 and merges["per_kmer"] >= 1
    _assert_same_results(cold, got, same_ids=False)
    _assert_same_results(warm, got, same_ids=False)


@pytest.mark.parametrize("kind", ["bloom", "cobs", "bitsliced", "rambo"])
def test_uncached_step_is_the_engines_coverage_batch(built, rambo_built,
                                                     monkeypatch, kind):
    """The uncached service's step is the engine's ``coverage_batch``,
    once a batch, for every engine; its answers are each read's own
    unpadded ``msmt`` (ragged reads over several buckets, θ 0.8), and the
    serving module keeps no verdict rule of its own."""
    cfg, archive, _, teng = built
    if kind == "bitsliced":
        eng = teng
    elif kind == "rambo":
        eng = rambo_built
    else:
        if kind == "bloom":         # one set: the first eight files
            eng, files = engines.PackedBloomIndex.build(
                cfg.idl_config(), cfg.scheme, device="cpu"), archive[:8]
        else:
            eng, files = engines.CobsIndex.build(
                [len(f.genome) - cfg.k + 1 for f in archive],
                cfg.idl_config(), cfg.scheme, device="cpu"), archive
        eng = ingest.build_archive(eng, files, read_len=cfg.read_len,
                                   chunk_reads=16)
    calls = []
    real = type(eng).coverage_batch

    def counted(self, *a, **kw):
        calls.append(kw.get("need") is not None)
        return real(self, *a, **kw)

    monkeypatch.setattr(type(eng), "coverage_batch", counted)
    svc = service.GeneSearchService(
        eng, service.ServiceConfig(theta=0.8, max_batch=4))
    reads = _queries(archive, np.random.default_rng(12), n=12)
    got = svc.search(reads)
    monkeypatch.undo()
    assert calls == [True] * len(svc.batch_stats)
    assert len({b.bucket for b in svc.batch_stats}) > 1
    want = [eng.msmt(r[None], 0.8).numpy()[0] for r in reads]
    assert any(np.any(w) for w in want) and not all(np.all(w) for w in want)
    for res, w in zip(got, want):
        np.testing.assert_array_equal(res.matches, w)
        assert res.matches.shape == w.shape == (     # bloom: one file
            1 if kind == "bloom" else eng.n_files,)
        assert res.file_ids == tuple(np.flatnonzero(w).tolist())
    assert not hasattr(service, "_msmt_reduce")


def _run(module, args, pythonpath):
    env = dict(os.environ, PYTHONPATH=pythonpath, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "-m", module] + args,
                          capture_output=True, text=True, timeout=300,
                          env=env, cwd=REPO)


def test_launcher_recall_matches_reference():
    args = ["--files", "32", "--batch", "4", "--requests", "2"]
    port = _run("repro_torch.launch.serve", args + ["--device", "cpu"], SRC)
    ref = _run("repro.launch.serve", args, SRC)
    assert port.returncode == 0, port.stderr[-1500:]
    assert ref.returncode == 0, ref.stderr[-1500:]
    recall = re.search(r"recall \d+/\d+", port.stdout).group(0)
    assert recall == re.search(r"recall \d+/\d+", ref.stdout).group(0)
    assert recall == "recall 8/8"


@pytest.mark.parametrize("flags,line", [
    (["--files", "32", "--procs", "2"], "fabric: 2 worker processes"),
    pytest.param(["--files", "64", "--shards", "2"],
                 "2 shards over the 'files' axis", marks=pytest.mark.slow),
], ids=["procs", "shards"])
def test_launcher_fleet_recall_matches_reference(flags, line, tmp_path):
    """``--procs 2`` (a two-worker fabric) and ``--shards 2`` (a scatter
    router over two file shards) print the reference launcher's recall;
    ``--obs-dump`` writes the merged snapshot and its Chrome trace."""
    args = flags + ["--batch", "4", "--requests", "2"]
    dump = str(tmp_path / "obs.json")
    port = _run("repro_torch.launch.serve",
                args + ["--device", "cpu", "--obs-dump", dump], SRC)
    ref = _run("repro.launch.serve", args, SRC)
    assert port.returncode == 0, port.stderr[-1500:]
    assert ref.returncode == 0, ref.stderr[-1500:]
    assert line in port.stdout and line in ref.stdout
    recall = re.search(r"recall \d+/\d+", port.stdout).group(0)
    assert recall == re.search(r"recall \d+/\d+", ref.stdout).group(0)
    assert recall == "recall 8/8"
    assert "obs: " in port.stdout and os.path.exists(dump)
    assert os.path.getsize(dump) > 0


def test_port_imports_neither_jax_nor_reference():
    mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                  "repro_torch.")]
    examples = sorted(
        os.path.join(REPO, "examples", f)
        for f in os.listdir(os.path.join(REPO, "examples"))
        if f.startswith("torch_") and f.endswith(".py"))
    assert len(examples) == 4, examples
    assert {"repro_torch.models.transformer", "repro_torch.core.theory",
            "repro_torch.core.cache_model", "repro_torch.configs.lm_common",
            "repro_torch.models.convert", "repro_torch.train.optimizer",
            "repro_torch.train.train_state", "repro_torch.train.checkpoint",
            "repro_torch.train.loop", "repro_torch.data.lm_pipeline",
            "repro_torch.distributed.fault_tolerance",
            "repro_torch.launch.train"} <= set(mods)
    code = ("import sys, importlib, importlib.util\n"
            f"for m in {mods!r} + ['chip_smoke']:\n"
            "    importlib.import_module(m)\n"
            f"for i, path in enumerate({examples!r}):\n"
            "    spec = importlib.util.spec_from_file_location(f'ex{i}', path)\n"
            "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
            "assert not bad, bad\n"
            "print('clean', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, env=env, cwd=REPO)
    assert p.returncode == 0, p.stderr[-1500:]
    assert "clean" in p.stdout
    pattern = re.compile(r"^\s*(import jax|from jax|import repro\b(?!_torch)"
                         r"|from repro\b(?!_torch))", re.M)
    sources = [os.path.join(REPO, "chip_smoke.py")] + examples + [
        os.path.join(root, f)
        for root, _, files in os.walk(os.path.join(SRC, "repro_torch"))
        for f in files if f.endswith(".py")]
    for path in sources:
        assert not pattern.search(open(path).read()), path


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py would run")
    p = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                       capture_output=True, text=True, timeout=120, cwd=REPO)
    assert p.returncode != 0
    assert "no CUDA device" in p.stderr and '"ok"' not in p.stdout
    alone = tmp_path / "chip_smoke.py"
    alone.write_text(open(os.path.join(REPO, "chip_smoke.py")).read())
    p = subprocess.run([sys.executable, str(alone)], capture_output=True,
                       text=True, timeout=120, cwd=tmp_path)
    assert p.returncode != 0 and '"ok"' not in p.stdout
