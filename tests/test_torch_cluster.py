"""PyTorch port vs the JAX reference: the serving cluster (the async
scheduler, the replica router, the autoscale policies) and the obs export.

The scheduler and router answer exactly like a direct flush of the
reference's service, with one runner per bucket; hot swap under traffic
drops no future and mis-versions no result; corrupt, future-version and
other-k snapshots are refused while traffic flows; the autoscale policies
decide as the reference's do on the same observations. Every wait on a
future or a thread has its own timeout. The reference's cases are those
of ``tests/test_cluster.py`` and ``TestExport`` of ``tests/test_obs.py``,
at their sizes.
"""

import collections
import json
import os
import threading
import time
from concurrent.futures import Future

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.core import idl as j_idl  # noqa: E402
from repro.index import engines as j_engines  # noqa: E402
from repro.index import store as j_store  # noqa: E402
from repro.obs import export as j_export  # noqa: E402
from repro.serving import autoscale as j_autoscale  # noqa: E402
from repro.serving import scheduler as j_scheduler  # noqa: E402
from repro.serving import service as j_service  # noqa: E402
from repro_torch.core import idl  # noqa: E402
from repro_torch.index import engines, store  # noqa: E402
from repro_torch.index.store import SnapshotError  # noqa: E402
from repro_torch.obs import export as obs_export  # noqa: E402
from repro_torch.obs import metrics as obs_metrics  # noqa: E402
from repro_torch.obs import trace as obs_trace  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    AdmissionPolicy,
    AsyncScheduler,
    AutoscaleConfig,
    GeneSearchService,
    ReplicaAutoscaler,
    ReplicaRouter,
    RouterConfig,
    SchedulerConfig,
    SearchRequest,
    ServiceConfig,
    autoscale,
    router as router_mod,
    scheduler as scheduler_mod,
)

ENGINES = ["bitsliced", "cobs"]
TIMEOUT = 60


def _cfg(pkg, m: int = 1 << 16):
    return pkg.IDLConfig(k=31, t=16, L=1 << 10, eta=2, m=m)


@pytest.fixture(scope="module")
def reads():
    return np.random.default_rng(0xC0FFEE).integers(
        0, 4, size=(3, 120), dtype=np.uint8)


def _build(name: str, reads, scheme: str = "idl", port: bool = True):
    e, kw = (engines, {"device": "cpu"}) if port else (j_engines, {})
    cfg = _cfg(idl if port else j_idl)
    r = reads if port else jnp.asarray(reads)
    if name == "cobs":
        return e.CobsIndex.build([100, 200, 150], cfg, scheme=scheme,
                                 n_groups=2, **kw).insert_batch(
                                     r, np.arange(3))
    return e.BitSlicedIndex.build(cfg, scheme, n_files=40, **kw
                                  ).insert_batch(r, np.asarray([0, 9, 39]))


def _poisson_stream(reads, n_requests: int, seed: int):
    """Ragged Poisson stream: mixed-length reads + exponential gaps (s)."""
    rng = np.random.default_rng(seed)
    lens = rng.choice([44, 61, 77, 99, 100, 120], size=n_requests)
    gaps = rng.exponential(5e-4, size=n_requests)
    return [reads[i % 3][:n] for i, n in enumerate(lens)], gaps


def _submit_paced(target, queries, gaps):
    futures = []
    for q, gap in zip(queries, gaps):
        futures.append(target.submit(q))
        time.sleep(gap)
    return futures


def _results(futures) -> list:
    return [f.result(timeout=TIMEOUT) for f in futures]


def _search(target, reads) -> list:
    return _results([target.submit(r) for r in reads])


def _ref_rows(jeng, queries) -> list:
    return [np.asarray(jeng.msmt(jnp.asarray(q)[None]))[0] for q in queries]


class TestClusterParity:
    """The acceptance matrix: scheduler and router == a direct flush of the
    reference's service, one runner per bucket."""

    @pytest.mark.parametrize("theta", [1.0, 0.6])
    @pytest.mark.parametrize("scheme", ["idl", "rh"])
    @pytest.mark.parametrize("engine", ENGINES)
    def test_equal_to_reference_direct_flush(self, reads, engine, scheme,
                                             theta):
        teng = _build(engine, reads, scheme)
        queries, gaps = _poisson_stream(reads, 24, seed=11)
        ref = j_service.GeneSearchService(
            _build(engine, reads, scheme, port=False),
            j_service.ServiceConfig(theta=theta, max_batch=4)
        ).search(queries)
        svc_cfg = ServiceConfig(theta=theta, max_batch=4)
        direct = GeneSearchService(teng, svc_cfg).search(queries)
        for r, want in zip(direct, ref):
            np.testing.assert_array_equal(r.matches, np.asarray(want.matches))
            assert r.file_ids == want.file_ids

        with AsyncScheduler(GeneSearchService(teng, svc_cfg),
                            SchedulerConfig(max_delay_ms=1.0)) as sched:
            got = _results(_submit_paced(sched, queries, gaps))
            for r, want in zip(got, ref):
                np.testing.assert_array_equal(r.matches,
                                              np.asarray(want.matches))
                assert r.file_ids == want.file_ids
            assert all(c == 1 for c in sched.compile_counts().values())

        with ReplicaRouter(teng, svc_cfg,
                           RouterConfig(n_replicas=2)) as rt:
            got = _results(_submit_paced(rt, queries, gaps))
            for r, want in zip(got, ref):
                np.testing.assert_array_equal(r.matches,
                                              np.asarray(want.matches))
                assert r.file_ids == want.file_ids
            for counts in rt.compile_counts().values():
                assert all(c == 1 for c in counts.values())


class TestSchedulerEventLoop:
    def test_deadline_flush_without_drain(self, reads):
        eng = _build("bitsliced", reads)
        with AsyncScheduler(GeneSearchService(eng, ServiceConfig(max_batch=8)),
                            SchedulerConfig(max_delay_ms=5.0)) as sched:
            res = sched.submit(reads[0]).result(timeout=TIMEOUT)
            np.testing.assert_array_equal(
                res.matches, _ref_rows(_build("bitsliced", reads,
                                              port=False), [reads[0]])[0])
            assert sched.stats[-1].flush_reason == scheduler_mod.FLUSH_DEADLINE
            assert sched.outstanding == 0

    def test_full_flush_reason_and_queue_ms(self, reads):
        eng = _build("bitsliced", reads)
        with AsyncScheduler(GeneSearchService(eng, ServiceConfig(max_batch=2)),
                            SchedulerConfig(max_delay_ms=500.0)) as sched:
            _results([sched.submit(reads[0]), sched.submit(reads[1])])
            last = sched.stats[-1]
            assert last.flush_reason == scheduler_mod.FLUSH_FULL
            assert last.n_requests == 2 and last.queue_ms >= 0.0
            assert 0.0 < last.occupancy <= 1.0

    def test_stats_ring_buffer_is_bounded(self, reads):
        eng = _build("bitsliced", reads)
        with AsyncScheduler(GeneSearchService(eng, ServiceConfig(max_batch=1)),
                            SchedulerConfig(stats_window=3)) as sched:
            _search(sched, [reads[0]] * 7)
            assert len(sched.stats) == 3
            assert sched.service.batch_stats.maxlen is not None

    def test_submit_after_close_raises(self, reads):
        sched = AsyncScheduler(GeneSearchService(_build("bitsliced", reads)))
        sched.close()
        with pytest.raises(RuntimeError, match="closed"):
            sched.submit(reads[0])
        sched.close()

    def test_invalid_read_fails_fast_not_in_future(self, reads):
        with AsyncScheduler(
                GeneSearchService(_build("bitsliced", reads))) as sched:
            with pytest.raises(ValueError, match="no 31-mers"):
                sched.submit(np.zeros(5, dtype=np.uint8))
            with pytest.raises(ValueError, match="one 1-D read"):
                sched.submit(reads)

    def test_duplicate_inflight_request_id_rejected(self, reads):
        eng = _build("bitsliced", reads)
        with AsyncScheduler(GeneSearchService(eng, ServiceConfig(max_batch=8)),
                            SchedulerConfig(max_delay_ms=200.0)) as sched:
            fut = sched.submit(SearchRequest(read=reads[0], request_id=7))
            with pytest.raises(ValueError, match="in flight"):
                sched.submit(SearchRequest(read=reads[1], request_id=7))
            assert fut.result(timeout=TIMEOUT).request_id == 7
            assert sched.submit(SearchRequest(read=reads[1], request_id=7)
                                ).result(timeout=TIMEOUT).request_id == 7

    def test_overdue_bucket_beats_full_bucket(self, reads):
        eng = _build("bitsliced", reads)
        sched = AsyncScheduler(
            GeneSearchService(eng, ServiceConfig(max_batch=2)),
            SchedulerConfig(max_delay_ms=5.0))
        sched.pause()
        try:
            now = time.monotonic()
            stale = scheduler_mod._Pending(request=None, n_kmers=1,
                                           future=Future(), t_enq=now - 1.0)
            fresh = [scheduler_mod._Pending(request=None, n_kmers=1,
                                            future=Future(), t_enq=now)
                     for _ in range(2)]
            with sched._lock:
                sched._queues = {128: collections.deque(fresh),
                                 32: collections.deque([stale])}
                sched._paused = False
                pick = sched._pick(time.monotonic())
                sched._paused = True
                sched._queues = {}
            assert pick == (32, "deadline")
        finally:
            sched.resume()
            sched.close()


class _Failing(GeneSearchService):
    """A service whose dispatch or decode raises on chosen batches."""

    def __init__(self, *a, fail_execute=0, fail_finalize=0, **kw):
        super().__init__(*a, **kw)
        self.fail_execute, self.fail_finalize = fail_execute, fail_finalize

    def _execute(self, *a):
        if self.fail_execute:
            self.fail_execute -= 1
            raise RuntimeError("device dispatch failed")
        return super()._execute(*a)

    def _finalize(self, *a):
        if self.fail_finalize:
            self.fail_finalize -= 1
            raise RuntimeError("decode failed")
        return super()._finalize(*a)


class TestFailuresReachFutures:
    """An exception on the flusher or the completer fails the futures of
    its batch (never logged and dropped); later batches still serve."""

    @pytest.mark.parametrize("where,message", [
        ("fail_execute", "device dispatch failed"),
        ("fail_finalize", "decode failed")])
    def test_thread_failure_fails_its_batch(self, reads, where, message):
        svc = _Failing(_build("bitsliced", reads), ServiceConfig(max_batch=2),
                       **{where: 1})
        with AsyncScheduler(svc, SchedulerConfig(max_delay_ms=500.0)) as s:
            bad = [s.submit(reads[0]), s.submit(reads[1])]
            for f in bad:
                with pytest.raises(RuntimeError, match=message):
                    f.result(timeout=TIMEOUT)
            good = _search(s, [reads[2], reads[0]])
            assert good[0].file_ids == (39,) and good[1].file_ids == (0,)
            assert s.outstanding == 0

    def test_completer_bookkeeping_failure_fails_its_batch(self, reads):
        calls = []

        def on_batch(stats, now):
            calls.append(stats)
            if len(calls) == 1:
                raise RuntimeError("telemetry hook failed")

        svc = GeneSearchService(_build("bitsliced", reads),
                                ServiceConfig(max_batch=2))
        with AsyncScheduler(svc, SchedulerConfig(max_delay_ms=500.0),
                            on_batch=on_batch) as s:
            bad = [s.submit(reads[0]), s.submit(reads[1])]
            for f in bad:
                with pytest.raises(RuntimeError, match="telemetry hook"):
                    f.result(timeout=TIMEOUT)
            assert _search(s, [reads[2], reads[2]])[0].file_ids == (39,)


class TestRouterPolicies:
    def test_round_robin_spreads_over_replicas(self, reads):
        with ReplicaRouter(_build("bitsliced", reads),
                           ServiceConfig(max_batch=2),
                           RouterConfig(n_replicas=2, policy="round_robin")
                           ) as rt:
            _search(rt, [reads[i % 3] for i in range(8)])
            assert {s.replica for s in rt.cluster_stats()} == {0, 1}

    def test_bucket_affinity_pins_buckets(self, reads):
        with ReplicaRouter(_build("bitsliced", reads),
                           ServiceConfig(max_batch=2),
                           RouterConfig(n_replicas=2,
                                        policy="bucket_affinity")) as rt:
            qs = [reads[i % 3][:n]
                  for i, n in enumerate([120, 44, 120, 44, 99, 120, 44, 99])]
            _search(rt, qs)
            by_bucket = {}
            for s in rt.cluster_stats():
                by_bucket.setdefault(s.bucket, set()).add(s.replica)
            assert all(len(reps) == 1 for reps in by_bucket.values())
            assert len(by_bucket) >= 2

    def test_least_outstanding_balances(self, reads):
        with ReplicaRouter(_build("bitsliced", reads),
                           ServiceConfig(max_batch=4),
                           RouterConfig(n_replicas=2,
                                        policy="least_outstanding")) as rt:
            res = _search(rt, [reads[i % 3] for i in range(16)])
            assert len(res) == 16
            assert rt.requests_served() == 16
            assert 0.0 < rt.occupancy() <= 1.0

    def test_bad_policy_rejected(self):
        with pytest.raises(ValueError, match="routing policy"):
            RouterConfig(policy="random")
        with pytest.raises(ValueError, match="n_replicas"):
            RouterConfig(n_replicas=0)

    def test_replicas_share_one_state_per_device(self, reads):
        """Replicas on the index's own device share its tensors (one copy,
        not K); a replica on another device gets a copy."""
        eng = _build("bitsliced", reads)
        with ReplicaRouter(eng, ServiceConfig(max_batch=2),
                           RouterConfig(n_replicas=3)) as rt:
            states = [r.service.state for r in rt._replicas]
            assert all(s.words[0] is eng.words for s in states)
            assert rt.device_of(2) == torch.device("cpu")
        with ReplicaRouter(eng, ServiceConfig(max_batch=2),
                           RouterConfig(n_replicas=2),
                           devices=["cpu", torch.device("cpu")]) as rt:
            assert rt._replicas[1].service.state.words[0] is eng.words
        st = eng.state
        assert router_mod.state_on_device(st, "cpu") is st
        moved = router_mod.state_on_device(st, "meta")
        assert moved is not st and moved.words[0].device.type == "meta"
        assert moved.meta == st.meta


def test_concurrent_submitters_stress(reads):
    """More submitter threads than cores against a 3-replica router with a
    short switch interval: every future resolves to its read's answer and
    the counters lose no update."""
    import sys

    eng = _build("bitsliced", reads)
    want = {i: r.matches for i, r in enumerate(
        GeneSearchService(eng, ServiceConfig(max_batch=4)).search(
            [reads[i] for i in range(3)]))}
    n_threads = 2 * (os.cpu_count() or 4)
    per_thread = max(2, 192 // n_threads)     # ~192 requests in all
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ReplicaRouter(eng, ServiceConfig(max_batch=4),
                           RouterConfig(n_replicas=3)) as rt:
            out = [[] for _ in range(n_threads)]

            def submitter(t):
                for i in range(per_thread):
                    out[t].append(((t + i) % 3, rt.submit(reads[(t + i) % 3])))

            threads = [threading.Thread(target=submitter, args=(t,))
                       for t in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=TIMEOUT)
            assert not any(t.is_alive() for t in threads)
            for pairs in out:
                for qi, fut in pairs:
                    np.testing.assert_array_equal(
                        fut.result(timeout=TIMEOUT).matches, want[qi])
            assert rt.requests_served() == n_threads * per_thread
            assert rt.outstanding() == 0
    finally:
        sys.setswitchinterval(interval)


class TestHotSwap:
    @pytest.fixture()
    def snapshots(self, tmp_path, reads):
        """Snapshots written by the reference: v0, and v1 that also holds
        ``new_read`` in file 5."""
        jeng = _build("bitsliced", reads, port=False)
        snap0 = j_store.save(jeng, str(tmp_path / "v0"))
        new_read = np.random.default_rng(17).integers(0, 4, size=120,
                                                      dtype=np.uint8)
        jeng1 = j_store.load_engine(snap0).insert_batch(
            jnp.asarray(new_read)[None], np.asarray([5]))
        snap1 = j_store.save(jeng1, str(tmp_path / "v1"))
        return snap0, snap1, new_read

    def test_swap_under_live_traffic(self, snapshots, reads):
        snap0, snap1, new_read = snapshots
        queries = [reads[i] for i in range(3)] + [new_read]
        want = {v: _ref_rows(j_store.load_engine(s), queries)
                for v, s in ((0, snap0), (1, snap1))}
        rt = ReplicaRouter.from_snapshot(
            snap0, ServiceConfig(max_batch=4), RouterConfig(n_replicas=2),
            device="cpu")
        futures, stop = [], threading.Event()

        def submitter():
            i = 0
            while not stop.is_set():
                futures.append((i % 4, rt.submit(queries[i % 4])))
                i += 1
                time.sleep(0.001)

        with rt:
            t = threading.Thread(target=submitter)
            t.start()
            try:
                time.sleep(0.05)
                assert rt.swap_snapshot(snap1, device="cpu") == 1
                time.sleep(0.05)
            finally:
                stop.set()
                t.join(timeout=TIMEOUT)
            assert not t.is_alive() and len(futures) > 20
            seen = set()
            for qi, fut in futures:
                res = fut.result(timeout=TIMEOUT)     # zero dropped futures
                seen.add(res.version)
                np.testing.assert_array_equal(res.matches,
                                              want[res.version][qi])
            assert seen == {0, 1}
            res = rt.submit(new_read).result(timeout=TIMEOUT)
            assert res.version == 1 and 5 in res.file_ids
            for counts in rt.compile_counts().values():
                assert all(c == 1 for c in counts.values())
            # versions rise monotonically on each replica
            for rid in (0, 1):
                vs = [s.version for s in rt.cluster_stats()
                      if s.replica == rid]
                assert vs == sorted(vs)

    def test_corrupt_snapshot_rejected_traffic_flows(self, snapshots,
                                                     reads, tmp_path):
        snap0, snap1, _ = snapshots
        bad = str(tmp_path / "bad")
        os.makedirs(bad)
        with open(os.path.join(bad, "manifest.json"), "w") as f:
            f.write("{not json")
        with ReplicaRouter.from_snapshot(
                snap0, ServiceConfig(max_batch=2),
                RouterConfig(n_replicas=2), device="cpu") as rt:
            with pytest.raises(SnapshotError):
                rt.swap_snapshot(bad)
            assert rt.version == 0
            corrupt = str(tmp_path / "corrupt")
            store.save(store.load(snap1, device="cpu"), corrupt)
            words = os.path.join(corrupt, "words_0.npy")
            with open(words, "rb") as fh:
                raw = bytearray(fh.read())
            raw[-1] ^= 0xFF
            with open(words, "wb") as fh:
                fh.write(bytes(raw))
            with pytest.raises(SnapshotError, match="checksum"):
                rt.swap_snapshot(corrupt)
            assert rt.version == 0
            assert _search(rt, [reads[0]])[0].version == 0

    def test_future_version_snapshot_rejected(self, snapshots, reads,
                                              tmp_path):
        snap0, snap1, _ = snapshots
        futur = str(tmp_path / "future")
        store.save(store.load(snap1, device="cpu"), futur)
        mpath = os.path.join(futur, "manifest.json")
        with open(mpath) as fh:
            manifest = json.load(fh)
        manifest["version"] = store.VERSION + 1
        with open(mpath, "w") as fh:
            json.dump(manifest, fh)
        with ReplicaRouter.from_snapshot(
                snap0, ServiceConfig(max_batch=2),
                RouterConfig(n_replicas=2), device="cpu") as rt:
            with pytest.raises(SnapshotError, match="version"):
                rt.swap_snapshot(futur)
            assert rt.version == 0
            assert _search(rt, [reads[0]])[0].version == 0

    def test_kmer_size_change_rejected(self, snapshots):
        snap0, _, _ = snapshots
        other = engines.BitSlicedIndex.build(
            idl.IDLConfig(k=21, t=12, L=1 << 10, eta=2, m=1 << 16),
            "idl", n_files=8, device="cpu")
        with ReplicaRouter.from_snapshot(snap0, device="cpu") as rt:
            with pytest.raises(ValueError, match="kmer size"):
                rt.swap_state(other)
            assert rt.version == 0


# -- autoscale: the port's policies decide as the reference's ----------------

def _stats(mod, **kw):
    base = dict(replica=0, version=0, bucket=64, n_requests=16,
                batch_rows=16, flush_reason="full", queue_ms=0.5,
                wall_ms=16.0)
    return mod.ClusterStats(**{**base, **kw})


def _ewma_trace(am, sm):
    r = am.EwmaRate(halflife_s=0.5)
    for i in range(2000):
        r.observe(100.0 + i * 1e-3)
    return [r.rate(102.0), r.rate(104.0)]


def _admission_trace(am, sm):
    p = am.AdmissionPolicy(am.AutoscaleConfig())
    out = [p.target_batch(64, now=0.0, max_batch=16),
           p.deadline_ms(64, now=0.0, max_batch=16)]
    for i in range(5000):
        p.observe_arrival(64, i * 1e-4)
    out += [p.target_batch(64, 0.5, max_batch=16),
            p.deadline_ms(64, 0.5, max_batch=16)]
    for i in range(200):
        p.observe_arrival(32, i * 1e-3)
    out.append(p.deadline_ms(32, 0.2, max_batch=16))
    for _ in range(20):
        p.observe_batch(_stats(sm, bucket=32, n_requests=2,
                               flush_reason="deadline", queue_ms=1.0,
                               wall_ms=1.0), 0.2)
    out.append(p.deadline_ms(32, 0.2, max_batch=16))
    for _ in range(30):
        p.observe_batch(_stats(sm, bucket=32, flush_reason="full",
                               queue_ms=1.0, wall_ms=1.0), 0.2)
    out.append(p.deadline_ms(32, 0.2, max_batch=16))
    return out


def _replica_trace(am, sm):
    a = am.ReplicaAutoscaler(am.AutoscaleConfig(
        min_replicas=1, max_replicas=3, cooldown_s=0.0,
        target_utilization=0.5))
    for i in range(4000):
        a.observe_arrival(i * 5e-4)
    a.observe_batch(_stats(sm), 2.0)
    out = [a.recommend(2.0, n, outstanding=0, max_batch=16)
           for n in (1, 2, 3)]
    out += [a.recommend(3602.0, n, outstanding=0, max_batch=16)
            for n in (3, 1)]
    b = am.ReplicaAutoscaler(am.AutoscaleConfig(
        min_replicas=1, max_replicas=4, cooldown_s=10.0))
    b.observe_batch(_stats(sm), 0.0)
    out += [b.recommend(1.0, 1, outstanding=100, max_batch=16),
            b.recommend(2.0, 2, outstanding=200, max_batch=16),
            b.recommend(12.0, 2, outstanding=200, max_batch=16)]
    return out


class TestAutoscalePolicies:
    @pytest.mark.parametrize("trace", [_ewma_trace, _admission_trace,
                                       _replica_trace])
    def test_decisions_match_reference(self, trace):
        assert trace(autoscale, scheduler_mod) == \
            trace(j_autoscale, j_scheduler)

    def test_ewma_rate_tracks_and_decays(self):
        converged, idle = _ewma_trace(autoscale, scheduler_mod)
        assert 700 <= converged <= 1300 and idle < converged * 0.1

    def test_admission_policy_moves_its_knobs(self):
        (idle_target, idle_dl, hot_target, hot_dl, base, shrunk,
         regrown) = _admission_trace(autoscale, scheduler_mod)
        cfg = AutoscaleConfig()
        assert idle_target == 1 and idle_dl == cfg.deadline_ms_min
        assert hot_target == 16
        assert cfg.deadline_ms_min < hot_dl < cfg.deadline_ms_max
        assert shrunk < base and regrown > shrunk
        assert isinstance(AdmissionPolicy(cfg), AdmissionPolicy)

    def test_replica_autoscaler_bounds_cooldown_backlog(self):
        assert _replica_trace(autoscale, scheduler_mod) == \
            [2, 3, 3, 2, 1, 2, 2, 3]
        assert isinstance(ReplicaAutoscaler(AutoscaleConfig()),
                          ReplicaAutoscaler)

    def test_router_scale_to_drains_removed_replicas(self, reads):
        with ReplicaRouter(_build("bitsliced", reads),
                           ServiceConfig(max_batch=2),
                           RouterConfig(n_replicas=1)) as rt:
            assert rt.scale_to(3) == 3
            assert len(_search(rt, [reads[i % 3] for i in range(12)])) == 12
            assert rt.scale_to(1) == 1
            assert len(_search(rt, [reads[0]])) == 1
            with pytest.raises(ValueError, match="below 1"):
                rt.scale_to(0)

    def test_router_autoscale_step_applies_recommendation(self, reads):
        with ReplicaRouter(
                _build("bitsliced", reads), ServiceConfig(max_batch=2),
                RouterConfig(n_replicas=1, autoscale=AutoscaleConfig(
                    min_replicas=1, max_replicas=2, cooldown_s=0.0,
                    target_utilization=0.9))) as rt:
            assert rt.autoscale_step() == 1
            _search(rt, [reads[i % 3] for i in range(8)])
            for _ in range(5000):
                rt.autoscaler.observe_arrival(time.monotonic())
            assert rt.autoscale_step() == 2
            assert len(_search(rt, [reads[0]] * 4)) == 4


# -- the obs export ------------------------------------------------------------

class TestExport:
    def _private(self):
        reg, trc = obs_metrics.Registry(), obs_trace.Tracer()
        reg.counter("c").inc(2)
        span = trc.start("request")
        trc.start("child", trace=span.context()).end()
        span.end()
        return obs_export.snapshot(registry=reg, tracer=trc)

    def test_snapshot_merge_traces_of(self):
        a, b = self._private(), self._private()
        merged = obs_export.merge([a, b, None, {}])
        assert merged == j_export.merge([a, b, None, {}])
        assert merged["metrics"]["counters"]["c"][""] == 4.0
        assert len(merged["spans"]) == 4
        t0s = [r["t0"] for r in merged["spans"]]
        assert t0s == sorted(t0s)
        traces = obs_export.traces_of(merged)
        assert traces == j_export.traces_of(merged)
        assert len(traces) == 2
        for recs in traces.values():
            assert {r["name"] for r in recs} == {"request", "child"}
        assert obs_export.chrome_events(merged) == \
            j_export.chrome_events(merged)

    def test_dump_round_trip(self, tmp_path):
        snap = self._private()
        out = tmp_path / "obs" / "dump.json"
        paths = obs_export.dump(snap, str(out))
        assert paths == [str(out), str(out.with_suffix(".chrome.json"))]
        doc = json.loads(out.read_text())
        assert doc["metrics"]["counters"]["c"][""] == 2.0
        (spans,) = doc["traces"].values()
        assert len(spans) == 2
        chrome = json.loads(out.with_suffix(".chrome.json").read_text())
        assert len(chrome["traceEvents"]) == 2
        assert chrome["displayTimeUnit"] == "ms"
        ref = tmp_path / "ref" / "dump.json"
        j_export.dump(snap, str(ref))
        assert ref.read_text() == out.read_text()

    def test_cache_stats_view_matches_reference(self):
        reg = obs_metrics.Registry()
        for cache, (h, m) in enumerate([(3, 1), (5, 0)]):
            reg.counter("kmer_cache.hits", cache=cache).inc(h)
            reg.counter("kmer_cache.misses", cache=cache).inc(m)
            reg.gauge("kmer_cache.entries", cache=cache).set(4)
        snap = {"metrics": reg.snapshot()}
        view = obs_export.cache_stats_view(snap)
        assert view == j_export.cache_stats_view(snap)
        assert view["hits"] == 8 and view["lookups"] == 9
        assert view["entries"] == 8

    def test_package_switches(self, reads):
        import repro_torch.obs as obs

        svc = GeneSearchService(_build("bitsliced", reads),
                                ServiceConfig(max_batch=4))
        try:
            want = [r.matches for r in svc.search([reads[0], reads[1]])]
            obs.reset()
            obs.set_enabled(False)
            got = [r.matches for r in svc.search([reads[0], reads[1]])]
            for w, g in zip(want, got):
                np.testing.assert_array_equal(w, g)
            snap = obs.snapshot()
            assert snap["spans"] == []
            assert obs.counter_total(snap["metrics"],
                                     "serving.requests") == 0.0
        finally:
            obs.set_enabled(True)
            obs.reset()
