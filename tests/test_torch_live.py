"""PyTorch port vs the JAX reference: the live index (``index/lsm.py``)
and the live serving tier (``serving/live.py``).

Merged base + delta answers equal the reference's single union index,
exactly, across engines × schemes × backends × theta, mid-compaction
included; writes are admitted, ordered and acknowledged as in the
reference; compaction under traffic drops no future; the write-ahead
journal survives a crash and is byte-compatible with the reference's in
both directions. The port writes the delta in place where the reference
donates, so the places that need a copy are pinned here: ``or_states``,
the replay compaction's first insert and ``plan_compaction``. Every wait
on a future or a thread has its own timeout. The reference's cases are
those of ``tests/test_live.py`` (and the live-router span tree of
``tests/test_obs.py``), at their sizes.
"""

import functools
import os
import struct
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.core import idl as j_idl  # noqa: E402
from repro.index import engines as j_engines  # noqa: E402
from repro.index import lsm as j_lsm  # noqa: E402
from repro_torch.core import idl  # noqa: E402
from repro_torch.index import engines, lsm, store  # noqa: E402
from repro_torch.index import state as state_mod  # noqa: E402
from repro_torch.obs import export as obs_export  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    AsyncScheduler,
    Compactor,
    GeneSearchService,
    KmerCacheConfig,
    LiveGeneSearchService,
    LiveReplicaRouter,
    RouterConfig,
    SchedulerConfig,
    ServiceConfig,
    scheduler as scheduler_mod,
)

ENGINES = ["bloom", "cobs", "rambo", "bitsliced"]
TIMEOUT = 60
LENS = [120, 100, 77, 120, 61, 99]

# streaming writes: two batches over reads[3:], per-engine file ids
_WRITES = {
    "bloom": [((3, 5), None), ((5, 6), None)],
    "cobs": [((3, 5), [1, 2]), ((5, 6), [0])],
    "rambo": [((3, 5), [3, 4]), ((5, 6), [1])],
    "bitsliced": [((3, 5), [5, 17]), ((5, 6), [23])],
}

READS = np.random.default_rng(0xC0FFEE).integers(0, 4, size=(6, 120),
                                                 dtype=np.uint8)
QUERIES = [READS[i][:n] for i, n in enumerate(LENS)]


def _cfg(pkg, m: int = 1 << 16):
    return pkg.IDLConfig(k=31, t=16, L=1 << 10, eta=2, m=m)


def _build_base(name: str, scheme: str = "idl", port: bool = True):
    """The base index over reads[:3] (port on the CPU, or reference)."""
    e, kw = (engines, {"device": "cpu"}) if port else (j_engines, {})
    pkg = idl if port else j_idl
    r = READS[:3] if port else jnp.asarray(READS[:3])
    if name == "bloom":
        return e.PackedBloomIndex.build(_cfg(pkg), scheme, **kw
                                        ).insert_batch(r)
    if name == "cobs":
        return e.CobsIndex.build([100, 200, 150], _cfg(pkg), scheme=scheme,
                                 n_groups=2, **kw).insert_batch(
                                     r, np.arange(3))
    if name == "rambo":
        return e.RamboIndex.build(5, _cfg(pkg, 1 << 14), scheme=scheme,
                                  B=2, R=2, **kw).insert_batch(
                                      r, np.arange(3))
    return e.BitSlicedIndex.build(_cfg(pkg), scheme, n_files=40, **kw
                                  ).insert_batch(r, np.asarray([0, 9, 39]))


def _fids(fids):
    return None if fids is None else np.asarray(fids)


@functools.lru_cache(maxsize=None)
def _want(name: str, scheme: str = "idl", theta: float = 1.0,
          n_writes: int = 2) -> tuple:
    """The reference's union index (base + the first ``n_writes`` write
    batches): its ``msmt`` row for each query."""
    eng = _build_base(name, scheme, port=False)
    for (a, b), fids in _WRITES[name][:n_writes]:
        eng = eng.insert_batch(jnp.asarray(READS[a:b]), _fids(fids))
    return tuple(np.asarray(eng.msmt(jnp.asarray(q)[None], theta=theta))[0]
                 for q in QUERIES)


def _assert_rows(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), w)


def _matches(results) -> list:
    return [r.matches for r in results]


def _live_msmt(live, theta=1.0) -> list:
    return [live.msmt(q[None], theta=theta)[0].numpy() for q in QUERIES]


def _live_service(name, scheme="idl", **svc_kw) -> LiveGeneSearchService:
    svc = LiveGeneSearchService(lsm.LiveIndex(_build_base(name, scheme)),
                                ServiceConfig(max_batch=4, **svc_kw))
    for (a, b), fids in _WRITES[name]:
        svc.apply_insert(READS[a:b], fids)
    return svc


def _search(target, reads) -> list:
    futures = [target.submit(r) for r in reads]
    return [f.result(timeout=TIMEOUT) for f in futures]


def _acks(futures) -> list:
    return [f.result(timeout=TIMEOUT) for f in futures]


def _journal_seqs(path) -> list:
    """The sequence numbers a fresh journal handle reads from ``path``."""
    j = lsm.DeltaJournal(path)
    try:
        return [r.seq for r in j.records()]
    finally:
        j.close()


def _read(path) -> bytes:
    with open(path, "rb") as fh:
        return fh.read()


class TestMergedQueryParity:
    @pytest.mark.parametrize("theta", [1.0, 0.6])
    @pytest.mark.parametrize("backend", ["torch", "idl_probe"])
    @pytest.mark.parametrize("scheme", ["idl", "rh"])
    @pytest.mark.parametrize("engine", ENGINES)
    def test_equal_to_reference_union_index(self, engine, scheme, backend,
                                            theta):
        svc = _live_service(engine, scheme, backend=backend, theta=theta)
        res = svc.search(QUERIES)
        _assert_rows(_matches(res), _want(engine, scheme, theta))
        assert {r.delta_seq for r in res} == {len(_WRITES[engine])}
        _assert_rows(_live_msmt(svc.live, theta), _want(engine, scheme,
                                                        theta))

    @pytest.mark.parametrize("engine", ENGINES)
    def test_cached_equal_to_reference_union_index(self, engine):
        svc = _live_service(engine, kmer_cache=KmerCacheConfig(1 << 14))
        for _ in range(2):
            _assert_rows(_matches(svc.search(QUERIES)), _want(engine))
        assert svc.cache_stats()["hits"] > 0

    @pytest.mark.parametrize("scheme", ["idl", "rh"])
    @pytest.mark.parametrize("engine", ENGINES)
    def test_exact_mid_compaction(self, engine, scheme):
        live = lsm.LiveIndex(_build_base(engine, scheme))
        svc = LiveGeneSearchService(live, ServiceConfig(max_batch=4))
        (a, b), fids = _WRITES[engine][0]
        svc.apply_insert(READS[a:b], fids)
        _assert_rows(_matches(svc.search(QUERIES)),
                     _want(engine, scheme, n_writes=1))
        counts0 = svc.compile_counts()
        plan = live.plan_compaction()
        merged = lsm.LiveIndex.compact(plan)         # compactor working...
        (a, b), fids = _WRITES[engine][1]
        svc.apply_insert(READS[a:b], fids)           # ...a write lands
        _assert_rows(_matches(svc.search(QUERIES)), _want(engine, scheme))
        assert svc.publish(merged, plan.upto_seq) == 1
        res = svc.search(QUERIES)
        _assert_rows(_matches(res), _want(engine, scheme))
        assert {(r.version, r.delta_seq) for r in res} == \
            {(1, plan.upto_seq + 1)}
        assert svc.compile_counts() == counts0

    def test_second_compaction_absorbs_late_write(self):
        svc = _live_service("bitsliced")
        svc.compact()
        assert svc.live.delta_batches() == 0
        _assert_rows(_matches(svc.search(QUERIES)), _want("bitsliced"))


class TestDeltaGeometry:
    @pytest.mark.parametrize("engine", ["bloom", "rambo"])
    def test_small_m_delta_is_exact(self, engine):
        live = lsm.LiveIndex(_build_base(engine),
                             delta_cfg=_cfg(idl, 1 << 12))
        jlive = j_lsm.LiveIndex(_build_base(engine, port=False),
                                delta_cfg=_cfg(j_idl, 1 << 12))
        for (a, b), fids in _WRITES[engine]:
            live.insert(READS[a:b], fids)
            jlive.insert(READS[a:b], fids)
        np.testing.assert_array_equal(
            live.delta.words[0].numpy().view(np.uint32),
            np.asarray(jlive.delta.words[0]))
        _assert_rows(_live_msmt(live), _want(engine))
        base = live.base.words[0].clone()
        live.compact_now()                  # the replay path
        assert live.delta_batches() == 0
        assert torch.equal(live.base.words[0] | base, live.base.words[0])
        _assert_rows(_live_msmt(live), _want(engine))
        jlive.compact_now()
        np.testing.assert_array_equal(
            live.base.words[0].numpy().view(np.uint32),
            np.asarray(jlive.base.words[0]))

    @pytest.mark.parametrize("engine", ["cobs", "bitsliced"])
    def test_row_probe_engines_reject_delta_cfg(self, engine):
        with pytest.raises(ValueError, match="row geometry"):
            lsm.LiveIndex(_build_base(engine), delta_cfg=_cfg(idl, 1 << 12))

    def test_delta_kmer_size_must_match(self):
        bad = idl.IDLConfig(k=21, t=16, L=1 << 10, eta=2, m=1 << 12)
        with pytest.raises(ValueError, match="kmer size"):
            lsm.LiveIndex(_build_base("bloom"), delta_cfg=bad)

    def test_publish_rejects_foreign_geometry(self):
        live = lsm.LiveIndex(_build_base("bloom"))
        foreign = lsm.empty_delta(live.base, _cfg(idl, 1 << 12))
        with pytest.raises(ValueError, match="geometry"):
            live.publish(foreign, live.delta_seq)

    @pytest.mark.parametrize("engine", ENGINES)
    def test_empty_delta_matches_reference_shapes(self, engine):
        got = lsm.empty_delta(_build_base(engine).state)
        want = j_lsm.empty_delta(_build_base(engine, port=False).state)
        assert got.meta == _build_base(engine).state.meta
        assert [tuple(w.shape) for w in got.words] == \
            [tuple(w.shape) for w in want.words]
        assert all(not bool(w.any()) for w in got.words)


class TestWriteAdmission:
    def test_static_service_is_not_writable(self):
        with AsyncScheduler(GeneSearchService(_build_base("bitsliced"))) as s:
            with pytest.raises(TypeError, match="not writable"):
                s.submit_insert(READS[3:5], np.asarray([5, 17]))

    def test_ack_watermark_gives_read_your_writes(self):
        with AsyncScheduler(_live_service("bitsliced")) as sched:
            ack = sched.submit_insert(READS[5:6], np.asarray([30])
                                      ).result(timeout=TIMEOUT)
            assert (ack.base_version, ack.delta_seq, ack.n_reads) == \
                (0, 3, 1)
            res = sched.submit(READS[5]).result(timeout=TIMEOUT)
            assert (res.version, res.delta_seq) >= (0, 3)
            assert 30 in res.file_ids

    def test_pause_gates_writes(self):
        sched = AsyncScheduler(_live_service("bitsliced"))
        try:
            sched.pause()
            fut = sched.submit_insert(READS[5:6], np.asarray([30]))
            time.sleep(0.05)
            assert not fut.done()
            sched.resume()
            assert fut.result(timeout=TIMEOUT).delta_seq == 3
        finally:
            sched.close()

    def test_closed_scheduler_rejects_writes(self):
        sched = AsyncScheduler(_live_service("bitsliced"))
        sched.close()
        with pytest.raises(RuntimeError, match="closed"):
            sched.submit_insert(READS[5:6], np.asarray([30]))

    def test_failed_write_reaches_its_future(self):
        """A write the index refuses (a file id out of range) fails its
        own future; the scheduler keeps serving."""
        with AsyncScheduler(_live_service("bitsliced")) as sched:
            bad = sched.submit_insert(READS[5:6], np.asarray([99]))
            with pytest.raises(ValueError, match="file ids"):
                bad.result(timeout=TIMEOUT)
            assert sched.submit_insert(READS[5:6], np.asarray([30])
                                       ).result(timeout=TIMEOUT).n_reads == 1

    def test_redelivered_seq_after_publish_is_noop(self):
        live = lsm.LiveIndex(_build_base("bitsliced"))
        (a, b), fids = _WRITES["bitsliced"][0]
        assert live.insert(READS[a:b], fids, seq=1) == 1
        live.compact_now()
        assert live.insert(READS[a:b], fids, seq=1) == 1
        assert live.delta_seq == 1 and live.delta_batches() == 0
        (a, b), fids = _WRITES["bitsliced"][1]
        assert live.insert(READS[a:b], fids, seq=2) == 2
        assert live.delta_seq == 2

    def test_lagging_replica_stays_aligned_across_compaction(self):
        rt = LiveReplicaRouter(
            _build_base("bitsliced"), ServiceConfig(max_batch=4),
            RouterConfig(n_replicas=2, policy="round_robin"))
        with rt:
            laggard = rt._replicas[1]
            laggard.scheduler.pause()
            futs = []
            for (a, b), fids in _WRITES["bitsliced"]:
                futs.extend(rt.insert(READS[a:b], np.asarray(fids)))
            _acks(futs[0::2])
            assert rt.compact() == 1
            acks = _acks(futs)
            assert [x.delta_seq for x in acks[0::2]] == [1, 2]
            assert [x.delta_seq for x in acks[1::2]] == [1, 2]
            for rep in rt._replicas:
                assert rep.service.live.delta_seq == rt.wal_seq == 2
            res = _search(rt, QUERIES * 2)
            _assert_rows(_matches(res), _want("bitsliced") * 2)
            assert {r.delta_seq for r in res} == {2}

    def test_sustained_writes_do_not_starve_queries(self):
        svc = _live_service("bitsliced")
        n_writes = 4 * scheduler_mod._WRITE_BURST
        sched = AsyncScheduler(svc, SchedulerConfig(max_delay_ms=0.0))
        try:
            sched.pause()
            write_done, wfuts = [], []
            for _ in range(n_writes):
                f = sched.submit_insert(READS[5:6], np.asarray([30]))
                f.add_done_callback(lambda _: write_done.append(1))
                wfuts.append(f)
            at_query = []
            qfut = sched.submit(READS[0])
            qfut.add_done_callback(lambda _: at_query.append(len(write_done)))
            sched.resume()
            qfut.result(timeout=TIMEOUT)
            _acks(wfuts)
            assert at_query[0] < n_writes
        finally:
            sched.close()

    def test_router_fans_writes_to_every_replica(self):
        rt = LiveReplicaRouter(
            _build_base("bitsliced"), ServiceConfig(max_batch=4),
            RouterConfig(n_replicas=2, policy="round_robin"))
        with rt:
            for (a, b), fids in _WRITES["bitsliced"]:
                acks = _acks(rt.insert(READS[a:b], np.asarray(fids)))
                assert len(acks) == 2 and len({x.delta_seq for x in acks}) == 1
            _assert_rows(_matches(_search(rt, QUERIES * 2)),
                         _want("bitsliced") * 2)
            # one shared base, a delta of its own on each replica
            lives = [rep.service.live for rep in rt._replicas]
            assert lives[0].base is lives[1].base
            assert lives[0].delta.words[0] is not lives[1].delta.words[0]

    def test_scaled_out_replica_replays_the_tail(self):
        rt = LiveReplicaRouter(
            _build_base("bitsliced"), ServiceConfig(max_batch=4),
            RouterConfig(n_replicas=1, policy="round_robin"))
        with rt:
            for (a, b), fids in _WRITES["bitsliced"]:
                _acks(rt.insert(READS[a:b], np.asarray(fids)))
            rt.scale_to(2)
            _assert_rows(_matches(_search(rt, QUERIES * 2)),
                         _want("bitsliced") * 2)

    def test_live_swap_state_is_closed_off(self):
        rt = LiveReplicaRouter(_build_base("bitsliced"),
                               ServiceConfig(max_batch=4),
                               RouterConfig(n_replicas=1))
        with rt:
            with pytest.raises(NotImplementedError, match="compact"):
                rt.swap_state(_build_base("bitsliced"))
            with pytest.raises(NotImplementedError, match="compaction"):
                rt._replicas[0].service.swap_state(_build_base("bitsliced"))


class TestCompactionUnderTraffic:
    def test_zero_drop_zero_rebuild(self):
        rt = LiveReplicaRouter(
            _build_base("bitsliced"), ServiceConfig(max_batch=4),
            RouterConfig(n_replicas=2, policy="round_robin",
                         scheduler=SchedulerConfig(max_delay_ms=0.5)))
        futures, stop = [], threading.Event()

        def submitter():
            i = 0
            while not stop.is_set():
                futures.append((i % 6, rt.submit(QUERIES[i % 6])))
                i += 1
                time.sleep(0.0005)

        with rt:
            _search(rt, QUERIES)
            thread = threading.Thread(target=submitter)
            thread.start()
            try:
                time.sleep(0.02)
                _acks(rt.insert(READS[3:5], np.asarray([5, 17])))
                assert rt.compact() == 1
                time.sleep(0.02)
                _acks(rt.insert(READS[5:6], np.asarray([23])))
                assert rt.compact() == 2
                time.sleep(0.02)
            finally:
                stop.set()
                thread.join(timeout=TIMEOUT)
            assert not thread.is_alive()
            results = [(src, f.result(timeout=TIMEOUT))
                       for src, f in futures]
            base_fid = {0: 0, 1: 9, 2: 39}
            write_fid = {3: 5, 4: 17, 5: 23}
            write_seq = {3: 1, 4: 2, 5: 2}
            for src, res in results:
                if src in base_fid:
                    assert base_fid[src] in res.file_ids
                elif res.version >= write_seq[src] \
                        or res.delta_seq >= write_seq[src]:
                    assert write_fid[src] in res.file_ids, (src, res)
            assert {res.version for _, res in results} <= {0, 1, 2}
            counts = rt.compile_counts()
            assert all(c == 1 for per in counts.values()
                       for c in per.values())
            # both compactions published one merged base to both replicas
            lives = [rep.service.live for rep in rt._replicas]
            assert lives[0].base is lives[1].base
            assert lives[0].base_version == 2

    def test_compactor_folds_in_the_background(self):
        rt = LiveReplicaRouter(
            _build_base("bitsliced"), ServiceConfig(max_batch=4),
            RouterConfig(n_replicas=2, policy="round_robin"))
        with rt:
            for (a, b), fids in _WRITES["bitsliced"]:
                _acks(rt.insert(READS[a:b], np.asarray(fids)))
            comp = Compactor(rt, interval_s=0.01, min_delta_batches=2)
            deadline = time.monotonic() + TIMEOUT
            while comp.compactions == 0 and time.monotonic() < deadline:
                _assert_rows(_matches(_search(rt, QUERIES)),
                             _want("bitsliced"))
            assert comp.close() == 1
            assert rt.delta_batches() == 0 and rt.version == 1
            _assert_rows(_matches(_search(rt, QUERIES * 2)),
                         _want("bitsliced") * 2)

    def test_compactor_surfaces_its_error(self):
        class Broken:
            def delta_batches(self):
                return 5

            def compact(self):
                raise RuntimeError("merge failed")

        comp = Compactor(Broken(), interval_s=0.01, min_delta_batches=1)
        deadline = time.monotonic() + TIMEOUT
        while comp.error is None and time.monotonic() < deadline:
            time.sleep(0.01)
        with pytest.raises(RuntimeError, match="merge failed"):
            comp.close()
        with pytest.raises(ValueError):
            Compactor(Broken(), interval_s=0)


class TestCrashRecovery:
    @pytest.mark.parametrize("scheme", ["idl", "rh"])
    @pytest.mark.parametrize("engine", ENGINES)
    def test_reboot_matches_no_crash_run(self, tmp_path, engine, scheme):
        snap = store.save(_build_base(engine, scheme), str(tmp_path / "snap"))
        wal = str(tmp_path / "delta.wal")
        live = lsm.LiveIndex.open(snap, journal_path=wal, device="cpu")
        for (a, b), fids in _WRITES[engine]:
            live.insert(READS[a:b], fids)
        plan = live.plan_compaction()
        merged = lsm.LiveIndex.compact(plan)
        del merged                        # crash: merge lost, WAL untouched
        live.close()
        reboot = lsm.LiveIndex.open(snap, journal_path=wal, device="cpu")
        assert reboot.delta_seq == len(_WRITES[engine])
        for theta in (1.0, 0.6):
            _assert_rows(_live_msmt(reboot, theta),
                         _want(engine, scheme, theta))
        reboot.compact_now()
        _assert_rows(_live_msmt(reboot), _want(engine, scheme))
        reboot.close()

    def test_torn_tail_record_is_dropped(self, tmp_path):
        snap = store.save(_build_base("bitsliced"), str(tmp_path / "snap"))
        wal = str(tmp_path / "delta.wal")
        live = lsm.LiveIndex.open(snap, journal_path=wal, device="cpu")
        (a, b), fids = _WRITES["bitsliced"][0]
        live.insert(READS[a:b], fids)
        live.close()
        with open(wal, "ab") as fh:
            fh.write(b"\x07half-a-record-then-power-loss")
        reboot = lsm.LiveIndex.open(snap, journal_path=wal, device="cpu")
        assert reboot.delta_seq == 1
        _assert_rows(_live_msmt(reboot), _want("bitsliced", n_writes=1))
        (a, b), fids = _WRITES["bitsliced"][1]
        assert reboot.insert(READS[a:b], fids) == 2
        reboot.close()

    def test_unsaved_compaction_keeps_acked_writes_durable(self, tmp_path):
        snap = store.save(_build_base("bitsliced"), str(tmp_path / "snap"))
        wal = str(tmp_path / "delta.wal")
        live = lsm.LiveIndex.open(snap, journal_path=wal, device="cpu")
        for (a, b), fids in _WRITES["bitsliced"]:
            live.insert(READS[a:b], fids)
        live.compact_now()
        assert live.delta_batches() == 0
        live.close()
        reboot = lsm.LiveIndex.open(snap, journal_path=wal, device="cpu")
        assert reboot.delta_seq == 2
        _assert_rows(_live_msmt(reboot), _want("bitsliced"))
        reboot.close()

    def test_saved_compaction_truncates_journal(self, tmp_path):
        snap = store.save(_build_base("bitsliced"), str(tmp_path / "snap"))
        wal = str(tmp_path / "delta.wal")
        live = lsm.LiveIndex.open(snap, journal_path=wal, device="cpu")
        for (a, b), fids in _WRITES["bitsliced"]:
            live.insert(READS[a:b], fids)
        snap2 = str(tmp_path / "snap2")
        live.compact_now(save_dir=snap2)
        live.close()
        assert _journal_seqs(wal) == []
        # the reference boots the port's saved base and truncated journal
        jreboot = j_lsm.LiveIndex.open(snap2, journal_path=wal)
        _assert_rows([np.asarray(jreboot.msmt(jnp.asarray(q)[None]))[0]
                      for q in QUERIES], _want("bitsliced"))
        jreboot.close()
        reboot = lsm.LiveIndex.open(snap2, journal_path=wal, device="cpu")
        _assert_rows(_live_msmt(reboot), _want("bitsliced"))
        reboot.close()

    def test_save_base_reclaims_journal(self, tmp_path):
        snap = store.save(_build_base("bitsliced"), str(tmp_path / "snap"))
        wal = str(tmp_path / "delta.wal")
        live = lsm.LiveIndex.open(snap, journal_path=wal, device="cpu")
        (a, b), fids = _WRITES["bitsliced"][0]
        live.insert(READS[a:b], fids)
        live.compact_now()
        assert _journal_seqs(wal) == [1]
        (a, b), fids = _WRITES["bitsliced"][1]
        live.insert(READS[a:b], fids)
        live.save_base(str(tmp_path / "snap2"))
        assert _journal_seqs(wal) == [2]
        live.close()

    def test_service_level_reboot(self, tmp_path):
        snap = store.save(_build_base("bitsliced"), str(tmp_path / "snap"))
        wal = str(tmp_path / "delta.wal")
        svc = LiveGeneSearchService.open(snap, ServiceConfig(max_batch=4),
                                         journal_path=wal, device="cpu")
        for (a, b), fids in _WRITES["bitsliced"]:
            svc.apply_insert(READS[a:b], fids)
        svc.live.close()
        svc2 = LiveGeneSearchService.open(snap, ServiceConfig(max_batch=4),
                                          journal_path=wal, device="cpu")
        _assert_rows(_matches(svc2.search(QUERIES)), _want("bitsliced"))
        svc2.live.close()

    def test_router_journal_boots_every_replica(self, tmp_path):
        wal = str(tmp_path / "fleet.wal")
        rt = LiveReplicaRouter(_build_base("bitsliced"),
                               ServiceConfig(max_batch=4),
                               RouterConfig(n_replicas=2), journal_path=wal)
        with rt:
            for (a, b), fids in _WRITES["bitsliced"]:
                _acks(rt.insert(READS[a:b], np.asarray(fids)))
        rt2 = LiveReplicaRouter(_build_base("bitsliced"),
                                ServiceConfig(max_batch=4),
                                RouterConfig(n_replicas=2,
                                             policy="round_robin"),
                                journal_path=wal)
        with rt2:
            assert rt2.wal_seq == 2
            _assert_rows(_matches(_search(rt2, QUERIES * 2)),
                         _want("bitsliced") * 2)


# -- the journal, and its bytes against the reference's ----------------------

def _records():
    return [(1, READS[0:2], np.asarray([3, 4])), (2, READS[2:3], None),
            (3, READS[3:6], np.asarray([0, 7, 39]))]


class TestDeltaJournal:
    def test_round_trip(self, tmp_path):
        path = str(tmp_path / "j.wal")
        j = lsm.DeltaJournal(path)
        for seq, r, f in _records()[:2]:
            j.append(seq, r, f)
        j.close()
        j = lsm.DeltaJournal(path)
        back = j.records()
        j.close()
        assert [r.seq for r in back] == [1, 2]
        np.testing.assert_array_equal(back[0].reads, READS[0:2])
        np.testing.assert_array_equal(back[0].file_ids, [3, 4])
        assert back[1].file_ids is None

    def test_truncate_through_keeps_late_records(self, tmp_path):
        path = str(tmp_path / "j.wal")
        j = lsm.DeltaJournal(path)
        for seq in (1, 2, 3):
            j.append(seq, READS[0:1], None)
        j.truncate_through(2)
        assert [r.seq for r in j.records()] == [3]
        j.append(4, READS[1:2], None)
        assert [r.seq for r in j.records()] == [3, 4]
        j.close()

    def test_corrupt_record_stops_replay(self, tmp_path):
        path = str(tmp_path / "j.wal")
        j = lsm.DeltaJournal(path)
        j.append(1, READS[0:1], None)
        j.append(2, READS[1:2], None)
        j.close()
        size = os.path.getsize(path)
        with open(path, "r+b") as fh:
            fh.seek(size - 10)
            byte = fh.read(1)
            fh.seek(size - 10)
            fh.write(bytes([byte[0] ^ 0xFF]))
        assert _journal_seqs(path) == [1]

    def test_mid_file_corruption_rejected(self, tmp_path):
        path = str(tmp_path / "j.wal")
        j = lsm.DeltaJournal(path)
        j.append(1, READS[0:1], None)
        end_of_rec1 = os.path.getsize(path)
        j.append(2, READS[1:2], None)
        j.close()
        with open(path, "r+b") as fh:
            fh.seek(end_of_rec1 - 10)
            byte = fh.read(1)
            fh.seek(end_of_rec1 - 10)
            fh.write(bytes([byte[0] ^ 0xFF]))
        with pytest.raises(lsm.JournalError, match="corrupt"):
            lsm.DeltaJournal(path)

    def test_foreign_file_rejected(self, tmp_path):
        path = str(tmp_path / "not-a-journal")
        with open(path, "wb") as fh:
            fh.write(b"PK\x03\x04 definitely a zip")
        with pytest.raises(lsm.JournalError, match="magic"):
            lsm.DeltaJournal(path)

    def test_future_version_rejected(self, tmp_path):
        path = str(tmp_path / "future.wal")
        with open(path, "wb") as fh:
            fh.write(struct.pack("<4sI", b"IDLJ", 99))
        with pytest.raises(lsm.JournalError, match="version"):
            lsm.DeltaJournal(path)

    def test_bytes_equal_reference_for_same_appends(self, tmp_path):
        paths = {}
        for name, mod in (("port", lsm), ("ref", j_lsm)):
            paths[name] = str(tmp_path / f"{name}.wal")
            j = mod.DeltaJournal(paths[name])
            for seq, r, f in _records():
                j.append(seq, r, f)
            j.truncate_through(1)
            j.append(4, READS[5:6], np.asarray([9]))
            j.close()
        port_bytes = _read(paths["port"])
        assert port_bytes == _read(paths["ref"])
        assert port_bytes[:8] == struct.pack("<4sI", b"IDLJ", 1)

    @pytest.mark.parametrize("writer", ["ref", "port"])
    def test_journal_replays_in_the_other_package(self, tmp_path, writer):
        """A journal written by either package boots the other's live
        index to the same answers (the reference union index's)."""
        wal = str(tmp_path / "delta.wal")
        writes = _WRITES["bitsliced"]
        if writer == "ref":
            jlive = j_lsm.LiveIndex(_build_base("bitsliced", port=False),
                                    journal=j_lsm.DeltaJournal(wal))
            for (a, b), fids in writes:
                jlive.insert(jnp.asarray(READS[a:b]), fids)
            jlive.close()
            reboot = lsm.LiveIndex(_build_base("bitsliced"),
                                   journal=lsm.DeltaJournal(wal))
            assert reboot.delta_seq == 2
            _assert_rows(_live_msmt(reboot), _want("bitsliced"))
            reboot.close()
        else:
            live = lsm.LiveIndex(_build_base("bitsliced"),
                                 journal=lsm.DeltaJournal(wal))
            for (a, b), fids in writes:
                live.insert(READS[a:b], fids)
            live.close()
            jreboot = j_lsm.LiveIndex(_build_base("bitsliced", port=False),
                                      journal=j_lsm.DeltaJournal(wal))
            assert jreboot.delta_seq == 2
            _assert_rows([np.asarray(jreboot.msmt(jnp.asarray(q)[None]))[0]
                          for q in QUERIES], _want("bitsliced"))
            jreboot.close()


# -- in-place writes: where the reference relies on fresh buffers ------------

class TestInPlaceWrites:
    def test_insert_consumes_the_prior_delta(self):
        live = lsm.LiveIndex(_build_base("bitsliced"))
        stale = live.delta
        (a, b), fids = _WRITES["bitsliced"][0]
        live.insert(READS[a:b], fids)
        assert live.delta.words[0] is stale.words[0]      # written in place
        with pytest.raises(state_mod.StaleIndexError):
            state_mod.query(stale, READS[:1])

    def test_donate_false_keeps_prior_delta_live(self):
        live = lsm.LiveIndex(_build_base("bitsliced"))
        held = live.delta
        before = held.words[0].clone()
        (a, b), fids = _WRITES["bitsliced"][0]
        live.insert(READS[a:b], fids, donate=False)
        assert torch.equal(held.words[0], before)          # untouched
        state_mod.query(held, READS[:1])

    def test_plan_survives_post_plan_inserts(self):
        live = lsm.LiveIndex(_build_base("bitsliced"))
        (a, b), fids = _WRITES["bitsliced"][0]
        live.insert(READS[a:b], fids)
        plan = live.plan_compaction()
        assert plan.delta.words[0].data_ptr() != \
            live.delta.words[0].data_ptr()                 # a clone
        frozen = plan.delta.words[0].clone()
        (a, b), fids = _WRITES["bitsliced"][1]
        live.insert(READS[a:b], fids)                      # in place
        assert torch.equal(plan.delta.words[0], frozen)
        merged = lsm.LiveIndex.compact(plan)
        live.publish(merged, plan.upto_seq)
        _assert_rows(_live_msmt(live), _want("bitsliced"))

    @pytest.mark.parametrize("engine", ENGINES)
    def test_or_states_leaves_its_inputs_untouched(self, engine):
        live = lsm.LiveIndex(_build_base(engine))
        for (a, b), fids in _WRITES[engine]:
            live.insert(READS[a:b], fids)
        base, delta = live.base, live.delta
        before = [w.clone() for w in base.words + delta.words]
        merged = lsm.or_states(base, delta)
        assert all(torch.equal(w, b)
                   for w, b in zip(base.words + delta.words, before))
        assert all(m.data_ptr() != b.data_ptr()
                   for m, b in zip(merged.words, base.words))
        for m, b, d in zip(merged.words, base.words, delta.words):
            assert torch.equal(m, b | d)
        jbase = _build_base(engine, port=False).state
        jmerged = j_lsm.or_states(jbase, j_lsm.empty_delta(jbase))
        assert [tuple(w.shape) for w in merged.words] == \
            [tuple(w.shape) for w in jmerged.words]

    @pytest.mark.parametrize("engine", ["bloom", "rambo"])
    def test_replay_compaction_leaves_plan_base_untouched(self, engine):
        live = lsm.LiveIndex(_build_base(engine),
                             delta_cfg=_cfg(idl, 1 << 12))
        for (a, b), fids in _WRITES[engine]:
            live.insert(READS[a:b], fids)
        plan = live.plan_compaction()
        before = plan.base.words[0].clone()
        merged = lsm.LiveIndex.compact(plan)
        assert torch.equal(plan.base.words[0], before)     # still serving
        assert merged.words[0].data_ptr() != plan.base.words[0].data_ptr()
        state_mod.query(plan.base, READS[:1])              # not consumed
        assert not torch.equal(merged.words[0], before)
        live.publish(merged, plan.upto_seq)
        _assert_rows(_live_msmt(live), _want(engine))


def test_live_router_insert_span_tree():
    """The write's span tree: a root ``insert`` with ``journal_append``
    and ``fanout`` children and one ``replica_apply`` per replica, all on
    the root's trace."""
    import repro_torch.obs as obs

    obs.reset()
    rt = LiveReplicaRouter(_build_base("bitsliced"),
                           ServiceConfig(max_batch=4),
                           RouterConfig(n_replicas=2, policy="round_robin"))
    try:
        with rt:
            _acks(rt.insert(READS[3:5], np.asarray([5, 17])))
            _search(rt, QUERIES)

            def insert_tree():
                for recs in obs_export.traces_of(
                        obs_export.snapshot()).values():
                    names = [r["name"] for r in recs]
                    if "insert" in names and \
                            names.count("replica_apply") == 2:
                        return recs
                return None

            deadline = time.monotonic() + TIMEOUT
            while insert_tree() is None and time.monotonic() < deadline:
                time.sleep(0.02)
            recs = insert_tree()
            assert recs is not None
            by_name = {}
            for r in recs:
                by_name.setdefault(r["name"], []).append(r)
            (root,) = by_name["insert"]
            assert root["parent"] is None and root["status"] == "ok"
            assert root["attrs"]["tier"] == "router"
            assert root["attrs"]["n_reads"] == 2
            assert root["attrs"]["n_replicas"] == 2
            (journal,) = by_name["journal_append"]
            (fanout,) = by_name["fanout"]
            assert journal["parent"] == fanout["parent"] == root["span"]
            for rec in by_name["replica_apply"]:
                assert rec["trace"] == root["trace"]
                assert rec["parent"] == root["span"]
            q_traces = [rs for rs in obs_export.traces_of(
                obs_export.snapshot()).values()
                if any(r["name"] == "request" for r in rs)]
            assert len(q_traces) >= len(QUERIES)
    finally:
        obs.reset()
