"""PyTorch port vs the JAX reference: the wire layer (``serving/ipc.py``)
and the process fabric (``serving/fabric.py``), on the CPU.

The wire must reassemble frames byte-exactly through short reads and
EINTR, and report a real peer death as ``WireClosed``. The fabric's
gateway answers must equal the reference's union index — a JAX engine
built in this process from the same numpy reads — exactly, through real
worker processes (``FabricConfig(device="cpu")``): before and after
writes, across a kill -9, a crash during a rolling swap, a rolling
restart under traffic, a gateway reboot that replays the journal, and
with per-worker membership caches; traces stitch across the processes.
One 2-worker fleet is shared by the non-destructive tests; every future
and join has its own timeout. The reference's cases are those of
``tests/test_ipc.py`` and ``tests/test_fabric.py``, at their sizes.
"""

import functools
import os
import pickle
import signal
import socket
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.core import idl as j_idl  # noqa: E402
from repro.index.engines import BitSlicedIndex as JBitSlicedIndex  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.core import idl  # noqa: E402
from repro_torch.index import engines, store  # noqa: E402
from repro_torch.obs import export as obs_export  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    FabricConfig,
    FabricError,
    KmerCacheConfig,
    ProcessFabric,
    ServiceConfig,
    ipc,
)

N_FILES = 40
BASE_FIDS = [0, 9, 39]
DELTA_FIDS = [5, 17]
TIMEOUT = 120

READS = np.random.default_rng(0xC0FFEE).integers(0, 4, size=(6, 120),
                                                 dtype=np.uint8)
LENS = [120, 100, 77, 120, 61, 99]
QUERIES = [np.asarray(READS[i][:n]) for i, n in enumerate(LENS)]


# ---------------------------------------------------------------------------
# The wire: short reads, EINTR, EOF (the reference's tests/test_ipc.py).
# ---------------------------------------------------------------------------

class _ScriptedSocket:
    """Duck-typed socket whose recv follows a byte-exact script: ``bytes``
    (at most one item per recv call, truncated to the requested size with
    the remainder pushed back) or an exception instance to raise."""

    def __init__(self, script):
        self._script = list(script)
        self.recv_calls = 0

    def recv(self, size):
        self.recv_calls += 1
        if not self._script:
            return b""                     # EOF
        item = self._script.pop(0)
        if isinstance(item, BaseException):
            raise item
        if len(item) > size:
            self._script.insert(0, item[size:])
            item = item[:size]
        return item

    def sendall(self, data):
        raise AssertionError("recv-only fake")

    def shutdown(self, how):
        pass

    def close(self):
        pass


def _frame(obj) -> bytes:
    data = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    return ipc._LEN.pack(len(data)) + data


def _eintr():
    return InterruptedError(4, "Interrupted system call")


def _one_byte_pieces(raw):
    return [raw[i:i + 1] for i in range(len(raw))]


def _eintr_between_prefix_bytes(raw):
    return [raw[:1], _eintr(), raw[1:4], _eintr(), raw[4:]]


def _eintr_storm(raw):
    script = []
    for i in range(len(raw)):
        script += [_eintr(), raw[i:i + 1]]
    return script


def _jagged(raw):
    return [raw[:2], raw[2:4], raw[4:9], raw[9:]]


@pytest.mark.parametrize("msg,schedule", [
    # the worst legal kernel: every recv returns ONE byte — the length
    # prefix itself fragments across four reads
    (ipc.Request(7, "query", (3, b"ACGT")), _one_byte_pieces),
    # 2+2 bytes of prefix, then the body in two jagged pieces
    (ipc.Reply(42, payload={"hits": 17}), _jagged),
    # a signal between prefix bytes must NOT look like peer death
    (ipc.Request(9, "insert", None), _eintr_between_prefix_bytes),
    (ipc.Reply(3, payload="ready"), _eintr_storm),
], ids=["byte_at_a_time", "split_inside_length_prefix",
        "eintr_mid_prefix_is_retried", "eintr_storm_is_survived"])
def test_wire_reassembles_frames(msg, schedule):
    raw = _frame(msg)
    sock = _ScriptedSocket(schedule(raw))
    assert ipc.Wire(sock).recv() == msg
    if schedule is _one_byte_pieces:
        assert sock.recv_calls == len(raw)


def test_wire_frames_are_the_reference_bytes():
    """The port's messages pickle to the reference's frame layout: the
    same length prefix and the same fields (only the module differs)."""
    from repro.serving import ipc as j_ipc

    assert ipc._LEN.format == j_ipc._LEN.format
    assert ipc.MAX_FRAME == j_ipc.MAX_FRAME and ipc.KINDS == j_ipc.KINDS
    for cls in ("Hello", "Request", "Reply"):
        fields = [(f.name, f.default) for f in
                  getattr(ipc, cls).__dataclass_fields__.values()]
        assert fields == [(f.name, f.default) for f in
                          getattr(j_ipc, cls).__dataclass_fields__.values()]


def test_two_frames_back_to_back():
    """One recv's overshoot must not eat into the next frame."""
    a, b = ipc.Request(1, "stats"), ipc.Request(2, "shutdown")
    wire = ipc.Wire(_ScriptedSocket([_frame(a) + _frame(b)]))
    assert wire.recv() == a
    assert wire.recv() == b


@pytest.mark.parametrize("script", [
    [b"\x10\x00"],                                    # 2 of 4 prefix bytes
    [_frame(ipc.Request(1, "stats"))[:-3]],           # body truncated
    # EINTR is the ONLY retried errno — a reset is still death
    [ConnectionResetError(104, "Connection reset by peer")],
], ids=["eof_mid_prefix", "eof_mid_body", "real_errors_still_raise"])
def test_wire_closed_on_eof_or_error(script):
    with pytest.raises(ipc.WireClosed):
        ipc.Wire(_ScriptedSocket(script)).recv()


class TestRealSocketpair:
    """One real kernel pass keeps the fakes honest (dribbled writes force
    genuine short reads)."""

    def test_dribbled_frame_reassembles(self):
        a, b = socket.socketpair()
        try:
            msg = ipc.Request(11, "query", (0, b"x" * 4096))
            raw = _frame(msg)

            def _dribble():
                for i in range(0, len(raw), 7):
                    a.sendall(raw[i:i + 7])

            t = threading.Thread(target=_dribble)
            t.start()
            got = ipc.Wire(b).recv()
            t.join(timeout=TIMEOUT)
            assert got == msg
        finally:
            a.close()
            b.close()

    def test_peer_close_mid_frame(self):
        a, b = socket.socketpair()
        try:
            raw = _frame(ipc.Reply(1, payload="partial"))
            a.sendall(raw[:len(raw) // 2])
            a.close()
            with pytest.raises(ipc.WireClosed):
                ipc.Wire(b).recv()
        finally:
            b.close()


# ---------------------------------------------------------------------------
# The fabric (the reference's tests/test_fabric.py).
# ---------------------------------------------------------------------------

def _cfg(pkg):
    return pkg.IDLConfig(k=31, t=16, L=1 << 10, eta=2, m=1 << 16)


@functools.lru_cache(maxsize=None)
def _oracle_rows(writes: tuple) -> tuple:
    """The reference's union index (base + ``writes``, each ``(a, b,
    fids)`` over ``READS[a:b]``): its ``msmt`` row for each query."""
    eng = JBitSlicedIndex.build(_cfg(j_idl), "idl", n_files=N_FILES
                                ).insert_batch(jnp.asarray(READS[:3]),
                                               np.asarray(BASE_FIDS))
    for a, b, fids in writes:
        eng = eng.insert_batch(jnp.asarray(READS[a:b]), np.asarray(fids))
    return tuple(np.asarray(eng.msmt(jnp.asarray(q)[None]))[0]
                 for q in QUERIES)


BASE = ()
UNION = ((3, 5, tuple(DELTA_FIDS)),)
UNION_23 = UNION + ((5, 6, (23,)),)


def _assert_matches(results, oracle, queries=QUERIES):
    """Each result is a numpy verdict row equal to the oracle's row of its
    query (``queries`` repeat ``QUERIES`` in order)."""
    rows = _oracle_rows(oracle)
    for i, (q, res) in enumerate(zip(queries, results)):
        assert isinstance(res.matches, np.ndarray)
        np.testing.assert_array_equal(res.matches, rows[i % len(QUERIES)])


@pytest.fixture(scope="module")
def snap(tmp_path_factory):
    """The port's base index (reads[:3] on the CPU), saved once."""
    eng = engines.BitSlicedIndex.build(_cfg(idl), "idl", n_files=N_FILES,
                                       device="cpu").insert_batch(
        READS[:3], np.asarray(BASE_FIDS))
    return store.save(eng, str(tmp_path_factory.mktemp("fab") / "snap"))


def _fab_cfg(**kw) -> FabricConfig:
    kw.setdefault("n_workers", 2)
    kw.setdefault("service", ServiceConfig(max_batch=4))
    kw.setdefault("device", "cpu")
    return FabricConfig(**kw)


def _search(fab, queries=QUERIES):
    return [f.result(timeout=TIMEOUT)
            for f in [fab.submit(q) for q in queries]]


STREAM = [QUERIES[i % len(QUERIES)] for i in range(24)]


class TestFabricServing:
    """One shared 2-worker fleet: parity, stamps, admission, stats."""

    @pytest.fixture(scope="class")
    def fab(self, snap, tmp_path_factory):
        fab = ProcessFabric(
            snap, _fab_cfg(),
            journal_path=str(tmp_path_factory.mktemp("wal") / "wal.idlj"))
        yield fab
        fab.close()

    def test_parity_and_read_your_writes(self, fab):
        _assert_matches(_search(fab), BASE)
        ack = fab.insert(READS[3:5], DELTA_FIDS).result(timeout=TIMEOUT)
        assert ack.delta_seq == 1 and ack.n_reads == 2
        # post-write: fleet == union oracle on EVERY worker
        for _ in range(2):
            results = _search(fab)
            _assert_matches(results, UNION)
            for res in results:
                assert res.delta_seq >= ack.delta_seq
                assert res.version == ack.base_version
                assert res.missing_files == ()
        # the gateway unpickled numpy only: no CUDA context here
        assert not torch.cuda.is_initialized()

    def test_gateway_rejects_malformed_reads(self, fab):
        with pytest.raises(ValueError, match="one 1-D read"):
            fab.submit(np.zeros((2, 120), dtype=np.uint8))
        with pytest.raises(ValueError, match="has no 31-mers"):
            fab.submit(np.zeros((7,), dtype=np.uint8))

    def test_stats_reach_every_worker(self, fab):
        """The reference's stats, plus the port's ``"device"`` entry: the
        worker's kernel launch counters (none on the CPU: the plain
        versions ran) and its peak device memory (0 on the CPU)."""
        stats = fab.stats()
        assert len(stats) == 2
        assert sum(s["requests_served"] for s in stats.values()) > 0
        assert {s["version"] for s in stats.values()} == {0}
        pids = set(fab.worker_pids().values())
        for s in stats.values():
            assert s["pid"] in pids and s["pid"] != os.getpid()
            dev = s["device"]
            assert dev["max_memory_allocated"] == 0
            assert dev["launches"] == {
                "gather_planned_rows": 0, "gather_planned_bits": 0,
                "probe_planned_bits": 0, "insert_planned": 0,
                "insert_with_plan": 0, "window_min": 0}


class TestFaultPaths:
    """Destructive tests: each boots (and tears down) its own fleet."""

    def test_kill9_worker_midstream(self, snap, tmp_path):
        """kill -9 one worker with requests in flight: the gateway
        re-routes them to the survivor and every answer still equals the
        union oracle — zero dropped futures."""
        fab = ProcessFabric(snap, _fab_cfg(policy="round_robin"),
                            journal_path=str(tmp_path / "wal.idlj"))
        try:
            fab.insert(READS[3:5], DELTA_FIDS).result(timeout=TIMEOUT)
            _search(fab)                           # warm both workers
            futures = [fab.submit(q) for q in STREAM]
            victim = sorted(fab.worker_pids().items())[0][1]
            os.kill(victim, signal.SIGKILL)
            _assert_matches([f.result(timeout=TIMEOUT) for f in futures],
                            UNION, STREAM)
            deadline = time.monotonic() + 30
            while fab.n_workers > 1 and time.monotonic() < deadline:
                time.sleep(0.05)
            assert fab.n_workers == 1
            # the fleet keeps serving — writes and reads — on the survivor
            fab.insert(READS[5:6], [23]).result(timeout=TIMEOUT)
            _assert_matches(_search(fab), UNION_23)
        finally:
            fab.close()

    def test_worker_crash_during_rolling_swap(self, snap, tmp_path):
        """A replacement that dies booting ABORTS the rollout: the fleet
        keeps serving the old snapshot at the old version."""
        fab = ProcessFabric(snap, _fab_cfg())
        try:
            new_snap = store.save(store.load(snap, device="cpu"),
                                  str(tmp_path / "snap2"))
            fab._test_flags["boot_fail_snapshot"] = new_snap
            with pytest.raises(FabricError, match="aborted"):
                fab.rolling_restart(new_snap)
            assert fab.version == 0
            assert fab.n_workers == 2
            stats = fab.stats()
            assert {s["version"] for s in stats.values()} == {0}
            results = _search(fab)
            _assert_matches(results, BASE)
            assert all(r.version == 0 for r in results)
        finally:
            fab.close()

    def test_rolling_restart_under_traffic(self, snap):
        """A healthy rolling swap: requests submitted before, during and
        after all resolve correctly; the version advances only when every
        worker swapped."""
        fab = ProcessFabric(snap, _fab_cfg())
        try:
            _search(fab)
            before = [fab.submit(q) for q in QUERIES]
            version = fab.rolling_restart()        # same snapshot, v+1
            after = [fab.submit(q) for q in QUERIES]
            assert version == 1 and fab.version == 1
            _assert_matches([f.result(timeout=TIMEOUT) for f in before],
                            BASE)
            results = [f.result(timeout=TIMEOUT) for f in after]
            _assert_matches(results, BASE)
            assert all(r.version == 1 for r in results)
            assert fab.n_workers == 2
        finally:
            fab.close()

    def test_gateway_reboot_replays_wal(self, snap, tmp_path):
        """Acked writes survive a gateway reboot: the new gateway's workers
        replay the WAL tail and answer == union oracle."""
        wal = str(tmp_path / "wal.idlj")
        fab = ProcessFabric(snap, _fab_cfg(n_workers=1), journal_path=wal)
        try:
            fab.insert(READS[3:5], DELTA_FIDS).result(timeout=TIMEOUT)
        finally:
            fab.close()
        reborn = ProcessFabric(snap, _fab_cfg(n_workers=1),
                               journal_path=wal)
        try:
            assert reborn.wal_seq == 1
            results = _search(reborn)
            _assert_matches(results, UNION)
            assert all(r.delta_seq == 1 for r in results)
        finally:
            reborn.close()


class TestKmerCacheAcrossTheFleet:
    """Per-worker membership caches through the process boundary; they
    survive a zero-drop rolling restart (replacements boot cold, replay
    the WAL, and re-warm), and a compaction rolls the fleet onto the
    merged snapshot with the same answers."""

    def test_cache_survives_zero_drop_rolling_restart(self, snap,
                                                      tmp_path):
        fab = ProcessFabric(
            snap, _fab_cfg(service=ServiceConfig(
                max_batch=4, kmer_cache=KmerCacheConfig(capacity=1 << 14))),
            journal_path=str(tmp_path / "wal.idlj"))
        stream = STREAM[:18]
        try:
            _assert_matches(_search(fab, stream), BASE, stream)
            _assert_matches(_search(fab, stream), BASE, stream)
            cs = fab.cache_stats()
            assert cs is not None and cs["hits"] > 0
            assert 0.0 < cs["hit_rate"] <= 1.0
            fab.insert(READS[3:5], DELTA_FIDS).result(timeout=TIMEOUT)
            _assert_matches(_search(fab, stream), UNION, stream)
            before = [fab.submit(q) for q in stream]
            version = fab.rolling_restart()
            after = [fab.submit(q) for q in stream]
            _assert_matches([f.result(timeout=TIMEOUT) for f in before],
                            UNION, stream)
            results = [f.result(timeout=TIMEOUT) for f in after]
            _assert_matches(results, UNION, stream)
            assert all(r.version == version for r in results)
            assert fab.n_workers == 2
            _assert_matches(_search(fab, stream), UNION, stream)
            cs2 = fab.cache_stats()
            assert cs2 is not None and cs2["hits"] > 0
            # the lead worker folds the delta and the fleet rolls onto the
            # merged snapshot: the same answers, the journal reclaimed
            merged = str(tmp_path / "merged")
            assert fab.compact(merged) == version + 1
            results = _search(fab, stream)
            _assert_matches(results, UNION, stream)
            assert all(r.version == version + 1 for r in results)
            assert store.read_meta(merged) == store.read_meta(snap)
        finally:
            fab.close()


class TestObservabilityAcrossTheFleet:
    """The gateway's trace context rides the frame, the worker opens child
    spans under it, and ``obs_snapshot()`` stitches one tree out of many
    pids; a kill -9 error-closes the dead worker's dispatch spans."""

    def _stitched_traces(self, fab):
        snap = fab.obs_snapshot()
        return {tid: recs
                for tid, recs in obs_export.traces_of(snap).items()
                if len({r["pid"] for r in recs}) > 1}

    def test_trace_stitches_across_processes(self, snap, tmp_path):
        obs.reset()
        fab = ProcessFabric(snap, _fab_cfg(),
                            journal_path=str(tmp_path / "wal.idlj"))
        try:
            _assert_matches(_search(fab), BASE)
            deadline = time.monotonic() + 30
            stitched = self._stitched_traces(fab)
            while time.monotonic() < deadline and \
                    len(stitched) < len(QUERIES):
                time.sleep(0.05)
                stitched = self._stitched_traces(fab)
            assert len(stitched) >= len(QUERIES)
            gw_pid = os.getpid()
            for recs in stitched.values():
                by_name = {}
                for r in recs:
                    by_name.setdefault(r["name"], []).append(r)
                (root,) = [r for r in by_name["request"]
                           if r["pid"] == gw_pid]
                assert root["parent"] is None
                assert root["status"] == "ok"
                assert root["attrs"]["tier"] == "gateway"
                (hop,) = by_name["worker_exec"]
                assert hop["pid"] == gw_pid
                assert hop["parent"] == root["span"]
                assert hop["status"] == "ok"
                (wreq,) = [r for r in by_name["request"]
                           if r["pid"] != gw_pid]
                assert wreq["parent"] == hop["span"]
                for stage in ("queue_wait", "assemble", "execute",
                              "finalize"):
                    (srec,) = by_name[stage]
                    assert srec["pid"] == wreq["pid"]
                    assert srec["parent"] == wreq["span"]
                assert len({r["trace"] for r in recs}) == 1
        finally:
            fab.close()

    def test_kill9_error_closes_orphaned_spans(self, snap, tmp_path):
        obs.reset()
        fab = ProcessFabric(snap, _fab_cfg(policy="round_robin"),
                            journal_path=str(tmp_path / "wal.idlj"))
        try:
            fab.insert(READS[3:5], DELTA_FIDS).result(timeout=TIMEOUT)
            _search(fab)
            futures = [fab.submit(q) for q in STREAM]
            victim_id, victim_pid = sorted(fab.worker_pids().items())[0]
            os.kill(victim_pid, signal.SIGKILL)
            _assert_matches([f.result(timeout=TIMEOUT) for f in futures],
                            UNION, STREAM)

            def error_closed():
                return [r for r in obs_export.snapshot()["spans"]
                        if r["name"] == "worker_exec"
                        and r["status"] == "error"
                        and r.get("attrs", {}).get("error")
                        == f"worker {victim_id} died"]

            deadline = time.monotonic() + 30
            while time.monotonic() < deadline and not error_closed():
                time.sleep(0.05)
            orphans = error_closed()
            assert orphans, "kill -9 left dispatch spans open"
            ok_hops = {r["trace"] for r in obs_export.snapshot()["spans"]
                       if r["name"] == "worker_exec"
                       and r["status"] == "ok"}
            assert any(r["trace"] in ok_hops for r in orphans)
        finally:
            fab.close()
