"""Process-parallel serving fabric: one gateway, N mmap-booted workers.

Port of :mod:`repro.serving.fabric`. ``FabricConfig.device`` (default
``"cuda"``) names the torch device every worker loads the snapshot onto;
each worker then has its own CUDA context and its own copy of the base (a
device's memory is not shared across processes). The gateway never
touches the device: it reads the manifest, routes numpy reads and
unpickles numpy results. A worker's ``stats`` reply adds a ``"device"``
entry: its process's kernel launch counters and
``torch.cuda.max_memory_allocated()`` (0 on the CPU).

The in-process cluster (:mod:`repro_torch.serving.router`) tops out at one
interpreter: K replicas share a GIL, so host-side batch assembly,
planning and decode serialize no matter how many cores the box has. The
fabric promotes the same architecture to real processes:

* **Gateway** (this process) owns admission and durability. It speaks
  the existing typed boundary — ``SearchRequest`` in, ``SearchResult``
  out, ``InsertAck`` for writes — validates reads with the SAME
  ``normalize_request`` the in-process service uses, buckets them with
  the SAME ``bucket_for`` geometry (learned from the snapshot manifest
  via :func:`repro_torch.index.store.read_meta` — the gateway never holds the
  index), and spreads them over workers with the SAME
  :class:`~repro_torch.serving.router.RoutingPolicy` the router uses. The
  fleet write-ahead journal lives HERE and is the single source of
  sequence truth: ``insert`` journals once (flush + fsync) under the
  gateway lock, then fans the batch — with its fleet ``seq`` riding
  along — to every serving worker.

* **Workers** (``multiprocessing`` ``spawn``) each boot a
  :class:`~repro_torch.serving.live.LiveGeneSearchService` by loading ONE
  shared on-disk snapshot with ``store.load(mmap=True, verify="lazy")``
  — the checksum pass runs behind the boot, cold-start is O(manifest) +
  one data pass, and the page cache shares that single read across all
  K workers — then serve query/insert requests over a length-prefixed
  pickle socket (:mod:`repro_torch.serving.ipc`). Inside a worker, all writes
  and query dispatch ride the scheduler's single flusher thread, which
  is what licenses the live index's in-place delta writes.

* **Fault model** — a worker that dies (crash, ``kill -9``, failed
  background verify) surfaces as EOF on its wire: the gateway marks it
  dead, re-routes its in-flight queries to surviving workers, and counts
  its unacked inserts as covered (the write is journaled; the worker's
  replacement replays it). A gateway reboot replays the journal into
  every worker — an acked write is never lost.

* **Rolling restart** — the fleet-wide generalization of hot snapshot
  swap. Workers swap one at a time, replacement-first: boot the new
  worker from the target snapshot, replay the journal tail, catch it up
  on writes that landed during its boot, and only then drain + retire
  the old one — queries keep flowing to the rest of the fleet the whole
  time (zero dropped requests, asserted under traffic in the bench). If
  a replacement fails to boot, the rollout aborts and already-swapped
  workers roll back: the fleet keeps serving the OLD version, never a
  mix. :meth:`ProcessFabric.compact` rides the same machinery: the lead
  worker folds base+delta and saves the merged snapshot, then the fleet
  rolls onto it and the journal truncates through the fold watermark.
"""

from __future__ import annotations

import dataclasses
import itertools
import multiprocessing
import os
import socket
import tempfile
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import kernels
from repro_torch.index import lsm, store
from repro_torch.index import state as state_mod
from repro_torch.kernels import build
from repro_torch.obs import export as obs_export
from repro_torch.obs import trace as obs_trace
from repro_torch.serving import ipc
from repro_torch.serving import service as service_mod
from repro_torch.serving.live import LiveGeneSearchService
from repro_torch.serving.router import RoutingPolicy
from repro_torch.serving.scheduler import AsyncScheduler, InsertAck, \
    SchedulerConfig

__all__ = [
    "FabricConfig",
    "FabricError",
    "WorkerLost",
    "ProcessFabric",
    "worker_main",
]


class FabricError(RuntimeError):
    """A fleet-level operation failed (boot, rollout, no workers)."""


class WorkerLost(FabricError):
    """A request could not be served because its worker died and no
    surviving worker could take it."""


@dataclasses.dataclass(frozen=True)
class FabricConfig:
    """Fleet knobs (static for the life of the fabric)."""

    n_workers: int = 2
    policy: str = "least_outstanding"
    service: service_mod.ServiceConfig = dataclasses.field(
        default_factory=service_mod.ServiceConfig)
    scheduler: SchedulerConfig = dataclasses.field(
        default_factory=SchedulerConfig)
    verify: str = "lazy"         # worker snapshot verify mode (store.load)
    boot_timeout_s: float = 180.0   # spawn -> ready (child re-imports torch)
    device: str = "cuda"         # torch device the workers load onto

    def __post_init__(self):
        if self.n_workers < 1:
            raise ValueError("n_workers must be >= 1")
        RoutingPolicy(self.policy)        # validates the policy name


# ---------------------------------------------------------------------------
# The worker process.
# ---------------------------------------------------------------------------

def device_stats(device: torch.device) -> dict:
    """The ``"device"`` entry of a worker's ``stats`` reply: this
    process's kernel launch counters and peak device memory (0 off the
    card). Plain ints, so the reply unpickles without torch's CUDA."""
    return {"launches": kernels.launch_counts(),
            "max_memory_allocated": int(torch.cuda.max_memory_allocated(
                device)) if device.type == "cuda" else 0}


def load_kernels(device: torch.device) -> None:
    """Load every kernel library on a CUDA worker at boot (building any
    that is missing), so a worker that cannot build one fails its boot
    instead of its first request."""
    if device.type == "cuda":
        for name in build.SOURCES:
            build.library(name)


def worker_main(worker_id: int, socket_path: str, snapshot_dir: str,
                base_version: int, start_seq: int,
                svc_cfg: service_mod.ServiceConfig,
                sched_cfg: SchedulerConfig, verify: str,
                flags: dict, device: str) -> None:
    """Entry point of one worker process (``spawn`` target).

    Boot order matters: connect + Hello first (so the gateway can watch
    the boot), then receive the journal tail, THEN build the live index
    and replay it — all single-threaded — and only then start the
    scheduler and reply ready. After ready, every write reaches the
    delta through the scheduler's flusher thread (the single-writer
    discipline in-place delta writes require), so the gateway catches a
    booted worker up via ordinary ``insert`` requests, never a raw
    replay.
    """
    if flags.get("boot_fail_snapshot") == snapshot_dir:
        os._exit(2)               # test hook: crash before Hello
    wire = ipc.connect(socket_path)
    wire.send(ipc.Hello(worker_id=worker_id, pid=os.getpid()))
    boot = wire.recv()            # Request(kind="replay", payload=tail)
    assert boot.kind == "replay", boot
    dev = torch.device(device)
    try:
        load_kernels(dev)
        live = lsm.LiveIndex(
            store.load(snapshot_dir, mmap=True, verify=verify, device=dev),
            base_version=base_version, start_seq=start_seq)
        if boot.payload:
            live.replay(boot.payload)
        svc = LiveGeneSearchService(live, svc_cfg)
        sched = AsyncScheduler(svc, sched_cfg)
    except Exception as e:  # noqa: BLE001 - boot failure -> loud reply
        wire.send(ipc.Reply(boot.id, error=e))
        os._exit(3)
    wire.send(ipc.Reply(boot.id, payload="ready"))

    stop = threading.Event()

    def _watchdog() -> None:
        # a lazily verified snapshot must fail LOUDLY: report the
        # corruption to the gateway, then die (EOF completes the signal)
        while not stop.wait(0.25):
            try:
                store.check_verified(snapshot_dir, wait=False)
            except store.SnapshotError as e:
                try:
                    wire.send(ipc.Reply(-1, error=e))
                finally:
                    os._exit(4)

    threading.Thread(target=_watchdog, daemon=True,
                     name=f"idl-worker-{worker_id}-verify").start()

    def _reply_when_done(mid: int, fut: Future) -> None:
        def _cb(f: Future) -> None:
            err = f.exception()
            try:
                wire.send(ipc.Reply(
                    mid, payload=None if err else f.result(), error=err))
            except ipc.WireClosed:
                pass              # gateway gone; recv loop exits on EOF
        fut.add_done_callback(_cb)

    def _compact_to(mid: int, save_dir: str) -> None:
        # plan under the live lock, merge + save off every hot path; the
        # worker keeps serving base+delta — the fold only becomes the
        # fleet's base through the gateway's rolling restart. The merge is
        # waited for before the save; the allocator hands the merge's
        # memory back afterwards, or this process would keep it reserved
        # where the fleet's other processes cannot use it
        try:
            plan = svc.live.plan_compaction()
            merged = lsm.LiveIndex.compact(plan)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            store.save(merged, save_dir)
            upto = plan.upto_seq
            del plan, merged
            if dev.type == "cuda":
                torch.cuda.empty_cache()
            wire.send(ipc.Reply(mid, payload=upto))
        except Exception as e:  # noqa: BLE001 - forward to the gateway
            wire.send(ipc.Reply(mid, error=e))

    while True:
        try:
            msg = wire.recv()
        except ipc.WireClosed:
            break                 # gateway died; nothing to serve for
        try:
            if msg.kind == "query":
                rid, read = msg.payload
                # msg.trace = the gateway's dispatch-span context: the
                # request/queue_wait/... spans this worker emits become
                # its children, so the gateway stitches ONE tree
                _reply_when_done(msg.id, sched.submit(
                    service_mod.SearchRequest(read=read, request_id=rid),
                    trace=msg.trace))
            elif msg.kind == "insert":
                seq, reads, fids = msg.payload
                _reply_when_done(msg.id, sched.submit_insert(
                    reads, fids, seq=seq, trace=msg.trace))
            elif msg.kind == "compact":
                threading.Thread(
                    target=_compact_to, args=(msg.id, msg.payload),
                    daemon=True, name=f"idl-worker-{worker_id}-compact",
                ).start()
            elif msg.kind == "stats":
                wire.send(ipc.Reply(msg.id, payload={
                    "pid": os.getpid(),
                    "version": svc.version,
                    "delta_seq": svc.live.delta_seq,
                    "requests_served": svc.requests_served(),
                    "compile_counts": sched.compile_counts(),
                    "kmer_cache": svc.cache_stats(),
                    # the whole process-local obs state rides the same
                    # reply: metrics for the fleet merge, finished span
                    # records for cross-process trace stitching
                    "obs": obs_export.snapshot(),
                    "device": device_stats(dev),
                }))
            elif msg.kind == "shutdown":
                sched.close()     # drains: zero dropped futures
                wire.send(ipc.Reply(msg.id, payload="bye"))
                break
            else:
                wire.send(ipc.Reply(msg.id, error=ValueError(
                    f"unknown request kind {msg.kind!r}")))
        except ipc.WireClosed:
            break
        except Exception as e:  # noqa: BLE001 - admission errors etc.
            try:
                wire.send(ipc.Reply(msg.id, error=e))
            except ipc.WireClosed:
                break
    stop.set()
    wire.close()


# ---------------------------------------------------------------------------
# The gateway.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Worker:
    id: int
    proc: multiprocessing.process.BaseProcess
    wire: Optional[ipc.Wire] = None
    version: int = 0
    serving: bool = False     # receives new queries + write fan-out
    alive: bool = True
    retiring: bool = False    # planned shutdown: EOF is not a death
    outstanding: int = 0      # requests sent, replies not yet received
    last_error: Optional[BaseException] = None


@dataclasses.dataclass
class _PendingMsg:
    worker_id: int
    kind: str
    future: Future
    ctx: object = None        # query: (SearchRequest, n_kmers)
    # the OPEN gateway-side dispatch span: closed ok by the receiver when
    # the worker replies, closed with error status by _on_worker_death —
    # this is how a kill -9 shows up in the trace instead of leaking
    span: Optional[obs_trace.Span] = None


class _FleetAck:
    """Resolves one ``Future[InsertAck]`` once every fanned-out copy of a
    write is acked — or its worker died (the write is journaled; the
    replacement replays it, so a death counts as covered)."""

    def __init__(self, future: Future, n_workers: int, ack: InsertAck):
        self.future = future
        self.ack = ack
        self._remaining = n_workers
        self._lock = threading.Lock()

    def _done(self) -> None:
        if self._remaining == 0 and not self.future.done():
            self.future.set_result(self.ack)

    def worker_acked(self) -> None:
        with self._lock:
            self._remaining -= 1
            self._done()

    def worker_lost(self) -> None:
        with self._lock:
            self._remaining -= 1
            self._done()

    def worker_error(self, e: BaseException) -> None:
        with self._lock:
            self._remaining -= 1
            if not self.future.done():
                self.future.set_exception(e)


class ProcessFabric:
    """N worker processes behind one gateway — ``submit`` / ``insert`` /
    ``compact`` with the same types and guarantees as the in-process
    router, but scaling with cores instead of the GIL."""

    def __init__(self, snapshot_dir: str,
                 config: Optional[FabricConfig] = None, *,
                 journal_path: Optional[str] = None,
                 base_version: int = 0):
        self.config = config or FabricConfig()
        # O(manifest): the gateway learns kmer size + bucket geometry
        # without ever paging the index in
        self._meta = store.read_meta(snapshot_dir)
        self._k = state_mod.kmer_size(self._meta)
        self._snapshot_dir = snapshot_dir
        self._version = int(base_version)
        self._journal = (lsm.DeltaJournal(journal_path)
                         if journal_path is not None else None)
        boot = self._journal.records() if self._journal is not None else []
        self._tail: List[lsm.JournalRecord] = list(boot)
        self._wal_seq = boot[-1].seq if boot else 0
        self._lock = threading.Lock()
        self._idle = threading.Condition(self._lock)
        self._admin_lock = threading.Lock()   # serializes restart/compact
        self._policy = RoutingPolicy(self.config.policy)
        self._pending: Dict[int, _PendingMsg] = {}
        self._mid = itertools.count()
        self._next_rid = itertools.count()
        self._next_wid = itertools.count()
        self._workers: List[_Worker] = []
        self._closed = False
        self._test_flags: dict = {}           # worker boot hooks (tests)
        self._ctx = multiprocessing.get_context("spawn")
        # AF_UNIX paths cap at ~107 bytes; a private mode-0700 dir in the
        # default tmp root stays short no matter where the caller runs
        self._rundir = tempfile.mkdtemp(prefix="idl-fabric-")
        self._socket_path = os.path.join(self._rundir, "gw.sock")
        self._listener = ipc.listen(self._socket_path)
        try:
            procs = [self._launch(snapshot_dir, self._version)
                     for _ in range(self.config.n_workers)]
            for w in self._hello_all(procs):
                self._finish_boot(w, snapshot_dir)
                with self._lock:
                    w.serving = True
        except Exception:
            self.close()
            raise

    # -- worker lifecycle ----------------------------------------------------
    def _launch(self, snapshot_dir: str, version: int) -> _Worker:
        wid = next(self._next_wid)
        with self._lock:
            start_seq = self._wal_seq
        proc = self._ctx.Process(
            target=worker_main,
            args=(wid, self._socket_path, snapshot_dir, version, start_seq,
                  self.config.service, self.config.scheduler,
                  self.config.verify, dict(self._test_flags),
                  self.config.device),
            daemon=True, name=f"idl-worker-{wid}")
        proc.start()
        w = _Worker(id=wid, proc=proc, version=version)
        with self._lock:
            self._workers.append(w)
        return w

    def _hello_all(self, procs: List[_Worker]) -> List[_Worker]:
        """Accept until every launched worker has said Hello (spawns run
        concurrently, so the fleet pays ONE interpreter boot, not N)."""
        pending = {w.id: w for w in procs}
        deadline = time.monotonic() + self.config.boot_timeout_s
        self._listener.settimeout(0.2)
        while pending:
            for w in pending.values():
                if not w.proc.is_alive():
                    self._abandon(list(pending.values()))
                    raise FabricError(
                        f"worker {w.id} died during boot "
                        f"(exit code {w.proc.exitcode})")
            if time.monotonic() > deadline:
                self._abandon(list(pending.values()))
                raise FabricError(
                    f"worker boot timed out after "
                    f"{self.config.boot_timeout_s}s")
            try:
                conn, _ = self._listener.accept()
            except socket.timeout:
                continue
            wire = ipc.Wire(conn)
            hello = wire.recv()
            w = pending.pop(hello.worker_id)
            w.wire = wire
        return procs

    def _finish_boot(self, w: _Worker, snapshot_dir: str) -> None:
        """Replay the journal tail into a Hello'd worker, await ready,
        start its receiver, and catch it up on writes that landed while
        it booted. The caller flips ``serving`` when it wants traffic."""
        with self._lock:
            tail0 = tuple(self._tail)
            seq0 = self._wal_seq
        w.wire.send(ipc.Request(next(self._mid), "replay", tail0))
        try:
            ready = w.wire.recv()          # blocks through load + replay
        except ipc.WireClosed as e:
            raise FabricError(
                f"worker {w.id} died while booting from "
                f"{snapshot_dir!r}") from e
        if ready.error is not None:
            raise FabricError(
                f"worker {w.id} failed to boot from {snapshot_dir!r}: "
                f"{ready.error!r}")
        threading.Thread(target=self._receiver_loop, args=(w,),
                         daemon=True, name=f"idl-gw-recv-{w.id}").start()
        with self._lock:
            # writes that landed after the tail snapshot fan to the
            # worker as ordinary inserts — through its scheduler, on its
            # flusher thread, exactly like live traffic (a raw replay
            # would race the single-writer delta)
            for rec in [r for r in self._tail if r.seq > seq0]:
                self._send_insert_locked(
                    w, rec.seq, rec.reads, rec.file_ids, fleet=None)

    def _abandon(self, workers: List[_Worker]) -> None:
        for w in workers:
            w.retiring = True
            if w.proc.is_alive():
                w.proc.terminate()
            if w.wire is not None:
                w.wire.close()
            w.alive = False
        with self._lock:
            self._workers = [x for x in self._workers if x.alive]

    def _receiver_loop(self, w: _Worker) -> None:
        while True:
            try:
                msg = w.wire.recv()
            except Exception:  # noqa: BLE001 - any wire failure is death
                self._on_worker_death(w)
                return
            if msg.id == -1:              # unsolicited fatal worker error
                w.last_error = msg.error  # (e.g. background verify); the
                continue                  # process exit follows as EOF
            with self._lock:
                entry = self._pending.pop(msg.id, None)
                if entry is not None:
                    w.outstanding -= 1
                self._idle.notify_all()
            if entry is None:
                continue
            if entry.span is not None:
                entry.span.end(
                    status="ok" if msg.error is None else "error")
            if entry.kind == "insert":
                fleet = entry.ctx
                if fleet is None:
                    pass                  # boot catch-up: fire and forget
                elif msg.error is not None:
                    fleet.worker_error(msg.error)
                else:
                    fleet.worker_acked()
            elif msg.error is not None:
                entry.future.set_exception(msg.error)
            else:
                entry.future.set_result(msg.payload)

    def _on_worker_death(self, w: _Worker) -> None:
        with self._lock:
            if not w.alive:
                return
            w.alive = False
            w.serving = False
            was_planned = w.retiring
            orphaned = [(mid, p) for mid, p in self._pending.items()
                        if p.worker_id == w.id]
            for mid, _ in orphaned:
                del self._pending[mid]
            w.outstanding = 0
            self._idle.notify_all()
        try:
            w.wire.close()
        except Exception:  # noqa: BLE001 - already dead
            pass
        if not w.proc.is_alive():
            w.proc.join(timeout=1)        # reap, don't leave a zombie
        if was_planned:
            # a retiring worker's EOF is expected — resolve anything still
            # pending (its shutdown ack) instead of stranding the caller
            for _, p in orphaned:
                if p.span is not None:
                    p.span.end(status="ok", retired=True)
                if not p.future.done():
                    p.future.set_result(None)
            return
        # orphaned dispatch spans close with ERROR status — the worker
        # died (crash / kill -9) with this work in flight, and the trace
        # must say so instead of leaking an open span
        for _, p in orphaned:
            if p.span is not None:
                p.span.end(status="error",
                           error=f"worker {w.id} died")
        # re-route: the dead worker never replied, so every orphaned
        # query is safe to re-dispatch; orphaned inserts are journaled —
        # the replacement worker replays them, which is the ack contract
        for _, p in orphaned:
            if p.kind == "query":
                req, n_kmers = p.ctx
                trace = (None if p.span is None
                         else (p.span.trace_id, p.span.parent_id))
                try:
                    self._dispatch(req, n_kmers, p.future, trace=trace)
                except FabricError as e:
                    p.future.set_exception(WorkerLost(
                        f"worker {w.id} died and no survivor could take "
                        f"request {req.request_id}: {e}"))
            elif p.kind == "insert":
                if p.ctx is not None:
                    p.ctx.worker_lost()
            else:
                p.future.set_exception(WorkerLost(
                    f"worker {w.id} died before answering a {p.kind!r} "
                    f"request"))

    # -- views ---------------------------------------------------------------
    @property
    def version(self) -> int:
        with self._lock:
            return self._version

    @property
    def wal_seq(self) -> int:
        with self._lock:
            return self._wal_seq

    @property
    def n_workers(self) -> int:
        with self._lock:
            return sum(1 for w in self._workers if w.alive and w.serving)

    def worker_pids(self) -> Dict[int, int]:
        """Live workers' OS pids (fault-injection hooks for tests)."""
        with self._lock:
            return {w.id: w.proc.pid for w in self._workers if w.alive}

    def stats(self) -> Dict[int, dict]:
        """Per-worker serving stats, gathered over the wire."""
        futures: List[Tuple[int, Future]] = []
        with self._lock:
            for w in self._workers:
                if not (w.alive and w.serving):
                    continue
                fut: Future = Future()
                mid = next(self._mid)
                self._pending[mid] = _PendingMsg(w.id, "stats", fut)
                w.outstanding += 1
                futures.append((w.id, fut))
                try:
                    w.wire.send(ipc.Request(mid, "stats"))
                except ipc.WireClosed:
                    pass          # death lands via the receiver thread
        out = {}
        for wid, fut in futures:
            try:
                out[wid] = fut.result(timeout=30)
            except Exception:  # noqa: BLE001 - died mid-gather: skip it
                pass
        return out

    def requests_served(self) -> int:
        return sum(s["requests_served"] for s in self.stats().values())

    def obs_snapshot(self) -> dict:
        """Fleet obs view: the gateway's own process snapshot merged with
        every serving worker's (each worker ships its full obs state on
        the ``stats`` reply). The span concatenation in the merge is
        where gateway dispatch spans and worker pipeline spans stitch
        into one tree per trace id."""
        per = self.stats()
        return obs_export.merge(
            [obs_export.snapshot()]
            + [s["obs"] for s in per.values()
               if isinstance(s, dict) and s.get("obs")])

    def cache_stats(self) -> Optional[dict]:
        """Fleet-wide kmer-cache view, derived from the merged registry
        snapshot (None = caches off everywhere) — same shape the
        per-worker ``KmerCache.stats()`` merge used to produce."""
        snap = self.obs_snapshot()
        if "kmer_cache.capacity" not in snap["metrics"].get("gauges", {}):
            return None
        return obs_export.cache_stats_view(snap)

    # -- admission -----------------------------------------------------------
    def _dispatch(self, req: service_mod.SearchRequest, n_kmers: int,
                  fut: Future, *,
                  trace: Optional[obs_trace.TraceContext] = None) -> None:
        bucket = service_mod.bucket_for(
            n_kmers, self.config.service.min_bucket_kmers)
        trc = obs_trace.DEFAULT
        with self._lock:
            if self._closed:
                raise FabricError("fabric is closed")
            serving = [w for w in self._workers if w.serving and w.alive]
            if not serving:
                raise FabricError("fabric has no serving workers")
            w = self._policy.pick(serving, bucket,
                                  lambda x: x.outstanding)
            # an OPEN span per dispatch: the worker's spans parent under
            # it via the wire's trace context; the receiver closes it ok,
            # a worker death closes it with error status
            span = (trc.start("worker_exec", trace=trace, worker=w.id,
                              rid=req.request_id)
                    if trc.enabled and trace is not None else None)
            mid = next(self._mid)
            self._pending[mid] = _PendingMsg(
                w.id, "query", fut, (req, n_kmers), span=span)
            w.outstanding += 1
        try:
            w.wire.send(ipc.Request(
                mid, "query", (req.request_id, req.read),
                trace=None if span is None else span.context()))
        except ipc.WireClosed:
            self._on_worker_death(w)      # re-routes this very request

    def submit(self, request) -> Future:
        """Route one read to a worker; returns a Future[SearchResult].

        Admission mints the trace id HERE: the gateway's root span covers
        the whole request lifetime (closed when the future resolves), the
        per-dispatch ``worker_exec`` child rides the wire, and the
        worker's pipeline spans stitch under it — one trace id across
        processes.
        """
        req, n_kmers = service_mod.normalize_request(request, self._k)
        rid = req.request_id
        if rid is None:
            rid = next(self._next_rid)
        req = service_mod.SearchRequest(read=req.read, request_id=rid)
        fut: Future = Future()
        trc = obs_trace.DEFAULT
        ctx = None
        if trc.enabled:
            root = trc.start("request", tier="gateway", rid=rid)
            ctx = root.context()
            fut.add_done_callback(lambda f: root.end(
                status="error" if (f.cancelled() or f.exception())
                else "ok"))
        self._dispatch(req, n_kmers, fut, trace=ctx)
        return fut

    def search(self, reads) -> List[service_mod.SearchResult]:
        """Synchronous convenience: submit all, results in order."""
        return [f.result() for f in [self.submit(r) for r in reads]]

    # -- the write path ------------------------------------------------------
    def _send_insert_locked(self, w: _Worker, seq: int, reads, fids,
                            fleet: Optional[_FleetAck], *,
                            trace: Optional[obs_trace.TraceContext] = None
                            ) -> List[_Worker]:
        """Register + send one insert to one worker (caller holds the
        lock — sends stay inside it so every worker sees one total write
        order). Returns the workers whose wires died (death handling
        needs the lock, so the caller runs it after releasing)."""
        trc = obs_trace.DEFAULT
        span = (trc.start("worker_insert", trace=trace, worker=w.id,
                          seq=seq)
                if trc.enabled and trace is not None else None)
        mid = next(self._mid)
        self._pending[mid] = _PendingMsg(w.id, "insert", Future(), fleet,
                                         span=span)
        w.outstanding += 1
        try:
            w.wire.send(ipc.Request(
                mid, "insert", (seq, reads, fids),
                trace=None if span is None else span.context()))
            return []
        except ipc.WireClosed:
            return [w]

    def insert(self, reads, file_ids=None) -> Future:
        """Journal one write batch, fan it to every serving worker.

        Returns ONE ``Future[InsertAck]`` that resolves when the write is
        searchable fleet-wide (every serving worker acked — or died,
        which the journal covers: the replacement replays the record).
        The gateway lock spans journal append + fan-out, so concurrent
        inserts reach every worker in one total order and per-worker
        ``delta_seq`` watermarks never stamp a write the worker has not
        actually absorbed.
        """
        reads = np.asarray(reads, dtype=np.uint8)
        if reads.ndim == 1:
            reads = reads[None]
        fids = (None if file_ids is None
                else np.asarray(file_ids, dtype=np.int32).reshape(-1))
        fut: Future = Future()
        dead: List[_Worker] = []
        trc = obs_trace.DEFAULT
        root = (trc.start("insert", tier="gateway", n_reads=len(reads))
                if trc.enabled else None)
        ctx = root.context() if root is not None else None
        if root is not None:
            fut.add_done_callback(lambda f: root.end(
                status="error" if (f.cancelled() or f.exception())
                else "ok"))
        with self._lock:
            if self._closed:
                raise FabricError("fabric is closed")
            serving = [w for w in self._workers if w.serving and w.alive]
            if not serving:
                raise FabricError("fabric has no serving workers")
            seq = self._wal_seq + 1
            t_j = time.monotonic()
            if self._journal is not None:
                self._journal.append(seq, reads, fids)
            if ctx is not None:
                trc.emit("journal_append", ctx[0], ctx[1], t_j,
                         time.monotonic(),
                         attrs={"seq": seq,
                                "durable": self._journal is not None})
            self._wal_seq = seq
            self._tail.append(lsm.JournalRecord(
                seq=seq, reads=reads, file_ids=fids))
            fleet = _FleetAck(fut, len(serving), InsertAck(
                base_version=self._version, delta_seq=seq,
                n_reads=int(reads.shape[0])))
            t_f = time.monotonic()
            for w in serving:
                dead.extend(self._send_insert_locked(
                    w, seq, reads, fids, fleet, trace=ctx))
            if ctx is not None:
                trc.emit("fanout", ctx[0], ctx[1], t_f, time.monotonic(),
                         attrs={"seq": seq, "n_workers": len(serving)})
        for w in dead:
            self._on_worker_death(w)
        return fut

    # -- rolling restart + compaction ---------------------------------------
    def _boot_replacement(self, snapshot_dir: str, version: int) -> _Worker:
        w = self._launch(snapshot_dir, version)
        self._hello_all([w])
        self._finish_boot(w, snapshot_dir)
        return w

    def _drain_worker(self, w: _Worker) -> None:
        with self._idle:
            while any(p.worker_id == w.id for p in self._pending.values()):
                self._idle.wait(timeout=1.0)

    def _shutdown_worker(self, w: _Worker) -> None:
        w.retiring = True
        fut: Future = Future()
        with self._lock:
            mid = next(self._mid)
            self._pending[mid] = _PendingMsg(w.id, "shutdown", fut)
            w.outstanding += 1
        try:
            w.wire.send(ipc.Request(mid, "shutdown"))
            fut.result(timeout=60)
        except Exception:  # noqa: BLE001 - escalate to terminate below
            with self._lock:
                if self._pending.pop(mid, None) is not None:
                    w.outstanding -= 1
                self._idle.notify_all()
        w.proc.join(timeout=10)
        if w.proc.is_alive():
            w.proc.terminate()
            w.proc.join(timeout=10)
        with self._lock:
            w.alive = False
            self._workers = [x for x in self._workers if x is not w]

    def _swap_one(self, old: _Worker, replacement: _Worker) -> None:
        """Replacement-first swap: traffic shifts, the old worker drains
        its in-flight replies, then shuts down — zero dropped requests."""
        with self._lock:
            replacement.serving = True
            old.serving = False
        self._drain_worker(old)
        self._shutdown_worker(old)

    def rolling_restart(self, snapshot_dir: Optional[str] = None, *,
                        version: Optional[int] = None) -> int:
        """Swap every worker onto ``snapshot_dir``, one at a time.

        The fleet version only advances when EVERY worker swapped. If a
        replacement fails to boot, the rollout aborts, already-swapped
        workers roll BACK onto the old snapshot, and the fleet keeps
        serving the old version — never a mixed fleet.
        """
        with self._admin_lock:
            target = snapshot_dir or self._snapshot_dir
            with self._lock:
                old_dir, old_version = self._snapshot_dir, self._version
                new_version = (old_version + 1 if version is None
                               else int(version))
                targets = [w for w in self._workers
                           if w.alive and w.serving]
            swapped: List[_Worker] = []
            for old in targets:
                try:
                    replacement = self._boot_replacement(target, new_version)
                except FabricError as e:
                    for s in swapped:     # back out: fleet stays on OLD
                        rb = self._boot_replacement(old_dir, old_version)
                        self._swap_one(s, rb)
                    raise FabricError(
                        f"rolling restart onto {target!r} aborted "
                        f"(fleet still serving version {old_version}): "
                        f"{e}") from e
                self._swap_one(old, replacement)
                swapped.append(replacement)
            with self._lock:
                self._snapshot_dir = target
                self._version = new_version
            return new_version

    def compact(self, save_dir: str) -> int:
        """Fold the fleet's delta into its base and roll onto the result.

        The lead worker freezes a plan, merges OFF the hot path and
        writes the merged snapshot; the fleet then rolling-restarts onto
        it (queries keep flowing throughout) and the journal truncates
        through the fold watermark — the merged snapshot is the durable
        copy now. Returns the new fleet version.
        """
        fut: Future = Future()
        with self._admin_lock:
            with self._lock:
                serving = [w for w in self._workers
                           if w.serving and w.alive]
                if not serving:
                    raise FabricError("fabric has no serving workers")
                lead = serving[0]
                mid = next(self._mid)
                self._pending[mid] = _PendingMsg(lead.id, "compact", fut)
                lead.outstanding += 1
                try:
                    lead.wire.send(ipc.Request(mid, "compact", save_dir))
                except ipc.WireClosed:
                    pass          # surfaces as WorkerLost on the future
            upto_seq = fut.result(timeout=600)
            with self._lock:
                # replacements must not re-apply folded writes: trim the
                # tail BEFORE the roll (re-applying is idempotent but the
                # smaller replay is the point of compaction)
                self._tail = [r for r in self._tail if r.seq > upto_seq]
        new_version = self.rolling_restart(save_dir)
        if self._journal is not None:
            self._journal.truncate_through(upto_seq)
        return new_version

    # -- lifecycle -----------------------------------------------------------
    def drain(self) -> None:
        """Block until every in-flight request has its reply."""
        with self._idle:
            while self._pending:
                self._idle.wait(timeout=1.0)

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            workers = [w for w in self._workers if w.alive]
        for w in workers:
            if w.wire is not None:
                self._shutdown_worker(w)
            else:
                w.retiring = True
                w.proc.terminate()
                w.proc.join(timeout=10)
        self._listener.close()
        if self._journal is not None:
            self._journal.close()
        try:
            os.unlink(self._socket_path)
            os.rmdir(self._rundir)
        except OSError:
            pass

    def __enter__(self) -> "ProcessFabric":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
