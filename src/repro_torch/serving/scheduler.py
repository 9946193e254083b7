"""Async event-loop serving: futures, flush deadlines, pipelined batches.

Port of :mod:`repro.serving.scheduler`. The synchronous
:class:`~repro_torch.serving.service.GeneSearchService` runs
``submit → flush → result`` on one thread; this module gives it an event
loop:

* **Futures** — :meth:`AsyncScheduler.submit` returns a
  ``concurrent.futures.Future[SearchResult]`` immediately.

* **Deadline flusher** — a background thread launches a bucket's batch
  when it is *full* (``target_batch`` requests waiting — the knob an
  :class:`~repro_torch.serving.autoscale.AdmissionPolicy` can move) or
  when its oldest request has waited ``max_delay_ms``.

* **Pipelined batches** — the flusher runs the host half of a batch
  (padding, thresholds, the probe's hashing and device plan) and enqueues
  the device work, which returns a tensor on the state's device without
  waiting for it; a completer thread copies the verdicts to the host
  (``_finalize``'s ``.cpu()``, the only wait), decodes them and resolves
  the futures. The bounded hand-off queue (``pipeline_depth``) lets that
  many batches be in flight: host work for batch N+1 overlaps the device
  work of batch N. Every launch stays on the device's default stream.

* **Writes** — :meth:`AsyncScheduler.submit_insert` admits a write batch
  to a live service; the flusher applies writes between query batches, in
  bounded bursts, on the same thread as every query dispatch.

All stages call the same ``_assemble`` / ``_execute`` / ``_finalize``
methods as the synchronous ``flush()``, so scheduler answers equal direct
service answers by construction. An exception on either thread reaches
the futures of its batch (``_fail_batch``); none is dropped. Telemetry is
a bounded deque of :class:`ClusterStats` records.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import queue as queue_mod
import threading
import time
from concurrent.futures import Future
from typing import Deque, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.serving import service as service_mod
from repro_torch.serving.autoscale import AdmissionPolicy

# unique per-scheduler label (replica ids repeat across independent
# schedulers in one process; the registry series must not)
_SCHED_IDS = itertools.count()

__all__ = [
    "SchedulerConfig",
    "ClusterStats",
    "AsyncScheduler",
    "InsertAck",
    "FLUSH_FULL",
    "FLUSH_DEADLINE",
    "FLUSH_DRAIN",
]

FLUSH_FULL = "full"          # target_batch requests were waiting
FLUSH_DEADLINE = "deadline"  # oldest request hit max_delay_ms
FLUSH_DRAIN = "drain"        # explicit drain()/close()

# writes are preferred over queries, but in bounded bursts: at most this
# many pending writes apply per burst, and an overdue query bucket gets a
# flush between bursts (a sustained insert stream cannot starve queries)
_WRITE_BURST = 64


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """Event-loop knobs (static; the AdmissionPolicy moves within them)."""

    max_delay_ms: float = 2.0    # flush deadline for a bucket's oldest req
    pipeline_depth: int = 2      # dispatched-but-unmaterialized batches
    stats_window: int = 4096     # ClusterStats records kept (bounded)

    def __post_init__(self):
        if self.max_delay_ms < 0:
            raise ValueError("max_delay_ms must be >= 0")
        if self.pipeline_depth < 1:
            raise ValueError("pipeline_depth must be >= 1")


@dataclasses.dataclass(frozen=True)
class ClusterStats:
    """Accounting for one batch executed through the event loop.

    Extends the service's ``BatchStats`` view with the cluster-level
    fields the autoscaler consumes: which replica ran it, which state
    version answered, why the batch flushed, and how long its oldest
    request queued before dispatch.
    """

    replica: int         # router replica id (0 for a lone scheduler)
    version: int         # IndexState version that served the batch
    bucket: int          # kmer bucket
    n_requests: int      # real requests in the batch
    batch_rows: int      # fixed physical batch shape (= max_batch)
    flush_reason: str    # FLUSH_FULL | FLUSH_DEADLINE | FLUSH_DRAIN
    queue_ms: float      # oldest request's wait before dispatch
    wall_ms: float       # dispatch -> results materialized
    cache_hits: int = 0      # kmer-cache hits THIS batch (0 = cache off)
    cache_lookups: int = 0   # kmer-cache lookups this batch

    @property
    def occupancy(self) -> float:
        return self.n_requests / max(self.batch_rows, 1)


@dataclasses.dataclass(frozen=True)
class InsertAck:
    """Acknowledgement of one admitted write batch: the state coordinates
    at which it became searchable (``SearchResult`` stamps the same pair,
    so read-your-writes is checkable: any result with ``delta_seq >=
    ack.delta_seq`` — or a later ``base_version`` — saw the write)."""

    base_version: int
    delta_seq: int
    n_reads: int


@dataclasses.dataclass
class _Pending:
    request: service_mod.SearchRequest
    n_kmers: int
    future: Future
    t_enq: float
    # (trace_id, parent_span_id) minted at admission — locally, or in the
    # gateway process when the request came over an IPC frame
    trace: Optional[Tuple[str, Optional[str]]] = None


@dataclasses.dataclass
class _PendingWrite:
    reads: np.ndarray
    file_ids: Optional[np.ndarray]
    future: Future
    t_enq: float
    seq: Optional[int] = None    # router-assigned fleet sequence number
    trace: Optional[Tuple[str, Optional[str]]] = None


class AsyncScheduler:
    """Futures + deadline flusher + pipelined execution over one service.

    Takes ownership of the wrapped :class:`GeneSearchService`: while the
    scheduler is live, do not call ``submit``/``flush`` on the service
    directly (the scheduler keeps its own queues and drives the service's
    flush pipeline stages from its worker threads).
    """

    def __init__(self, service: service_mod.GeneSearchService,
                 config: Optional[SchedulerConfig] = None, *,
                 admission: Optional[AdmissionPolicy] = None,
                 on_batch=None, replica_id: int = 0):
        self._svc = service
        self.config = config or SchedulerConfig()
        self.admission = admission
        self._on_batch = on_batch    # cluster hook: fn(ClusterStats, now)
        self.replica_id = replica_id
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)    # flusher wakeups
        self._idle = threading.Condition(self._lock)    # drain/pause waits
        self._queues: Dict[int, Deque[_Pending]] = {}
        self._writes: Deque[_PendingWrite] = collections.deque()
        self._inflight_ids: set = set()
        self._next_id = 0
        self._outstanding = 0        # submitted, future not yet resolved
        self._inflight = 0           # batches dispatched, not finalized
        self._paused = False
        self._draining = False
        self._closed = False
        self._wrote_last = False     # last flush was a write burst
                                     # (alternation vs overdue queries)
        self.stats: Deque[ClusterStats] = collections.deque(
            maxlen=self.config.stats_window)
        labels = {"tier": "scheduler", "replica": replica_id,
                  "sched": next(_SCHED_IDS)}
        reg = obs_metrics.DEFAULT
        self._obs_flushes = {
            reason: reg.counter("scheduler.flushes", reason=reason,
                                **labels)
            for reason in (FLUSH_FULL, FLUSH_DEADLINE, FLUSH_DRAIN)}
        self._obs_queue_ms = reg.histogram("scheduler.queue_ms", **labels)
        self._obs_wall_ms = reg.histogram("scheduler.wall_ms", **labels)
        self._obs_writes = reg.counter("scheduler.write_batches", **labels)
        self._obs_write_reads = reg.counter("scheduler.write_reads",
                                            **labels)
        # the double buffer: flusher blocks here once `pipeline_depth`
        # batches are dispatched but not yet materialized
        self._handoff: queue_mod.Queue = queue_mod.Queue(
            maxsize=self.config.pipeline_depth)
        self._flusher = threading.Thread(
            target=self._flusher_loop, daemon=True,
            name=f"idl-flusher-{replica_id}")
        self._completer = threading.Thread(
            target=self._completer_loop, daemon=True,
            name=f"idl-completer-{replica_id}")
        self._flusher.start()
        self._completer.start()

    # -- delegated views ----------------------------------------------------
    @property
    def service(self) -> service_mod.GeneSearchService:
        return self._svc

    @property
    def outstanding(self) -> int:
        """Requests whose futures have not resolved yet (queued or in a
        dispatched batch) — the router's least-outstanding signal."""
        with self._lock:
            return self._outstanding

    def compile_counts(self) -> Dict[int, int]:
        return self._svc.compile_counts()

    def cache_stats(self):
        """The wrapped service's ``KmerCache.stats()`` (None = cache off)."""
        return self._svc.cache_stats()

    # -- admission ----------------------------------------------------------
    def submit(self, request: Union[service_mod.SearchRequest, np.ndarray],
               *, trace: Optional[Tuple[str, Optional[str]]] = None
               ) -> Future:
        """Enqueue one read; returns a Future resolving to SearchResult.

        ``trace`` parents this request's spans under an admission span
        minted elsewhere (the fabric gateway / scatter router); None
        mints a fresh trace id here.
        """
        req, n_kmers = self._svc._normalize(request)
        return self._enqueue(req, n_kmers, trace=trace)

    def _enqueue(self, req: service_mod.SearchRequest, n_kmers: int, *,
                 trace: Optional[Tuple[str, Optional[str]]] = None
                 ) -> Future:
        """Admission for an already-normalized request (router fast path)."""
        bucket = self._svc.bucket_for(n_kmers)
        fut: Future = Future()
        now = time.monotonic()
        if trace is None and obs_trace.DEFAULT.enabled:
            trace = (obs_trace.DEFAULT.mint_trace(), None)
        with self._lock:
            if self._closed:
                raise RuntimeError("scheduler is closed")
            rid = req.request_id
            if rid is None:
                rid = self._next_id
            elif rid in self._inflight_ids:
                # same rule as the sync service: two live
                # results with one id would make caller-side keying and the
                # hot-swap audit trail ambiguous
                raise ValueError(
                    f"request id {rid} is already in flight")
            self._next_id = max(self._next_id, rid) + 1
            self._inflight_ids.add(rid)
            pending = _Pending(
                request=service_mod.SearchRequest(read=req.read,
                                                  request_id=rid),
                n_kmers=n_kmers, future=fut, t_enq=now, trace=trace)
            self._queues.setdefault(bucket, collections.deque()
                                    ).append(pending)
            self._outstanding += 1
            if self.admission is not None:
                self.admission.observe_arrival(bucket, now)
            self._work.notify_all()
        return fut

    def submit_insert(self, reads, file_ids=None, *,
                      seq: Optional[int] = None,
                      trace: Optional[Tuple[str, Optional[str]]] = None
                      ) -> Future:
        """Admit one write batch; returns a Future[InsertAck].

        Requires a live-index service (one exposing ``apply_insert`` —
        :class:`~repro_torch.serving.live.LiveGeneSearchService`); a static
        service raises immediately. ``seq`` threads a router-assigned
        fleet sequence number through to the live index so every
        replica's watermark is the fleet journal's (standalone callers
        leave it None and the index numbers locally). Writes are applied
        by the flusher thread *between* query batches, preferred over
        queued queries in bounded bursts (the insert-to-searchable
        latency knob; overdue queries still flush between bursts), and on
        the SAME thread as all query dispatch — which is exactly the
        single-dispatch-thread discipline the live index's in-place delta
        buffers require. Writes count toward ``outstanding`` (``drain``
        waits for them) and are gated by ``pause`` (the hot-swap /
        compaction-publish window).
        """
        if not hasattr(self._svc, "apply_insert"):
            raise TypeError(
                f"{type(self._svc).__name__} is not writable — wrap a "
                f"LiveIndex in a LiveGeneSearchService to serve a write "
                f"path (repro_torch.serving.live)")
        reads = np.asarray(reads, dtype=np.uint8)
        if reads.ndim == 1:
            reads = reads[None]
        fids = (None if file_ids is None
                else np.asarray(file_ids, dtype=np.int32).reshape(-1))
        fut: Future = Future()
        with self._lock:
            if self._closed:
                raise RuntimeError("scheduler is closed")
            if trace is None and obs_trace.DEFAULT.enabled:
                trace = (obs_trace.DEFAULT.mint_trace(), None)
            self._writes.append(_PendingWrite(
                reads=reads, file_ids=fids, future=fut,
                t_enq=time.monotonic(),
                seq=None if seq is None else int(seq), trace=trace))
            self._outstanding += 1
            self._work.notify_all()
        return fut

    def search(self, reads: Sequence[np.ndarray]
               ) -> List[service_mod.SearchResult]:
        """Synchronous convenience: submit all, drain, results in order."""
        futures = [self.submit(r) for r in reads]
        self.drain()
        return [f.result() for f in futures]

    # -- lifecycle ----------------------------------------------------------
    def drain(self) -> None:
        """Flush every queued request (deadlines ignored) and block until
        all futures are resolved. Zero futures are dropped: anything
        submitted before drain() returns has a result or an exception."""
        with self._lock:
            if self._paused:
                raise RuntimeError("cannot drain a paused scheduler")
            self._draining = True
            self._work.notify_all()
            while self._outstanding > 0:
                self._idle.wait()
            self._draining = False

    def pause(self) -> None:
        """Stop launching batches and wait for in-flight ones to finish.

        Queued requests stay queued (their futures stay pending) — this is
        the hot-swap window: with zero batches in flight, the service's
        state can be swapped and every already-dispatched result is
        guaranteed to carry the version that actually computed it.
        """
        with self._lock:
            self._paused = True
            while self._inflight > 0:
                self._idle.wait()

    def resume(self) -> None:
        with self._lock:
            self._paused = False
            self._work.notify_all()

    def close(self) -> None:
        """Drain, then stop both worker threads. Idempotent."""
        with self._lock:
            if self._closed:
                return
            if self._paused:
                self._paused = False
                self._work.notify_all()
        self.drain()
        with self._lock:
            self._closed = True
            self._work.notify_all()
        self._handoff.put(None)                 # completer sentinel
        self._flusher.join(timeout=10)
        self._completer.join(timeout=10)

    def __enter__(self) -> "AsyncScheduler":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- the event loop -----------------------------------------------------
    def _knobs(self, bucket: int, now: float) -> Tuple[int, float]:
        """(target_batch, deadline_s) — adaptive when admission is set."""
        max_batch = self._svc.config.max_batch
        if self.admission is None:
            return max_batch, self.config.max_delay_ms * 1e-3
        return (self.admission.target_batch(bucket, now, max_batch),
                self.admission.deadline_ms(bucket, now, max_batch) * 1e-3)

    def _pick(self, now: float):
        """Choose the next bucket to flush (caller holds the lock).

        Overdue buckets win over full ones: a sustained hot bucket must
        not starve a lone request on a quiet bucket past its deadline
        (the most-overdue bucket flushes first; full buckets flush
        whenever nothing is overdue, which is the common case).
        """
        if self._paused:
            return None
        best_overdue = None
        full = None
        for bucket, q in self._queues.items():
            if not q:
                continue
            if self._draining:
                return bucket, FLUSH_DRAIN
            target, deadline_s = self._knobs(bucket, now)
            overdue = (now - q[0].t_enq) - deadline_s
            if overdue >= 0 and (best_overdue is None
                                 or overdue > best_overdue[1]):
                best_overdue = (bucket, overdue)
            elif full is None and len(q) >= target:
                full = bucket
        if best_overdue is not None:
            return best_overdue[0], FLUSH_DEADLINE
        return (full, FLUSH_FULL) if full is not None else None

    def _next_timeout(self, now: float) -> Optional[float]:
        """Seconds until the earliest bucket deadline (None = no queue)."""
        timeout = None
        for bucket, q in self._queues.items():
            if not q:
                continue
            _, deadline_s = self._knobs(bucket, now)
            remain = max(q[0].t_enq + deadline_s - now, 0.0)
            timeout = remain if timeout is None else min(timeout, remain)
        return timeout

    def _apply_writes(self, writes: List[_PendingWrite]) -> None:
        """Apply a write burst (flusher thread, outside the lock)."""
        trc = obs_trace.DEFAULT
        for w in writes:
            t0 = time.monotonic()
            try:
                version, seq = self._svc.apply_insert(
                    w.reads, w.file_ids, seq=w.seq)
                w.future.set_result(InsertAck(
                    base_version=version, delta_seq=seq,
                    n_reads=int(w.reads.shape[0])))
                status = "ok"
            except Exception as e:  # noqa: BLE001 - forward to futures
                if not w.future.done():
                    w.future.set_exception(e)
                status = "error"
            if w.trace is not None and trc.enabled:
                trc.emit("replica_apply", w.trace[0], w.trace[1],
                         t0, time.monotonic(), status=status,
                         attrs={"replica": self.replica_id,
                                "n_reads": int(w.reads.shape[0]),
                                "queue_ms": (t0 - w.t_enq) * 1e3})
        self._obs_writes.inc(len(writes))
        self._obs_write_reads.inc(sum(int(w.reads.shape[0])
                                      for w in writes))
        with self._lock:
            self._inflight -= 1
            self._outstanding -= len(writes)
            self._idle.notify_all()

    def _flusher_loop(self) -> None:
        while True:
            with self._lock:
                writes: List[_PendingWrite] = []
                while True:
                    if self._closed:
                        # zero dropped futures, even on a racy late submit:
                        # anything still queued fails loudly instead of
                        # hanging its caller forever
                        err = RuntimeError("scheduler closed")
                        for q in self._queues.values():
                            while q:
                                q.popleft().future.set_exception(err)
                        while self._writes:
                            self._writes.popleft().future.set_exception(err)
                        return
                    now = time.monotonic()
                    pick = self._pick(now)
                    # writes beat queries: an admitted insert becomes
                    # searchable before the next query batch dispatches —
                    # THE insert-to-searchable latency lever. The
                    # preference is BOUNDED: bursts cap
                    # at _WRITE_BURST and a deadline-overdue (or draining)
                    # bucket flushes between consecutive bursts, so a
                    # sustained insert stream cannot starve queries past
                    # their deadlines. Gated by pause like query batches.
                    overdue = pick is not None and pick[1] != FLUSH_FULL
                    if self._writes and not self._paused and \
                            not (overdue and self._wrote_last):
                        while self._writes and len(writes) < _WRITE_BURST:
                            writes.append(self._writes.popleft())
                        self._inflight += 1      # pause() waits for a burst
                        self._wrote_last = True
                        break
                    if pick is not None:
                        self._wrote_last = False
                        break
                    self._work.wait(
                        timeout=None if self._paused
                        else self._next_timeout(now))
                if writes:
                    take = None
                else:
                    bucket, reason = pick
                    q = self._queues[bucket]
                    take = [q.popleft() for _ in
                            range(min(len(q), self._svc.config.max_batch))]
                    self._inflight += 1
            if writes:
                self._apply_writes(writes)
                continue
            # host + dispatch, outside the lock: assemble the padded batch,
            # plan on the device and enqueue the device work; the completer
            # owns the one blocking wait (its .cpu())
            try:
                pairs = [(p.request, p.n_kmers) for p in take]
                t0 = time.monotonic()
                # kmer-cache counters only move on this (dispatch) thread,
                # so a before/after snapshot is exactly THIS batch's traffic
                cache = self._svc.kmer_cache
                h0, l0 = ((cache.hits, cache.lookups)
                          if cache is not None else (0, 0))
                batch_args = self._svc._assemble(pairs, bucket)
                t_asm = time.monotonic()
                out = self._svc._execute(bucket, *batch_args)
                t_exec = time.monotonic()
                dh, dl = ((cache.hits - h0, cache.lookups - l0)
                          if cache is not None else (0, 0))
                self._handoff.put((bucket, take, out, reason, t0, t_asm,
                                   t_exec, dh, dl))
            except Exception as e:  # noqa: BLE001 - forward to futures
                self._fail_batch(take, e)

    def _completer_loop(self) -> None:
        while True:
            item = self._handoff.get()
            if item is None:
                return
            take = item[1]
            try:
                results = self._complete(*item)
            except Exception as e:  # noqa: BLE001 - forward to futures
                self._fail_batch(take, e)
                continue
            for p, res in zip(take, results):
                p.future.set_result(res)
            self._batch_done(take)

    def _complete(self, bucket, take, out, reason, t0, t_asm, t_exec,
                  cache_hits, cache_lookups):
        """Materialize and decode one dispatched batch and record its
        telemetry (completer thread); returns its results. Any failure
        here, bookkeeping included, fails the batch's futures."""
        pairs = [(p.request, p.n_kmers) for p in take]
        svc = self._svc
        svc._t_copied = t_exec
        results = svc._finalize(pairs, bucket, out)
        now = time.monotonic()
        t_fill = min(p.t_enq for p in take)     # the batch's queueing
        svc._record_stages(t_fill, t0, t_exec, now)
        wall_ms = (now - t0) * 1e3
        rows = svc.config.max_batch
        version = results[0].version if results else svc.version
        stats = ClusterStats(
            replica=self.replica_id, version=version,
            bucket=bucket, n_requests=len(take), batch_rows=rows,
            flush_reason=reason,
            queue_ms=(t0 - t_fill) * 1e3,
            wall_ms=wall_ms,
            cache_hits=cache_hits, cache_lookups=cache_lookups)
        self.stats.append(stats)
        self._obs_flushes[reason].inc()
        self._obs_queue_ms.observe(stats.queue_ms)
        self._obs_wall_ms.observe(wall_ms)
        svc._record_batch(service_mod.BatchStats(
            bucket=bucket, n_requests=len(take), batch_rows=rows,
            pad_rows=rows - len(take),
            pad_kmers=rows * bucket - sum(p.n_kmers for p in take),
            wall_ms=wall_ms))
        service_mod.emit_request_spans(
            [(p.trace, p.t_enq, p.request.request_id) for p in take],
            bucket=bucket, t0=t0, t_asm=t_asm, t_exec=t_exec,
            t_done=now, replica=self.replica_id, version=version)
        svc._stages.lap("obs", now)
        if self.admission is not None:
            self.admission.observe_batch(stats, now)
        if self._on_batch is not None:
            self._on_batch(stats, now)
        return results

    def _fail_batch(self, take: List[_Pending], exc: Exception) -> None:
        for p in take:
            if not p.future.done():
                p.future.set_exception(exc)
        self._batch_done(take)

    def _batch_done(self, take: List[_Pending]) -> None:
        with self._lock:
            self._inflight -= 1
            self._outstanding -= len(take)
            for p in take:
                self._inflight_ids.discard(p.request.request_id)
            self._idle.notify_all()
