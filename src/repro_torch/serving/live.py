"""Ingest-while-serving: the live index behind the serving cluster.

Port of :mod:`repro.serving.live`. Three pieces close the loop between
:mod:`repro_torch.index.lsm` and the serving stack:

* :class:`LiveGeneSearchService` — a :class:`GeneSearchService` whose step
  probes **base and delta** and ORs the per-kmer membership before the
  coverage threshold, so every answer equals a single index holding the
  union of all inserts. Adds ``apply_insert`` (the write the scheduler's
  admission path calls) and ``publish`` (the compaction swap). Results
  carry ``(version, delta_seq)``. With the membership cache on, a front
  cache holds merged rows keyed ``(version, delta_seq)`` and a base-row
  cache keyed by ``version`` survives writes (see
  :mod:`repro_torch.serving.kmer_cache`).

* :class:`LiveReplicaRouter` — a :class:`ReplicaRouter` whose replicas
  each hold a :class:`LiveIndex` over one shared base (per device).
  Writes fan out to every replica in one total order, queries route to
  one replica, and :meth:`LiveReplicaRouter.compact` folds delta into
  base fleet-wide: the merge computes once, then publishes replica by
  replica (the same merged base shared by every replica on a device)
  through the pause → swap → resume window.

* :class:`Compactor` — a background thread that watches a live target's
  ``delta_batches()`` and triggers ``compact()`` past a threshold.

Mid-compaction exactness: the compaction plan freezes (base, a copy of
the delta, watermark ``S``) under the write lock; queries keep merging the
live pair while the merge computes; at publish, writes with seq > ``S``
replay into the fresh delta. Every fanned write carries its fleet
sequence number, so a replica that had not yet applied some write ≤ ``S``
when it published no-ops the late delivery.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from typing import List, Optional

import numpy as np
import torch

from repro_torch.index import lsm, store
from repro_torch.index import state as state_mod
from repro_torch.obs import trace as obs_trace
from repro_torch.serving import kmer_cache as kmer_cache_mod
from repro_torch.serving import router as router_mod
from repro_torch.serving import service as service_mod

__all__ = ["LiveGeneSearchService", "LiveReplicaRouter", "Compactor"]


def _ready(state: state_mod.IndexState) -> state_mod.IndexState:
    """Wait for the device work that computes ``state`` (a compaction's
    merge) before it is published or saved."""
    if state.device.type == "cuda":
        torch.cuda.synchronize(state.device)
    return state


class LiveGeneSearchService(service_mod.GeneSearchService):
    """Dynamic-batching front-end over a
    :class:`~repro_torch.index.lsm.LiveIndex`.

    Same admission, bucketing, padding and threshold rules as the static
    service — the step takes two states and merges their per-kmer
    membership. One runner per bucket still holds: base and delta are
    arguments of the step, and both keep their ``StateMeta`` across writes
    and compaction publishes.
    """

    def __init__(self, live: lsm.LiveIndex,
                 config: Optional[service_mod.ServiceConfig] = None):
        self._live = live
        super().__init__(live.base, config, version=live.base_version)
        # Two-store cache split (see kmer_cache module doc): the FRONT
        # cache (the inherited ``self.kmer_cache`` — what the scheduler's
        # per-batch attribution reads) holds MERGED base|delta rows keyed
        # by generation (version, delta_seq), so a warm batch is ONE
        # lookup; the base-row cache keyed by version survives writes, so
        # a delta_seq bump (which drops every merged row) only re-probes
        # the small delta — cached base rows backfill without touching
        # the engine. Compaction publishes bump version and drop both.
        self._base_cache = (
            kmer_cache_mod.KmerCache(self.config.kmer_cache.capacity)
            if self.config.kmer_cache is not None else None)

    @classmethod
    def open(cls, snapshot_dir: str,
             config: Optional[service_mod.ServiceConfig] = None, *,
             journal_path: Optional[str] = None,
             delta_cfg=None, base_version: int = 0,
             **load_kw) -> "LiveGeneSearchService":
        """Boot from snapshot + journal (crash recovery in one call)."""
        return cls(lsm.LiveIndex.open(
            snapshot_dir, journal_path=journal_path, delta_cfg=delta_cfg,
            base_version=base_version, **load_kw), config)

    @property
    def live(self) -> lsm.LiveIndex:
        return self._live

    # -- the write path -----------------------------------------------------
    def apply_insert(self, reads, file_ids=None, *, seq=None, **kw):
        """Absorb one write batch (journal + delta); returns the
        ``(base_version, delta_seq)`` at which it became searchable.

        ``seq`` carries a router-assigned fleet sequence number through to
        the live index (see :meth:`LiveIndex.insert`) so replica
        watermarks never drift from the fleet journal; standalone services
        leave it None and number locally. Must run on the same thread as
        query dispatch (the scheduler's flusher provides that; the
        synchronous path is single-threaded by construction) — the delta
        mutates between batches, never under a dispatched one.
        """
        seq = self._live.insert(reads, file_ids, seq=seq, **kw)
        return self._live.base_version, seq

    # -- compaction ---------------------------------------------------------
    def publish(self, merged: state_mod.IndexState, upto_seq: int, *,
                durable: bool = False) -> int:
        """Install a compacted base (callers hold the no-dispatch window —
        ``AsyncScheduler.pause`` — exactly like ``swap_state``). Pass
        ``durable=True`` ONLY after ``merged`` reached stable storage: it
        licenses the journal truncation (see :meth:`LiveIndex.publish`)."""
        version = self._live.publish(merged, upto_seq, durable=durable)
        self._state = self._live.base
        self._version = version
        return version

    def compact(self, scheduler=None, *, save_dir: Optional[str] = None
                ) -> int:
        """Plan → merge (off the hot path) → publish. With a scheduler,
        the publish runs inside its pause window (zero dropped futures);
        without one, the caller is the only dispatcher anyway.

        ``save_dir`` writes the merged base through the snapshot store
        BEFORE the publish, which is what allows the journal to drop the
        folded writes; without it the journal keeps them — an acked write
        stays durable across a crash either way.
        """
        plan = self._live.plan_compaction()
        merged = _ready(lsm.LiveIndex.compact(plan))
        if save_dir is not None:
            store.save(merged, save_dir)
        if scheduler is not None:
            scheduler.pause()
        try:
            return self.publish(merged, plan.upto_seq,
                                durable=save_dir is not None)
        finally:
            if scheduler is not None:
                scheduler.resume()

    def delta_batches(self) -> int:
        return self._live.delta_batches()

    def swap_state(self, index, *, version=None) -> int:
        raise NotImplementedError(
            "a live service's base only changes through compaction "
            "(plan_compaction -> compact -> publish); swapping an "
            "arbitrary state would orphan the delta and journal")

    # -- execution ----------------------------------------------------------
    def _runner(self, bucket: int):
        step = self._runners.get(bucket)
        if step is not None:
            return step
        theta, backend = self.config.theta, self.config.backend
        if self.kmer_cache is not None:
            # cached path: merged base|delta rows from the front cache
            # keyed (version, delta_seq); misses backfill from the
            # version-keyed base-row cache plus a delta probe of just the
            # missing kmers. The coordinates come from the same
            # ``states()`` snapshot that supplied the states, so cache
            # entries never cross a publish or a write.
            def step(base, delta, reads, valid, need, version, seq):
                per = self._merged_per_kmer(base, delta, reads,
                                            version, seq)
                return self._post_on_device(base, per, valid, need)
        else:
            def step(base, delta, reads, valid, need):
                per = lsm.merge_kmer_hits(
                    state_mod.to_engine(base).query_batch(
                        reads, backend=backend),
                    state_mod.to_engine(delta).query_batch(
                        reads, backend=backend))
                return state_mod.verdicts(base.meta, per, theta,
                                          valid=valid, need=need)
        self._runners[bucket] = step
        return step

    def _merged_per_kmer(self, base, delta, reads, version: int,
                         seq: int) -> np.ndarray:
        """Merged base|delta per-kmer rows through the two-store cache.

        Warm path: one front-cache lookup of the batch's packed codes —
        the merged rows are exact for the pinned ``(version, seq)``
        generation. Miss path: deduplicate the missing codes, pull their
        BASE rows through the version-keyed base cache (which survives
        writes, so after a delta_seq bump this is a pure gather), probe
        the delta for just those kmers, OR, and promote the merged rows
        into the front cache. Exact because membership is a pure function
        of ``(kmer, state)`` and OR over duplicates is idempotent.
        """
        t0 = obs_trace.now()
        arr = np.asarray(reads)
        codes = kmer_cache_mod.pack_codes(arr, self._k)
        flat = codes.ravel()
        t0 = service_mod.record_cache_stage("pack", t0)
        front = self.kmer_cache
        front.begin((version, seq))
        vals, hit = front.lookup(flat)
        t0 = service_mod.record_cache_stage("lookup", t0)
        if vals is not None and hit.all():
            return vals.reshape(codes.shape + vals.shape[1:])
        miss = (np.arange(flat.size) if vals is None
                else np.flatnonzero(~hit))
        uniq, first, inverse = np.unique(
            flat[miss], return_index=True, return_inverse=True)
        wins = np.lib.stride_tricks.sliding_window_view(
            arr, self._k, axis=1).reshape(-1, self._k)
        uniq_wins = wins[miss[first]]
        merged_rows = np.bitwise_or(
            self._rows_for_unique(self._base_cache, base, uniq,
                                  uniq_wins, int(version)),
            self._probe_unique(delta, uniq_wins))
        front.insert(uniq, merged_rows)
        if vals is None:
            vals = np.zeros((flat.size,) + merged_rows.shape[1:],
                            merged_rows.dtype)
        vals[miss] = merged_rows[inverse]
        service_mod.record_cache_stage("miss", t0)
        return vals.reshape(codes.shape + vals.shape[1:])

    def cache_stats(self):
        """Combined view over the two stores: front (merged rows — what
        answers warm batches; a write shows up as one invalidation) plus
        the base-row cache (whose hits are the write-survival reuse)."""
        if self.kmer_cache is None:
            return None
        return kmer_cache_mod.merge_cache_stats(
            [self.kmer_cache.stats(), self._base_cache.stats()])

    def _execute(self, bucket: int, batch, valid, need):
        """Dispatch the two-probe step; rides the state coordinates along
        with the device output so ``_finalize`` stamps the (version,
        delta_seq) that actually computed the batch — writes may advance
        the delta while this batch is still in the completer's hands."""
        step = self._runner(bucket)
        base, delta, version, seq = self._live.states()
        if self.kmer_cache is not None:   # cache generations = this snapshot
            # host arrays straight through (see GeneSearchService._execute)
            out = step(base, delta, batch, valid, need, version, seq)
        else:
            dev = base.device
            out = step(base, delta, torch.as_tensor(batch, device=dev),
                       torch.as_tensor(valid, device=dev),
                       torch.as_tensor(need, device=dev))
        return out, version, seq

    def _finalize(self, take, bucket: int, out
                  ) -> List[service_mod.SearchResult]:
        out, version, seq = out
        return self._decode(take, bucket, self._wait(out), version, seq)


class LiveReplicaRouter(router_mod.ReplicaRouter):
    """A replica fleet over per-replica live indexes, plus a write path.

    One write-ahead journal lives at the ROUTER (``journal_path``):
    :meth:`insert` journals the batch under the router lock — assigning
    one fleet-wide sequence number — then fans ``submit_insert`` to every
    serving replica in that same order, so each replica's ``delta_seq``
    tracks the journal watermark. Boot replays the journal into every
    replica's delta; replicas added by ``scale_to`` replay the
    uncompacted tail, so they answer identically to day-one replicas.
    """

    def __init__(self, index,
                 service_config: Optional[service_mod.ServiceConfig] = None,
                 config: Optional[router_mod.RouterConfig] = None, *,
                 devices=None, version: int = 0,
                 journal_path: Optional[str] = None,
                 delta_cfg=None):
        self._journal = (lsm.DeltaJournal(journal_path)
                         if journal_path is not None else None)
        self._delta_cfg = delta_cfg
        boot = self._journal.records() if self._journal is not None else []
        self._tail: List[lsm.JournalRecord] = list(boot)
        self._wal_seq = boot[-1].seq if boot else 0
        super().__init__(index, service_config, config,
                         devices=devices, version=version)

    def _make_service(self, state) -> LiveGeneSearchService:
        live = lsm.LiveIndex(state, delta_cfg=self._delta_cfg,
                             base_version=self._version,
                             start_seq=self._wal_seq)
        if self._tail:
            live.replay(self._tail)      # uncompacted fleet tail -> delta
        return LiveGeneSearchService(live, self._svc_cfg)

    # -- the write path -----------------------------------------------------
    def insert(self, reads, file_ids=None) -> List[Future]:
        """Journal one write batch, then fan it to every serving replica.

        The router lock covers journal append + fan-out, so concurrent
        inserts hit every replica in one total order and the fleet-wide
        sequence in the journal equals each replica's ``delta_seq``.
        Returns one ``Future[InsertAck]`` per replica.
        """
        reads = np.asarray(reads, dtype=np.uint8)
        if reads.ndim == 1:
            reads = reads[None]
        fids = (None if file_ids is None
                else np.asarray(file_ids, dtype=np.int32).reshape(-1))
        trc = obs_trace.DEFAULT
        span = (trc.start("insert", tier="router", n_reads=len(reads))
                if trc.enabled else None)
        ctx = span.context() if span is not None else None
        with self._lock:
            serving = [r for r in self._replicas if r.serving]
            if not serving:
                if span is not None:
                    span.end(status="error", error="no serving replicas")
                raise RuntimeError("router has no serving replicas")
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
            # the fleet seq rides WITH the write: every replica applies it
            # at this exact journal coordinate, so (version, delta_seq)
            # watermarks can never drift replica-to-replica — a laggard
            # that publishes first simply no-ops the re-delivery later
            t_f = time.monotonic()
            futs = [r.scheduler.submit_insert(reads, fids, seq=seq,
                                              trace=ctx)
                    for r in serving]
            if ctx is not None:
                trc.emit("fanout", ctx[0], ctx[1], t_f, time.monotonic(),
                         attrs={"seq": seq, "n_replicas": len(futs)})
        router_mod._close_span_on_acks(span, futs)
        return futs

    def delta_batches(self) -> int:
        with self._lock:
            return len(self._tail)

    @property
    def wal_seq(self) -> int:
        with self._lock:
            return self._wal_seq

    # -- compaction ---------------------------------------------------------
    def compact(self, *, save_dir: Optional[str] = None) -> int:
        """Fold the fleet's delta into its base, publish everywhere.

        The merge computes ONCE from the lead replica's frozen plan (all
        replicas absorb the same ordered write stream, so any replica's
        plan describes the fleet); each replica then publishes inside its
        own pause window — in-flight batches finish, queued futures stay
        queued, and the merged state's unchanged ``StateMeta`` means every
        runner survives. Replicas on one device share the merged base.
        ``save_dir`` writes the merged base through the versioned snapshot
        store before any replica swaps — and is the ONLY path that
        truncates the fleet journal: without a durable snapshot the
        journal keeps the folded writes, so a crash reboots from the
        previous snapshot + the full journal and loses nothing.
        """
        with self._admin_lock:
            with self._lock:
                reps = [r for r in self._replicas if r.serving]
                if not reps:
                    raise RuntimeError("router has no serving replicas")
            plan = reps[0].service.live.plan_compaction()
            merged = _ready(lsm.LiveIndex.compact(plan))
            upto_seq = plan.upto_seq
            del plan                      # the delta copy is freed here
            if save_dir is not None:
                store.save(merged, save_dir)
            for rep in reps:
                # replicas on one device share the one merged base
                rep_merged = router_mod.state_on_device(
                    merged, self.device_of(rep.id))
                rep.scheduler.pause()     # in-flight batches finish first
                try:
                    rep.service.publish(rep_merged, upto_seq)
                finally:
                    rep.scheduler.resume()
            with self._lock:
                self._state = merged
                self._version += 1
                self._tail = [r for r in self._tail
                              if r.seq > upto_seq]
                version = self._version
            if save_dir is not None and self._journal is not None:
                self._journal.truncate_through(upto_seq)
            return version

    def swap_state(self, index, *, version=None) -> int:
        raise NotImplementedError(
            "a live fleet's base only changes through compact(); swapping "
            "an arbitrary state would orphan every replica's delta and "
            "the write-ahead journal")

    def close(self) -> None:
        super().close()
        if self._journal is not None:
            self._journal.close()


class Compactor:
    """Background compaction loop over a live target.

    ``target`` is anything exposing ``delta_batches()`` and
    ``compact(**compact_kwargs)`` — a :class:`LiveReplicaRouter`, or a
    :class:`LiveGeneSearchService` (pass its scheduler through
    ``compact_kwargs`` so publishes run inside the pause window). Checks
    every ``interval_s`` and compacts once ``min_delta_batches`` writes
    have accumulated. Without a ``save_dir`` in ``compact_kwargs`` the
    compactions are in-memory only and the write-ahead journal keeps
    growing (by design — truncation requires a durable snapshot); pass
    one to reclaim it on every fold. A failed compaction stops the loop
    and surfaces on :attr:`error` (and re-raises from :meth:`close`) —
    silent write-path stalls are worse than a crash.
    """

    def __init__(self, target, *, interval_s: float = 0.25,
                 min_delta_batches: int = 8, compact_kwargs=None):
        if interval_s <= 0:
            raise ValueError("interval_s must be > 0")
        if min_delta_batches < 1:
            raise ValueError("min_delta_batches must be >= 1")
        self._target = target
        self._interval = float(interval_s)
        self._min = int(min_delta_batches)
        self._kwargs = dict(compact_kwargs or {})
        self._stop = threading.Event()
        self.compactions = 0
        self.error: Optional[BaseException] = None
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="idl-compactor")
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self._interval):
            try:
                if self._target.delta_batches() >= self._min:
                    self._target.compact(**self._kwargs)
                    self.compactions += 1
            except BaseException as e:  # noqa: BLE001 - surfaced on close
                self.error = e
                return

    def close(self, *, final_compaction: bool = False) -> int:
        """Stop the loop (optionally folding any remaining delta first).
        Returns the total number of compactions; re-raises a loop error."""
        self._stop.set()
        self._thread.join(timeout=30)
        if self.error is not None:
            raise self.error
        if final_compaction and self._target.delta_batches() > 0:
            self._target.compact(**self._kwargs)
            self.compactions += 1
        return self.compactions

    def __enter__(self) -> "Compactor":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
