"""Replica router: spread a request stream over K IndexState replicas.

Port of :mod:`repro.serving.router`. A replica is a
:class:`~repro_torch.serving.service.GeneSearchService` over the index's
state on one device, behind its own
:class:`~repro_torch.serving.scheduler.AsyncScheduler`. ``devices=None``
puts every replica on the index's own device; a list of ``torch.device``
spreads them round-robin. A replica's state reaches its device through
:func:`state_on_device`, which returns the same tensors when they are
already there: K replicas on one card share one base (none of them writes
it; live writes go to per-replica deltas), so they hold one copy, not K.

* **Routing policies** — ``round_robin``, ``least_outstanding`` (join the
  shortest queue), ``bucket_affinity`` (a kmer bucket always lands on the
  same replica, keeping its runners and admission EWMAs hot).

* **Hot snapshot swap** — :meth:`swap_snapshot` loads and validates a new
  snapshot first (a corrupt, foreign or future-version directory raises
  :class:`~repro_torch.index.store.SnapshotError` before any replica is
  touched), then walks the replicas one at a time: pause (in-flight
  batches finish), swap state, resume. Zero futures are dropped, and a
  result's ``version`` is always the version of the state that computed
  it. A same-geometry swap keeps every runner.

* **Autoscaling** — with a :class:`~repro_torch.serving.autoscale
  .ReplicaAutoscaler`, :meth:`autoscale_step` grows or shrinks the fleet
  between the configured bounds; removed replicas drain every queued
  future before they shut down.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.index import state as state_mod
from repro_torch.index import store
from repro_torch.obs import export as obs_export
from repro_torch.obs import trace as obs_trace
from repro_torch.serving import kmer_cache as kmer_cache_mod
from repro_torch.serving import service as service_mod
from repro_torch.serving.autoscale import (
    AdmissionPolicy,
    AutoscaleConfig,
    ReplicaAutoscaler,
)
from repro_torch.serving.scheduler import AsyncScheduler, ClusterStats, \
    SchedulerConfig

__all__ = ["RouterConfig", "ReplicaRouter", "RoutingPolicy", "POLICIES",
           "state_on_device"]

POLICIES = ("round_robin", "least_outstanding", "bucket_affinity")


def state_on_device(state: state_mod.IndexState, device
                    ) -> state_mod.IndexState:
    """``state`` on ``device``: the same object when every word matrix is
    already there (replicas on one device share it), else a copy."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if all(w.device == device for w in state.words):
        return state
    return state_mod.IndexState(
        words=tuple(w.to(device) for w in state.words), meta=state.meta)


def _close_span_on_acks(span, futures: Sequence[Future]) -> None:
    """End a write's root span when every replica ack resolves — the ack
    leg of the insert → journal-append → fan-out → ack chain. Any errored
    or cancelled ack closes the root with error status."""
    if span is None:
        return
    lock = threading.Lock()
    state = {"remaining": len(futures), "failed": False}

    def _done(f: Future) -> None:
        with lock:
            if f.cancelled() or f.exception() is not None:
                state["failed"] = True
            state["remaining"] -= 1
            last = state["remaining"] == 0
        if last:
            span.end(status="error" if state["failed"] else "ok",
                     n_replicas=len(futures))

    for f in futures:
        f.add_done_callback(_done)


class RoutingPolicy:
    """The routing decision itself, factored out of the router so every
    tier that spreads load over members shares one policy core.

    ``pick(members, bucket, load)`` chooses among the ordered serving
    members (anything with a stable integer ``.id``); ``load`` maps a
    member to its outstanding-work figure (used by ``least_outstanding``).
    Policy state (the round-robin cursor, the bucket->member affinity
    map) lives here. Not thread-safe on its own — callers hold their
    fleet lock across the pick, exactly as the router always did.
    """

    def __init__(self, policy: str):
        if policy not in POLICIES:
            raise ValueError(
                f"unknown routing policy {policy!r} "
                f"(want one of {POLICIES})")
        self.policy = policy
        self._rr = itertools.count()
        self._affinity: Dict[int, int] = {}     # bucket -> member id

    def pick(self, members, bucket: int, load):
        if not members:
            raise RuntimeError("no serving members to route to")
        if self.policy == "round_robin":
            return members[next(self._rr) % len(members)]
        if self.policy == "least_outstanding":
            return min(members, key=load)
        # bucket_affinity: sticky bucket -> member map, assigned round-
        # robin on first sight so load still spreads; remapped only if
        # the pinned member was decommissioned
        by_id = {m.id: m for m in members}
        mid = self._affinity.get(bucket)
        if mid is None or mid not in by_id:
            member = members[next(self._rr) % len(members)]
            self._affinity[bucket] = member.id
            return member
        return by_id[mid]


@dataclasses.dataclass(frozen=True)
class RouterConfig:
    """Replica fan-out knobs."""

    n_replicas: int = 2
    policy: str = "least_outstanding"
    scheduler: SchedulerConfig = dataclasses.field(
        default_factory=SchedulerConfig)
    autoscale: Optional[AutoscaleConfig] = None   # enables adaptive serving

    def __post_init__(self):
        if self.policy not in POLICIES:
            raise ValueError(
                f"unknown routing policy {self.policy!r} "
                f"(want one of {POLICIES})")
        if self.n_replicas < 1:
            raise ValueError("n_replicas must be >= 1")


@dataclasses.dataclass
class _Replica:
    id: int
    service: service_mod.GeneSearchService
    scheduler: AsyncScheduler
    serving: bool = True       # False while being decommissioned


class ReplicaRouter:
    """K pipelined serving replicas behind one ``submit``.

    ``devices``: the ``torch.device`` of each replica, round-robin (None:
    the index's own device for every replica)."""

    def __init__(self, index,
                 service_config: Optional[service_mod.ServiceConfig] = None,
                 config: Optional[RouterConfig] = None, *,
                 devices: Optional[Sequence] = None,
                 version: int = 0):
        self.config = config or RouterConfig()
        self._svc_cfg = service_config or service_mod.ServiceConfig()
        self._state = state_mod.from_engine(index)
        self._version = int(version)
        self._devices = (tuple(torch.device(d) for d in devices) if devices
                         else (self._state.device,))
        self._autoscaler = (ReplicaAutoscaler(self.config.autoscale)
                            if self.config.autoscale is not None else None)
        self._lock = threading.Lock()
        self._as_lock = threading.Lock()   # autoscaler observation guard
        # serializes fleet mutations (swap / scale): a replica booted
        # mid-swap from the pre-swap state would serve a stale version
        # forever
        self._admin_lock = threading.Lock()
        self._replicas: List[_Replica] = []
        self._next_replica_id = 0
        self._policy = RoutingPolicy(self.config.policy)
        for _ in range(self.config.n_replicas):
            self._add_replica_locked()

    # -- construction -------------------------------------------------------
    @classmethod
    def from_snapshot(cls, directory: str,
                      service_config=None, config=None, *,
                      version: int = 0, device="cuda",
                      **load_kw) -> "ReplicaRouter":
        """Boot a replica fleet straight from a versioned snapshot, loaded
        onto ``device``."""
        return cls(store.load(directory, device=device, **load_kw),
                   service_config, config, version=version)

    def _make_service(self, state) -> service_mod.GeneSearchService:
        """Build one replica's service over its device-local state. The
        subclass hook :class:`~repro_torch.serving.live.LiveReplicaRouter`
        uses
        to wrap each replica's state in a writable live index."""
        return service_mod.GeneSearchService(state, self._svc_cfg,
                                             version=self._version)

    def _add_replica_locked(self) -> _Replica:
        rid = self._next_replica_id
        self._next_replica_id += 1
        state = state_on_device(self._state, self.device_of(rid))
        svc = self._make_service(state)
        admission = (AdmissionPolicy(self.config.autoscale)
                     if self.config.autoscale is not None else None)
        rep = _Replica(
            id=rid, service=svc,
            scheduler=AsyncScheduler(svc, self.config.scheduler,
                                     admission=admission,
                                     on_batch=self._observe_batch,
                                     replica_id=rid))
        self._replicas.append(rep)
        return rep

    def _observe_batch(self, stats: ClusterStats, now: float) -> None:
        """Completer-thread hook: feed batch telemetry to the autoscaler."""
        if self._autoscaler is not None:
            with self._as_lock:
                self._autoscaler.observe_batch(stats, now)

    def device_of(self, replica_id: int) -> torch.device:
        """The device replica ``replica_id`` serves from."""
        return self._devices[replica_id % len(self._devices)]

    # -- views --------------------------------------------------------------
    @property
    def version(self) -> int:
        return self._version

    @property
    def n_replicas(self) -> int:
        with self._lock:
            return len(self._replicas)

    def outstanding(self) -> int:
        with self._lock:
            reps = list(self._replicas)
        return sum(r.scheduler.outstanding for r in reps)

    def compile_counts(self) -> Dict[int, Dict[int, int]]:
        """Runners per bucket of each replica: {replica_id: {bucket: n}}."""
        with self._lock:
            reps = list(self._replicas)
        return {r.id: r.scheduler.compile_counts() for r in reps}

    def cluster_stats(self) -> List[ClusterStats]:
        """Merged telemetry across replicas (each ring-buffer bounded)."""
        with self._lock:
            reps = list(self._replicas)
        return [s for r in reps for s in list(r.scheduler.stats)]

    def cache_stats(self) -> Optional[Dict[str, float]]:
        """Fleet-wide kmer-cache view: per-replica ``KmerCache.stats()``
        aggregated (None when no replica carries a cache)."""
        with self._lock:
            reps = list(self._replicas)
        return kmer_cache_mod.merge_cache_stats(
            r.service.cache_stats() for r in reps)

    def requests_served(self) -> int:
        """Lifetime fleet total — a view over each replica's registry-
        backed service counter (not the windowed stats ring)."""
        with self._lock:
            reps = list(self._replicas)
        return sum(r.service.requests_served() for r in reps)

    def occupancy(self) -> float:
        """Fleet rows-served-per-row-dispatched, from the same registry
        counters the per-service view reads."""
        with self._lock:
            reps = list(self._replicas)
        rows = sum(r.service._obs_batch_rows.value for r in reps)
        reqs = sum(r.service._obs_requests.value for r in reps)
        return reqs / rows if rows else 0.0

    def obs_snapshot(self) -> dict:
        """Full process-local obs snapshot (metrics + finished spans):
        every replica feeds the one process registry, so no per-replica
        merge is needed."""
        return obs_export.snapshot()

    # -- routing ------------------------------------------------------------
    def _route(self, bucket: int) -> _Replica:
        """Pick a serving replica (caller holds the lock)."""
        serving = [r for r in self._replicas if r.serving]
        if not serving:
            raise RuntimeError("router has no serving replicas")
        return self._policy.pick(serving, bucket,
                                 lambda r: r.scheduler.outstanding)

    def submit(self, request: Union[service_mod.SearchRequest, np.ndarray]
               ) -> Future:
        """Route one read to a replica; returns its Future[SearchResult]."""
        with self._lock:
            if not self._replicas:
                raise RuntimeError("router is closed")
            any_svc = self._replicas[0].service
        req, n_kmers = any_svc._normalize(request)
        bucket = any_svc.bucket_for(n_kmers)
        with self._lock:
            rep = self._route(bucket)
        if self._autoscaler is not None:
            with self._as_lock:
                self._autoscaler.observe_arrival(time.monotonic())
        return rep.scheduler.submit(req)

    def search(self, reads: Sequence[np.ndarray]
               ) -> List[service_mod.SearchResult]:
        """Submit all, drain every replica, return results in order."""
        futures = [self.submit(r) for r in reads]
        self.drain()
        return [f.result() for f in futures]

    # -- the write path -----------------------------------------------------
    def insert(self, reads, file_ids=None) -> List[Future]:
        """Fan one write batch out to every serving replica.

        Unlike queries (which route to ONE replica), a write must reach
        them all — every replica answers from its own base+delta pair.
        The router lock is held across the fan-out, so concurrent inserts
        enqueue in the same total order on every replica and the
        per-replica ``delta_seq`` watermarks stay aligned. Returns one
        ``Future[InsertAck]`` per replica (all resolved = the write is
        searchable fleet-wide). Requires live-index replicas
        (:class:`~repro_torch.serving.live.LiveReplicaRouter`); static
        replicas
        raise ``TypeError`` on the first fan-out.
        """
        trc = obs_trace.DEFAULT
        span = (trc.start("insert", tier="router") if trc.enabled else None)
        ctx = span.context() if span is not None else None
        with self._lock:
            serving = [r for r in self._replicas if r.serving]
            if not serving:
                if span is not None:
                    span.end(status="error", error="no serving replicas")
                raise RuntimeError("router has no serving replicas")
            t0 = time.monotonic()
            futs = [r.scheduler.submit_insert(reads, file_ids, trace=ctx)
                    for r in serving]
            if ctx is not None:
                trc.emit("fanout", ctx[0], ctx[1], t0, time.monotonic(),
                         attrs={"n_replicas": len(futs)})
        _close_span_on_acks(span, futs)
        return futs

    # -- hot snapshot swap --------------------------------------------------
    def swap_snapshot(self, directory: str, *,
                      version: Optional[int] = None, device=None,
                      **load_kw) -> int:
        """Load a new snapshot version and swap every replica under load.

        Validation happens FIRST: ``store.load`` rejects corrupt, foreign,
        truncated and future-version snapshots with ``SnapshotError``
        before any replica is touched, so a bad snapshot offer leaves the
        fleet serving the old version untouched. Then replicas swap one at
        a time (pause -> swap -> resume); the rest keep serving.
        """
        device = self._state.device if device is None else device
        new_state = store.load(directory, device=device,
                               **load_kw)        # may raise: fleet clean
        return self.swap_state(new_state, version=version)

    def swap_state(self, index, *, version: Optional[int] = None) -> int:
        """Swap an already-validated state/engine into every replica."""
        new_state = state_mod.from_engine(index)
        with self._admin_lock:
            return self._swap_state_admin(new_state, version)

    def _swap_state_admin(self, new_state, version: Optional[int]) -> int:
        """Fleet swap body (caller holds the admin lock, so no replica can
        be booted from the pre-swap state mid-walk)."""
        with self._lock:
            # geometry gate before touching ANY replica (per-replica
            # swap_state would re-check, but failing mid-fleet would leave
            # mixed versions forever)
            k_new = state_mod.kmer_size(new_state.meta)
            k_old = state_mod.kmer_size(self._state.meta)
            if k_new != k_old:
                raise ValueError(
                    f"cannot hot-swap to kmer size {k_new} over a fleet "
                    f"serving k={k_old}; boot a fresh router instead")
            new_version = (self._version + 1 if version is None
                           else int(version))
            reps = list(self._replicas)
        for rep in reps:
            replica_state = state_on_device(new_state, self.device_of(rep.id))
            rep.scheduler.pause()      # in-flight batches finish first
            try:
                rep.service.swap_state(replica_state, version=new_version)
            finally:
                rep.scheduler.resume()
        with self._lock:
            self._state = new_state
            self._version = new_version
        return new_version

    # -- scaling ------------------------------------------------------------
    def scale_to(self, n: int) -> int:
        """Grow/shrink the fleet to ``n`` replicas; returns the new count.

        Growth boots replicas from the current state + version (each
        builds its runners on first use). Shrinking decommissions the most idle replicas:
        no new traffic, drain queued futures, shut down.
        """
        if n < 1:
            raise ValueError("cannot scale below 1 replica")
        to_close: List[_Replica] = []
        with self._admin_lock, self._lock:
            while len(self._replicas) < n:
                self._add_replica_locked()
            if len(self._replicas) > n:
                victims = sorted(
                    self._replicas,
                    key=lambda r: r.scheduler.outstanding,
                )[:len(self._replicas) - n]
                for rep in victims:
                    rep.serving = False       # stop routing immediately
                    to_close.append(rep)
                self._replicas = [r for r in self._replicas
                                  if r.serving]
        for rep in to_close:
            rep.scheduler.close()             # drains: zero dropped futures
        return self.n_replicas

    def autoscale_step(self, now: Optional[float] = None) -> int:
        """Apply one ReplicaAutoscaler recommendation (no-op without one).

        Pull-based by design: the serving loop (or a bench/ops cron) calls
        this at its own cadence, so scaling decisions are deterministic
        and testable instead of racing a hidden daemon thread.
        """
        if self._autoscaler is None:
            return self.n_replicas
        now = time.monotonic() if now is None else now
        rec = self._autoscaler.recommend(
            now, self.n_replicas, self.outstanding(),
            self._svc_cfg.max_batch)
        if rec != self.n_replicas:
            self.scale_to(rec)
        return self.n_replicas

    @property
    def autoscaler(self) -> Optional[ReplicaAutoscaler]:
        return self._autoscaler

    # -- lifecycle ----------------------------------------------------------
    def drain(self) -> None:
        with self._lock:
            reps = list(self._replicas)
        for rep in reps:
            rep.scheduler.drain()

    def close(self) -> None:
        with self._lock:
            reps = list(self._replicas)
            self._replicas = []
        for rep in reps:
            rep.scheduler.close()

    def __enter__(self) -> "ReplicaRouter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
