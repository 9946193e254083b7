"""Gene-search serving: typed requests, shape-bucketed dynamic batching.

Port of :mod:`repro.serving.service` for all four engines.

* **Typed boundary** — :class:`SearchRequest` in (one read of any length
  >= k), :class:`SearchResult` out (per-file verdicts + decoded ids + the
  bucket that served it).
* **Shape-bucketed dynamic batching** — a request with ``n`` kmers is
  padded to the next power-of-two kmer bucket (floor
  ``ServiceConfig.min_bucket_kmers``) and batched with its bucket peers
  into a fixed ``(max_batch, bucket + k - 1)`` shape, with one cached
  runner per bucket. Pad kmers are masked out of the coverage reduction
  and each row keeps the integer threshold of its true kmer count, so
  answers equal the engine's own unpadded ``msmt``.
* **Admission queue + stats** — ``submit`` enqueues; a bucket flushes
  when ``max_batch`` requests wait (or on ``flush()``); every batch records
  occupancy, padding and wall time (:class:`BatchStats`).
* **Snapshot-backed startup** — :meth:`GeneSearchService.from_snapshot`.
* **Hot swap** — :meth:`GeneSearchService.swap_state` replaces the served
  state and bumps the version every :class:`SearchResult` carries.
* **Membership cache** (``ServiceConfig.kmer_cache``) — per-kmer rows
  memoized on the host under the served version
  (:mod:`repro_torch.serving.kmer_cache`): each batch packs its kmers,
  serves the hits from the cache, probes the distinct misses once through
  ``query_batch(..., dedup=True)`` on the state's device (one ``.cpu()``
  back), and uploads the batch's rows for the coverage postlude (one
  ``torch.as_tensor(..., device=...)``). The bytes of both copies are
  counted (``serving.cache_bytes_up`` / ``serving.cache_bytes_down``),
  and the host ms of each stage go to ``serving.cache_stage_ms{stage}``:
  ``pack`` (the batch's kmer codes), ``lookup``, ``miss`` (the whole miss
  path: dedup, the probe, the fill and the cache insert), ``probe`` (the
  device probe of the distinct misses and its copy back, within
  ``miss``) and ``upload`` (the rows' copy up and the postlude's enqueue).

The default backend is ``"idl_probe"``: per served bucket batch on a CUDA
index, one kernel launch (``gather_planned_rows`` for the bit-sliced index,
one per size group for COBS; its bit mode for RAMBO; ``probe_planned_bits``
for the flat filter).
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import itertools
import time
from typing import Deque, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.index import packed, query, store
from repro_torch.index import state as state_mod
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.serving import kmer_cache as kmer_cache_mod

BACKENDS = ("torch", "idl_probe", "sharded")

# distinguishes each service instance's counter series in the registry
_SERVICE_IDS = itertools.count()


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (n >= 1)."""
    return 1 << max(int(n) - 1, 0).bit_length()


def bucket_for(n_kmers: int, min_bucket_kmers: int = 32) -> int:
    """The pow2 kmer bucket a request with ``n_kmers`` kmers lands in
    (module-level: the fabric gateway and the scatter router bucket with
    the workers' geometry without holding an index)."""
    return max(next_pow2(n_kmers), min_bucket_kmers)


@dataclasses.dataclass(frozen=True)
class SearchRequest:
    """One query read (uint8 base codes, any length >= k)."""

    read: np.ndarray
    request_id: Optional[int] = None   # assigned by the service if None


@dataclasses.dataclass(frozen=True)
class SearchResult:
    """Engine verdicts for one request: ``matches`` is the engine's ``msmt``
    row — a (n_files,) bool vector, or a scalar bool for the single-set flat
    filter — and ``file_ids`` its decoded matching file indices (``(0,)``
    or ``()`` for the flat filter). ``version`` is the served state's
    version and ``delta_seq`` the live index's write watermark (0 for a
    static index): together, the staleness coordinates of the answer.
    ``missing_files`` names the files whose row-probe shard was down when
    a scatter-gather answer was assembled (their entries of ``matches``
    are vacuously False; see :mod:`repro_torch.serving.scatter`); it is
    ``()`` everywhere else."""

    request_id: int
    matches: np.ndarray
    file_ids: Tuple[int, ...]
    n_kmers: int
    bucket: int
    version: int = 0
    delta_seq: int = 0
    missing_files: Tuple[int, ...] = ()


def normalize_request(request: Union[SearchRequest, np.ndarray], k: int
                      ) -> Tuple[SearchRequest, int]:
    """Shared admission validation: ``(request, n_kmers)`` or raise."""
    if not isinstance(request, SearchRequest):
        request = SearchRequest(read=np.asarray(request))
    read = np.asarray(request.read, dtype=np.uint8)
    if read.ndim != 1:
        raise ValueError(
            f"submit takes one 1-D read, got shape {read.shape}; "
            f"submit each read separately (or use search())")
    n_kmers = read.shape[0] - k + 1
    if n_kmers < 1:
        raise ValueError(f"read of length {read.shape[0]} has no {k}-mers")
    return SearchRequest(read=read, request_id=request.request_id), n_kmers


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    """Serving knobs (static for the life of the service)."""

    theta: float = 1.0            # kmer-coverage threshold for a file match
    backend: str = "idl_probe"    # "idl_probe" | "torch" | "sharded"
    max_batch: int = 8            # rows per bucket step (fixed batch shape)
    min_bucket_kmers: int = 32    # floor of the pow2 kmer buckets
    auto_flush: bool = True       # flush a bucket once max_batch are waiting
    stats_window: int = 4096      # batches of telemetry kept (bounded)
    # cross-batch membership cache (None = off): per-kmer probe results
    # memoized under the served state's version, exact by construction
    kmer_cache: Optional[kmer_cache_mod.KmerCacheConfig] = None

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(
                f"unknown serving backend {self.backend!r} "
                f"(want one of {BACKENDS})")
        if self.max_batch < 1:
            raise ValueError("max_batch must be >= 1")


@dataclasses.dataclass(frozen=True)
class BatchStats:
    """Accounting for one executed (bucket, batch) step."""

    bucket: int          # kmer bucket (padded kmer count)
    n_requests: int      # real requests served
    batch_rows: int      # fixed batch shape rows (= max_batch)
    pad_rows: int        # batch_rows - n_requests
    pad_kmers: int       # wasted kmer slots incl. pad rows
    wall_ms: float


def emit_request_spans(entries, *, bucket: int, t0: float, t_asm: float,
                       t_exec: float, t_done: float, replica: int = 0,
                       version: int = 0) -> None:
    """Emit the per-request span chain (``request`` root with
    ``queue_wait → assemble → execute → finalize`` children) for one
    finalized batch; ``entries`` is ``[(trace_ctx, t_enq, request_id)]``,
    ``trace_ctx`` the ``(trace_id, parent_span_id)`` minted at admission."""
    trc = obs_trace.DEFAULT
    if not trc.enabled:
        return
    stages = (("assemble", t0, t_asm), ("execute", t_asm, t_exec),
              ("finalize", t_exec, t_done))
    trc.emit_request_chains(
        [(ctx[0], ctx[1], t_enq, rid)
         for ctx, t_enq, rid in entries if ctx is not None],
        t0, stages, t_done,
        shared_attrs={"bucket": bucket, "replica": replica,
                      "version": version})


def record_cache_stage(stage: str, t0: float) -> float:
    """Add the host ms since ``t0`` (a ``time.perf_counter()`` reading) to
    the ``serving.cache_stage_ms`` histogram of ``stage``; returns the
    current reading."""
    now = time.perf_counter()
    reg = obs_metrics.DEFAULT
    if reg.enabled:
        hist = _CACHE_STAGES.get(stage)
        if hist is None:
            hist = _CACHE_STAGES[stage] = reg.histogram(
                "serving.cache_stage_ms", tier="service", stage=stage)
        hist.observe(1e3 * (now - t0))
    return now


_CACHE_STAGES: dict = {}


def _msmt_reduce(kind: str, n_files: int, theta: float, per, valid, need):
    """Per-kmer engine output -> per-request verdicts, with pad kmers masked
    and per-row thresholds (the one theta rule): (B, n_files) bool for the
    bit-sliced index (from packed masks), COBS and RAMBO (from per-file
    kmer hits), (B,) bool for the single-set flat filter."""
    if kind == "bitsliced":
        if theta >= 1.0:
            # a row matches iff all its valid kmers hit: the masked AND path
            mask = query.file_match_mask(per, theta, valid=valid)
        else:
            mask = query.file_match_mask(per, theta, valid=valid, need=need)
        return packed.unpack_file_bits(mask, n_files)
    return query.member_coverage(per, theta, valid=valid, need=need)


class GeneSearchService:
    """Dynamic-batching front-end over any engine's :class:`IndexState`."""

    def __init__(self, index, config: Optional[ServiceConfig] = None, *,
                 version: int = 0):
        self.config = config or ServiceConfig()
        self._state = state_mod.from_engine(index)
        self._k = state_mod.kmer_size(self._state.meta)
        self._version = int(version)
        self._next_id = 0
        self._pending: Dict[int, List[Tuple[SearchRequest, int]]] = {}
        self._results: Dict[int, SearchResult] = {}
        self._inflight: set = set()
        self._runners: Dict[int, object] = {}
        self.kmer_cache: Optional[kmer_cache_mod.KmerCache] = (
            kmer_cache_mod.KmerCache(self.config.kmer_cache.capacity)
            if self.config.kmer_cache is not None else None)
        if self.kmer_cache is not None and self._k > 32:
            raise ValueError(
                f"kmer_cache packs kmers into uint64 keys, so k <= 32 "
                f"(index has k={self._k})")
        self.batch_stats: Deque[BatchStats] = collections.deque(
            maxlen=self.config.stats_window)
        meta = self._state.meta
        labels = {"tier": "service", "engine": meta.engine,
                  "scheme": meta.scheme, "backend": self.config.backend,
                  "service": next(_SERVICE_IDS)}
        reg = obs_metrics.DEFAULT
        self._obs_requests = reg.counter("serving.requests", **labels)
        self._obs_batches = reg.counter("serving.batches", **labels)
        self._obs_batch_rows = reg.counter("serving.batch_rows", **labels)
        self._obs_pad_rows = reg.counter("serving.pad_rows", **labels)
        self._obs_pad_kmers = reg.counter("serving.pad_kmers", **labels)
        self._obs_wall_ms = reg.histogram("serving.batch_wall_ms", **labels)
        # the cached path's host <-> device copies: the batch's per-kmer
        # rows up for the postlude, the probed miss rows down
        self._obs_bytes_up = reg.counter("serving.cache_bytes_up", **labels)
        self._obs_bytes_down = reg.counter("serving.cache_bytes_down",
                                           **labels)
        # request id -> (trace ctx, t_enq), for the span chain at finalize
        self._admitted: Dict[int, Tuple[Tuple[str, Optional[str]], float]] \
            = {}

    # -- construction -------------------------------------------------------
    @classmethod
    def from_snapshot(cls, directory: str,
                      config: Optional[ServiceConfig] = None, *,
                      device="cuda", **load_kw) -> "GeneSearchService":
        """Boot a service straight from a snapshot directory (written by
        either package) onto ``device``."""
        return cls(store.load(directory, device=device, **load_kw), config)

    @property
    def state(self) -> state_mod.IndexState:
        return self._state

    @property
    def version(self) -> int:
        """Monotone id of the state currently served (stamped into every
        :class:`SearchResult`; the membership cache's generation)."""
        return self._version

    @property
    def n_files(self) -> int:
        return int(self._state.meta.n_files or 1)

    def swap_state(self, index, *, version: Optional[int] = None) -> int:
        """Hot snapshot swap: replace the served state; returns the new
        version (the old one plus one unless ``version`` is given).

        A state with the same ``StateMeta`` keeps every runner; another
        meta (e.g. regrouped COBS) drops them; another kmer size is refused
        (queued requests were bucketed under the old ``k``). The cache
        drops every entry at the next batch, since its generation is the
        version. Not thread-safe on its own: under the async scheduler,
        pause it first (what ``ReplicaRouter.swap_state`` does).
        """
        new = state_mod.from_engine(index)
        if state_mod.kmer_size(new.meta) != self._k:
            raise ValueError(
                f"cannot hot-swap to a state with kmer size "
                f"{state_mod.kmer_size(new.meta)} (service buckets were "
                f"built for k={self._k}); boot a fresh service instead")
        if new.meta != self._state.meta:
            self._runners.clear()
        self._state = new
        self._version = self._version + 1 if version is None else int(version)
        return self._version

    # -- admission ----------------------------------------------------------
    def bucket_for(self, n_kmers: int) -> int:
        return bucket_for(n_kmers, self.config.min_bucket_kmers)

    def _normalize(self, request: Union[SearchRequest, np.ndarray]
                   ) -> Tuple[SearchRequest, int]:
        """Shared admission validation: ``(request, n_kmers)`` or raise."""
        return normalize_request(request, self._k)

    def submit(self, request: Union[SearchRequest, np.ndarray]) -> int:
        """Enqueue one read; returns its request id. With ``auto_flush`` the
        bucket executes as soon as ``max_batch`` requests are waiting."""
        request, n_kmers = self._normalize(request)
        rid = request.request_id
        if rid is None:
            rid = self._next_id
        elif rid in self._inflight:
            raise ValueError(
                f"request id {rid} is already in flight (pending or "
                f"unclaimed result)")
        self._next_id = max(self._next_id, rid) + 1
        self._inflight.add(rid)
        if obs_trace.DEFAULT.enabled:
            self._admitted[rid] = ((obs_trace.DEFAULT.mint_trace(), None),
                                   time.monotonic())
        req = SearchRequest(read=request.read, request_id=rid)
        bucket = self.bucket_for(n_kmers)
        self._pending.setdefault(bucket, []).append((req, n_kmers))
        if self.config.auto_flush and \
                len(self._pending[bucket]) >= self.config.max_batch:
            self._flush_bucket(bucket)
        return rid

    def flush(self) -> None:
        """Execute every queued bucket (partial batches padded)."""
        for bucket in sorted(self._pending):
            while self._pending.get(bucket):
                self._flush_bucket(bucket)
        self._pending = {b: q for b, q in self._pending.items() if q}

    def result(self, request_id: int) -> SearchResult:
        """Pop a finished request's result (KeyError if not served yet)."""
        out = self._results.pop(request_id)
        self._inflight.discard(request_id)
        return out

    def search(self, reads: Sequence[np.ndarray]) -> List[SearchResult]:
        """Synchronous convenience: submit all, flush, return in order."""
        ids = [self.submit(r) for r in reads]
        self.flush()
        return [self.result(i) for i in ids]

    # -- execution ----------------------------------------------------------
    def _runner(self, bucket: int):
        """The step for one bucket, built once: probe (the configured
        backend; through the membership cache when it is on), then the
        padding-aware coverage postlude on the state's device."""
        step = self._runners.get(bucket)
        if step is not None:
            return step
        reduce = functools.partial(
            _msmt_reduce, self._state.meta.engine, self.n_files,
            self.config.theta)
        backend = self.config.backend
        if self.kmer_cache is not None:
            def step(state, reads, valid, need):
                per = self._cached_per_kmer(state, reads,
                                            generation=self._version)
                return self._post_on_device(reduce, state.device, per,
                                            valid, need)
        else:
            def step(state, reads, valid, need):
                per = state_mod.to_engine(state).query_batch(
                    reads, backend=backend)
                return reduce(per, valid, need)
        self._runners[bucket] = step
        return step

    def _post_on_device(self, reduce, dev, per: np.ndarray, valid, need):
        """The cached path's postlude: the batch's host rows go to the
        device in one copy (counted), then the coverage reduction."""
        t0 = time.perf_counter()
        self._obs_bytes_up.inc(per.nbytes)
        out = reduce(torch.as_tensor(per, device=dev),
                     torch.as_tensor(valid, device=dev),
                     torch.as_tensor(need, device=dev))
        record_cache_stage("upload", t0)
        return out

    def _probe_unique(self, state, kmers: np.ndarray) -> np.ndarray:
        """Probe ``(M, k)`` distinct kmers -> ``(M, ...)`` engine rows on
        the host.

        Each kmer is a standalone length-k read through the dedup probe
        path (``query_batch(..., dedup=True)``) on the state's device with
        the configured backend (the kernels on a CUDA state); the rows come
        back in one ``.cpu()``. The reference pads small miss sets to 128
        kmers to bound XLA compiles; eager PyTorch compiles nothing, so
        the port probes the miss set as it is (the dedup path pads to a
        power of two itself, and padding with a repeated kmer adds no
        distinct kmer, so the answers and counters are the same).
        """
        t0 = time.perf_counter()
        out = state_mod.to_engine(state).query_batch(
            torch.as_tensor(kmers, device=state.device),
            backend=self.config.backend, dedup=True)
        rows = out[:, 0].cpu().numpy()
        self._obs_bytes_down.inc(rows.nbytes)
        record_cache_stage("probe", t0)
        return rows

    def _rows_via_cache(self, cache, state, arr, flat, generation
                        ) -> np.ndarray:
        """Per-kmer rows for ``flat`` packed codes, memoized in ``cache``.

        The warm path is vectorized numpy (see ``kmer_cache``); only the
        miss codes are deduplicated and probed, then inserted for the next
        batch. Returns a fresh ``(n, ...)`` row matrix the caller may
        mutate.
        """
        t0 = time.perf_counter()
        cache.begin(generation)
        vals, hit = cache.lookup(flat)
        t0 = record_cache_stage("lookup", t0)
        if vals is None or not hit.all():
            miss = np.flatnonzero(~hit)
            uniq, first, inverse = np.unique(
                flat[miss], return_index=True, return_inverse=True)
            wins = np.lib.stride_tricks.sliding_window_view(
                arr, self._k, axis=1).reshape(-1, self._k)
            probed = self._probe_unique(state, wins[miss[first]])
            if vals is None:
                vals = np.zeros((flat.size,) + probed.shape[1:],
                                probed.dtype)
            vals[miss] = probed[inverse]
            cache.insert(uniq, probed)
            record_cache_stage("miss", t0)
        return vals

    def _rows_for_unique(self, cache, state, codes, wins, generation
                         ) -> np.ndarray:
        """Like ``_rows_via_cache`` for sorted-unique ``codes`` with their
        aligned ``(M, k)`` windows (the live service's base backfill, where
        the deduplicated misses are already known). Returns a fresh row
        matrix."""
        cache.begin(generation)
        vals, hit = cache.lookup(codes)
        if vals is None or not hit.all():
            miss = np.flatnonzero(~hit)
            probed = self._probe_unique(state, wins[miss])
            if vals is None:
                vals = np.zeros((codes.size,) + probed.shape[1:],
                                probed.dtype)
            vals[miss] = probed
            cache.insert(codes[miss], probed)
        return vals

    def _cached_per_kmer(self, state, reads, *, generation: int
                         ) -> np.ndarray:
        """The cache-mediated probe: host reads -> per-kmer membership rows
        on the host, ``(B, n_kmers, ...)``. Exact: membership is a pure
        function of ``(kmer, state)``."""
        t0 = time.perf_counter()
        arr = np.asarray(reads)
        codes = kmer_cache_mod.pack_codes(arr, self._k)
        flat = codes.ravel()
        record_cache_stage("pack", t0)
        vals = self._rows_via_cache(self.kmer_cache, state, arr, flat,
                                    int(generation))
        return vals.reshape(codes.shape + vals.shape[1:])

    # The flush pipeline in three stages: _assemble (host: padding and
    # thresholds) -> _execute (device) -> _finalize (host: decode).

    def _assemble(self, take, bucket: int):
        """Pad ``take`` = [(request, n_kmers), ...] into the bucket's fixed
        batch shape (host-side; no device work)."""
        rows, read_len = self.config.max_batch, bucket + self._k - 1
        batch = np.zeros((rows, read_len), dtype=np.uint8)
        valid = np.zeros((rows, bucket), dtype=bool)
        need = np.zeros((rows,), dtype=np.int32)
        for i, (req, n_k) in enumerate(take):
            batch[i, :req.read.shape[0]] = req.read
            valid[i, :n_k] = True
            need[i] = query.coverage_need(self.config.theta, n_k)
        for i in range(len(take), rows):       # pad rows replay row 0
            batch[i], valid[i], need[i] = batch[0], valid[0], need[0]
        return batch, valid, need

    def _execute(self, bucket: int, batch, valid, need) -> torch.Tensor:
        """Run the bucket's step on the state's device; returns the
        (max_batch, n_files) bool verdicts there. The cached step takes
        the host arrays (it packs and looks up on the host)."""
        if self.kmer_cache is not None:
            return self._runner(bucket)(self._state, batch, valid, need)
        dev = self._state.device
        return self._runner(bucket)(
            self._state, torch.as_tensor(batch, device=dev),
            torch.as_tensor(valid, device=dev),
            torch.as_tensor(need, device=dev))

    def _finalize(self, take, bucket: int, out) -> List[SearchResult]:
        """Copy the verdicts to the host and decode per-request results."""
        out = out.cpu().numpy()
        single_set = self._state.meta.engine == "bloom"
        results = []
        for i, (req, n_k) in enumerate(take):
            row = out[i]
            if single_set:
                fids = (0,) if bool(row) else ()
            else:
                fids = tuple(int(f) for f in np.nonzero(row)[0])
            results.append(SearchResult(
                request_id=req.request_id, matches=row, file_ids=fids,
                n_kmers=n_k, bucket=bucket, version=self._version))
        return results

    def _flush_bucket(self, bucket: int) -> None:
        queue = self._pending.get(bucket, [])
        take, self._pending[bucket] = \
            queue[:self.config.max_batch], queue[self.config.max_batch:]
        if not take:
            return
        t0 = time.monotonic()
        batch, valid, need = self._assemble(take, bucket)
        t_asm = time.monotonic()
        out = self._execute(bucket, batch, valid, need)
        t_exec = time.monotonic()
        for res in self._finalize(take, bucket, out):
            self._results[res.request_id] = res
        t_done = time.monotonic()
        self._record_batch(BatchStats(
            bucket=bucket, n_requests=len(take),
            batch_rows=self.config.max_batch,
            pad_rows=self.config.max_batch - len(take),
            pad_kmers=self.config.max_batch * bucket
            - sum(n_k for _, n_k in take),
            wall_ms=(t_done - t0) * 1e3))
        entries = []
        for req, _ in take:
            ctx, t_enq = self._admitted.pop(req.request_id, (None, t0))
            entries.append((ctx, t_enq, req.request_id))
        emit_request_spans(entries, bucket=bucket, t0=t0, t_asm=t_asm,
                           t_exec=t_exec, t_done=t_done,
                           version=self._version)

    # -- observability ------------------------------------------------------
    def _record_batch(self, bs: BatchStats) -> None:
        """Window the per-batch record and mirror the aggregates into the
        process registry."""
        self.batch_stats.append(bs)
        self._obs_requests.inc(bs.n_requests)
        self._obs_batches.inc()
        self._obs_batch_rows.inc(bs.batch_rows)
        self._obs_pad_rows.inc(bs.pad_rows)
        self._obs_pad_kmers.inc(bs.pad_kmers)
        self._obs_wall_ms.observe(bs.wall_ms)

    def compile_counts(self) -> Dict[int, int]:
        """Cached runners per bucket (one each: PyTorch runs eagerly, so a
        bucket's runner is built once and reused)."""
        return {b: 1 for b in sorted(self._runners)}

    def cache_stats(self) -> Optional[Dict[str, float]]:
        """``KmerCache.stats()`` of this service (None when the cache is
        off)."""
        return (self.kmer_cache.stats()
                if self.kmer_cache is not None else None)

    def cache_copy_bytes(self) -> Tuple[int, int]:
        """Lifetime bytes the cached path copied: ``(to the device, from
        the device)`` — the batches' rows up, the probed miss rows down."""
        return int(self._obs_bytes_up.value), int(self._obs_bytes_down.value)

    def requests_served(self) -> int:
        """Lifetime requests served (registry-backed)."""
        return int(self._obs_requests.value)

    def occupancy(self) -> float:
        """Fraction of batch rows that carried real requests (lifetime)."""
        rows = self._obs_batch_rows.value
        return self._obs_requests.value / rows if rows else 0.0

    def request_latencies_ms(self) -> List[float]:
        """Per-request latency: each request is charged its batch's wall."""
        out: List[float] = []
        for s in self.batch_stats:
            out.extend([s.wall_ms] * s.n_requests)
        return out
