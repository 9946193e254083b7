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
* **Array admission** — ``search()`` admits reads of one length (a 2-D
  array, or equal 1-D arrays) as one :class:`RequestBlock` when nothing is
  queued: one validation, one id range, one bucket, one clock reading.
  Its chunks go through the same ``_assemble`` / ``_execute`` /
  ``_finalize`` as queued requests (slice copies in, one ``nonzero`` out)
  and come straight back in order; ``serving.array_requests`` counts the
  reads admitted so. Ragged reads, a non-empty queue or caller-supplied
  ids take ``submit`` + ``flush``.
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
* **Stage timers** — every batch adds its host ms to
  ``serving.stage_ms{stage}``: ``admit`` (the batch's fill, from its
  bucket's queue going non-empty to the flush; queueing under the
  scheduler), ``wait`` (``_finalize``'s ``.cpu()``: the device and the
  copy back) and ``decode`` (the copy's return to the batch's results
  decoded), which split the ``finalize`` span, and ``obs`` (the batch's
  counters, stage observations and request spans). On the array path
  ``admit`` runs from ``search()``'s entry (or the last chunk's end) to
  the chunk's flush.

The default backend is ``"idl_probe"``: per served bucket batch on a CUDA
index, one kernel launch (``gather_planned_rows`` for the bit-sliced index,
one per size group for COBS; its bit mode for RAMBO; ``probe_planned_bits``
for the flat filter, whose verdicts are one file's column).
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
from typing import Deque, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.index import query, store
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
    row, a (n_files,) bool vector ((1,): the single-set flat filter answers
    as an index of one file), and ``file_ids`` its decoded matching file
    indices (``(0,)`` or ``()`` for the flat filter). ``version`` is the
    served state's version and ``delta_seq`` the live index's write
    watermark (0 for a static index): together, the staleness coordinates
    of the answer.
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


class RequestBlock:
    """Reads of one length admitted as arrays (``search()``'s array path):
    ``reads`` ``(n, L)`` uint8, ``ids`` a ``range`` of request ids, one
    ``n_kmers``, the trace ids minted at admission (None with the tracer
    off) and the admission time ``t_enq``. A batch's ``take`` in the
    pipeline's hooks: it has a length, iterates as the ``(SearchRequest,
    n_kmers)`` pairs of the per-read path (built only when iterated), and
    slices into chunks."""

    __slots__ = ("reads", "ids", "n_kmers", "traces", "t_enq")

    def __init__(self, reads: np.ndarray, ids: range, n_kmers: int,
                 traces: Optional[List[str]], t_enq: float):
        self.reads, self.ids, self.n_kmers = reads, ids, n_kmers
        self.traces, self.t_enq = traces, t_enq

    def __len__(self) -> int:
        return len(self.ids)

    def __iter__(self):
        for read, rid in zip(self.reads, self.ids):
            yield SearchRequest(read=read, request_id=rid), self.n_kmers

    def __getitem__(self, rows: slice) -> "RequestBlock":
        return RequestBlock(
            self.reads[rows], self.ids[rows], self.n_kmers,
            None if self.traces is None else self.traces[rows], self.t_enq)


def _columns(take) -> Tuple[Sequence[int], Sequence[int]]:
    """The request ids and kmer counts of a batch's ``take``: a
    :class:`RequestBlock`, or ``[(request, n_kmers), ...]`` pairs."""
    if isinstance(take, RequestBlock):
        return take.ids, [take.n_kmers] * len(take)
    return [req.request_id for req, _ in take], [n_k for _, n_k in take]


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
    """Add the host ms since ``t0`` (an ``obs.trace.now()`` reading) to the
    ``serving.cache_stage_ms`` histogram of ``stage``; returns the current
    reading."""
    return _CACHE_STAGES.lap(stage, t0)


_CACHE_STAGES = obs_metrics.StageTimer("serving.cache_stage_ms",
                                       tier="service")


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
        self._obs_array_requests = reg.counter("serving.array_requests",
                                               **labels)
        self._obs_batches = reg.counter("serving.batches", **labels)
        self._obs_batch_rows = reg.counter("serving.batch_rows", **labels)
        self._obs_pad_rows = reg.counter("serving.pad_rows", **labels)
        self._obs_pad_kmers = reg.counter("serving.pad_kmers", **labels)
        self._stages = obs_metrics.StageTimer("serving.stage_ms", **labels)
        # bucket -> when its queue went non-empty (the ``admit`` stage's
        # start), and when the last batch's copy back returned (``wait``)
        self._filling: Dict[int, float] = {}
        self._t_copied = 0.0
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
                                   obs_trace.now())
        req = SearchRequest(read=request.read, request_id=rid)
        bucket = self.bucket_for(n_kmers)
        queue = self._pending.setdefault(bucket, [])
        if not queue:
            self._filling[bucket] = obs_trace.now()
        queue.append((req, n_kmers))
        if self.config.auto_flush and len(queue) >= self.config.max_batch:
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

    def search(self, reads: Union[np.ndarray, Sequence[np.ndarray]]
               ) -> List[SearchResult]:
        """Synchronous convenience: serve ``reads``, return their results
        in order. Reads the array path takes (see :meth:`_admit_block`)
        are served in chunks of ``max_batch`` straight from the block;
        any others are submitted one by one and flushed."""
        t_fill = obs_trace.now()
        block = self._admit_block(reads, t_fill)
        if block is None:
            ids = [self.submit(r) for r in reads]
            self.flush()
            return [self.result(i) for i in ids]
        bucket, rows = self.bucket_for(block.n_kmers), self.config.max_batch
        results: List[SearchResult] = []
        for start in range(0, len(block), rows):
            done, t_fill = self._serve(block[start:start + rows], bucket,
                                       t_fill)
            results.extend(done)
        return results

    def _admit_block(self, reads, t_enq: float) -> Optional[RequestBlock]:
        """Admit ``reads`` as one :class:`RequestBlock` when they allow it:
        a 2-D array or a list / tuple of 1-D arrays, at least one read,
        every read of one length with at least one kmer, and nothing
        queued in any bucket. Else None, with nothing admitted."""
        if any(self._pending.values()):
            return None
        if isinstance(reads, np.ndarray):
            if reads.ndim != 2:
                return None
        elif (isinstance(reads, (list, tuple)) and reads
              and all(isinstance(r, np.ndarray) and r.ndim == 1
                      and r.shape == reads[0].shape for r in reads)):
            reads = np.stack(reads)
        else:
            return None
        n, n_kmers = reads.shape[0], reads.shape[1] - self._k + 1
        if n == 0 or n_kmers < 1:
            return None
        ids = range(self._next_id, self._next_id + n)
        self._next_id += n
        trc = obs_trace.DEFAULT
        traces = trc.mint_traces(n) if trc.enabled else None
        self._obs_array_requests.inc(n)
        return RequestBlock(np.asarray(reads, dtype=np.uint8), ids, n_kmers,
                            traces, t_enq)

    # -- execution ----------------------------------------------------------
    def _runner(self, bucket: int):
        """The step for one bucket, built once: the engine's padding-aware
        ``coverage_batch`` with the configured backend; with the membership
        cache on, the cached per-kmer rows through the verdict rule
        instead."""
        step = self._runners.get(bucket)
        if step is not None:
            return step
        theta, backend = self.config.theta, self.config.backend
        if self.kmer_cache is not None:
            def step(state, reads, valid, need):
                per = self._cached_per_kmer(state, reads,
                                            generation=self._version)
                return self._post_on_device(state, per, valid, need)
        else:
            def step(state, reads, valid, need):
                return state_mod.to_engine(state).coverage_batch(
                    reads, theta, valid=valid, need=need, backend=backend)
        self._runners[bucket] = step
        return step

    def _post_on_device(self, state, per: np.ndarray, valid, need):
        """The cached path's postlude: the batch's host rows go to
        ``state``'s device in one copy (counted), then the verdict rule."""
        t0 = obs_trace.now()
        self._obs_bytes_up.inc(per.nbytes)
        dev = state.device
        out = state_mod.verdicts(
            state.meta, torch.as_tensor(per, device=dev), self.config.theta,
            valid=torch.as_tensor(valid, device=dev),
            need=torch.as_tensor(need, device=dev))
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
        t0 = obs_trace.now()
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
        t0 = obs_trace.now()
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
        t0 = obs_trace.now()
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
        """Pad ``take`` (a :class:`RequestBlock` or [(request, n_kmers),
        ...]) into the bucket's fixed batch shape (host-side; no device
        work): a block's reads in one slice copy, queued reads (which may
        differ in length) one by one."""
        rows, read_len = self.config.max_batch, bucket + self._k - 1
        n = len(take)
        n_k = np.asarray(_columns(take)[1])
        batch = np.zeros((rows, read_len), dtype=np.uint8)
        if isinstance(take, RequestBlock):
            batch[:n, :take.reads.shape[1]] = take.reads
        else:
            for i, (req, _) in enumerate(take):
                batch[i, :req.read.shape[0]] = req.read
        valid = np.empty((rows, bucket), dtype=bool)
        need = np.empty((rows,), dtype=np.int32)
        valid[:n] = np.arange(bucket) < n_k[:, None]
        need[:n] = query.coverage_need(self.config.theta, n_k)
        # pad rows replay row 0
        batch[n:], valid[n:], need[n:] = batch[0], valid[0], need[0]
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

    def _wait(self, out) -> np.ndarray:
        """The verdicts on the host: the host waits for the device and the
        copy back. Stamps the copy's return, where ``wait`` ends and
        ``decode`` starts."""
        out = out.cpu().numpy()
        self._t_copied = obs_trace.now()
        return out

    def _finalize(self, take, bucket: int, out) -> List[SearchResult]:
        """Copy the verdicts to the host and decode them (:meth:`_decode`)
        under the served version."""
        return self._decode(take, bucket, self._wait(out), self._version)

    def _decode(self, take, bucket: int, out: np.ndarray, version: int,
                delta_seq: int = 0) -> List[SearchResult]:
        """Per-request results from the host verdicts: one ``flatnonzero``
        over the batch's rows, split by row; ``matches`` is the request's
        row of the verdicts."""
        ids, n_kmers = _columns(take)
        n = len(ids)
        hits = out[:n]
        # the flat form: a 2-D nonzero costs ten times as much
        flat, width = np.flatnonzero(hits), hits.shape[1]
        ends = np.searchsorted(flat, np.arange(n + 1) * width).tolist()
        col = (flat % width).tolist()
        fids = [tuple(col[a:b]) for a, b in zip(ends, ends[1:])]
        # positional: (request_id, matches, file_ids, n_kmers, bucket,
        # version, delta_seq), a third cheaper than by keyword
        return [SearchResult(rid, m, f, n_k, bucket, version, delta_seq)
                for rid, m, f, n_k in zip(ids, hits, fids, n_kmers)]

    def _flush_bucket(self, bucket: int) -> None:
        queue = self._pending.get(bucket, [])
        take, self._pending[bucket] = \
            queue[:self.config.max_batch], queue[self.config.max_batch:]
        if not take:
            return
        results, t_obs = self._serve(take, bucket,
                                     self._filling.pop(bucket, None))
        for res in results:
            self._results[res.request_id] = res
        if self._pending[bucket]:         # the rest starts the next batch
            self._filling[bucket] = t_obs

    def _serve(self, take, bucket: int, t_fill: Optional[float]
               ) -> Tuple[List[SearchResult], float]:
        """Run one batch through the pipeline and its accounting: its
        results, and the end of its ``obs`` stage. ``t_fill`` starts its
        ``admit`` stage (None: the flush itself)."""
        t0 = obs_trace.now()
        batch, valid, need = self._assemble(take, bucket)
        t_asm = obs_trace.now()
        out = self._execute(bucket, batch, valid, need)
        t_exec = self._t_copied = obs_trace.now()
        results = self._finalize(take, bucket, out)
        t_done = obs_trace.now()
        self._record_stages(t0 if t_fill is None else t_fill, t0, t_exec,
                            t_done)
        rows = self.config.max_batch
        self._record_batch(BatchStats(
            bucket=bucket, n_requests=len(take), batch_rows=rows,
            pad_rows=rows - len(take),
            pad_kmers=rows * bucket - sum(_columns(take)[1]),
            wall_ms=(t_done - t0) * 1e3))
        if isinstance(take, RequestBlock):
            entries = [((tid, None), take.t_enq, rid)
                       for tid, rid in zip(take.traces or (), take.ids)]
        else:
            entries = [(*self._admitted.pop(req.request_id, (None, t0)),
                        req.request_id) for req, _ in take]
        emit_request_spans(entries, bucket=bucket, t0=t0, t_asm=t_asm,
                           t_exec=t_exec, t_done=t_done,
                           version=self._version)
        return results, self._stages.lap("obs", t_done)

    # -- observability ------------------------------------------------------
    def _record_stages(self, t_fill: float, t0: float, t_exec: float,
                       t_done: float) -> None:
        """One batch's ``admit`` (``t_fill`` to the flush's ``t0``),
        ``wait`` (``t_exec`` to the copy's return, stamped by ``_wait``)
        and ``decode`` (to ``t_done``): ``wait`` + ``decode`` is the
        ``finalize`` span. A ``_finalize`` that never calls ``_wait``
        leaves the stamp at ``t_exec``: all of it is ``decode``."""
        stages, t_copied = self._stages, self._t_copied
        stages.observe("admit", t_fill, t0)
        stages.observe("wait", t_exec, t_copied)
        stages.observe("decode", t_copied, t_done)

    def _record_batch(self, bs: BatchStats) -> None:
        """Window the per-batch record and mirror the aggregates into the
        process registry."""
        self.batch_stats.append(bs)
        self._obs_requests.inc(bs.n_requests)
        self._obs_batches.inc()
        self._obs_batch_rows.inc(bs.batch_rows)
        self._obs_pad_rows.inc(bs.pad_rows)
        self._obs_pad_kmers.inc(bs.pad_kmers)

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
