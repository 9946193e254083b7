"""Gene-search serving: typed requests, shape-bucketed dynamic batching.

Port of :mod:`repro.serving.service` for all four engines (the membership
cache is left out).

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

BACKENDS = ("torch", "idl_probe")

# distinguishes each service instance's counter series in the registry
_SERVICE_IDS = itertools.count()


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (n >= 1)."""
    return 1 << max(int(n) - 1, 0).bit_length()


def bucket_for(n_kmers: int, min_bucket_kmers: int = 32) -> int:
    """The pow2 kmer bucket a request with ``n_kmers`` kmers lands in."""
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
    or ``()`` for the flat filter)."""

    request_id: int
    matches: np.ndarray
    file_ids: Tuple[int, ...]
    n_kmers: int
    bucket: int


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
    backend: str = "idl_probe"    # "idl_probe" | "torch"
    max_batch: int = 8            # rows per bucket step (fixed batch shape)
    min_bucket_kmers: int = 32    # floor of the pow2 kmer buckets
    auto_flush: bool = True       # flush a bucket once max_batch are waiting
    stats_window: int = 4096      # batches of telemetry kept (bounded)

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
                       t_exec: float, t_done: float) -> None:
    """Emit the per-request span chain (``request`` root with
    ``queue_wait → assemble → execute → finalize`` children) for one
    finalized batch; ``entries`` is ``[(trace_ctx, t_enq, request_id)]``."""
    trc = obs_trace.DEFAULT
    if not trc.enabled:
        return
    stages = (("assemble", t0, t_asm), ("execute", t_asm, t_exec),
              ("finalize", t_exec, t_done))
    trc.emit_request_chains(
        [(ctx[0], ctx[1], t_enq, rid)
         for ctx, t_enq, rid in entries if ctx is not None],
        t0, stages, t_done, shared_attrs={"bucket": bucket})


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

    def __init__(self, index, config: Optional[ServiceConfig] = None):
        self.config = config or ServiceConfig()
        self._state = state_mod.from_engine(index)
        self._k = state_mod.kmer_size(self._state.meta)
        self._next_id = 0
        self._pending: Dict[int, List[Tuple[SearchRequest, int]]] = {}
        self._results: Dict[int, SearchResult] = {}
        self._inflight: set = set()
        self._runners: Dict[int, object] = {}
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
    def n_files(self) -> int:
        return int(self._state.meta.n_files or 1)

    # -- admission ----------------------------------------------------------
    def bucket_for(self, n_kmers: int) -> int:
        return bucket_for(n_kmers, self.config.min_bucket_kmers)

    def submit(self, request: Union[SearchRequest, np.ndarray]) -> int:
        """Enqueue one read; returns its request id. With ``auto_flush`` the
        bucket executes as soon as ``max_batch`` requests are waiting."""
        request, n_kmers = normalize_request(request, self._k)
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
        """The cached step for one bucket: probe (the configured backend),
        then the padding-aware coverage postlude."""
        step = self._runners.get(bucket)
        if step is None:
            reduce = functools.partial(
                _msmt_reduce, self._state.meta.engine, self.n_files,
                self.config.theta)
            backend = self.config.backend

            def step(state, reads, valid, need):
                per = state_mod.to_engine(state).query_batch(
                    reads, backend=backend)
                return reduce(per, valid, need)

            self._runners[bucket] = step
        return step

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
        (max_batch, n_files) bool verdicts there."""
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
                n_kmers=n_k, bucket=bucket))
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
                           t_exec=t_exec, t_done=t_done)

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

    def requests_served(self) -> int:
        """Lifetime requests served (registry-backed)."""
        return int(self._obs_requests.value)

    def occupancy(self) -> float:
        """Fraction of batch rows that carried real requests (lifetime)."""
        rows = self._obs_batch_rows.value
        return self._obs_requests.value / rows if rows else 0.0
