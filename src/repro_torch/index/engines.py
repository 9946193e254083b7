"""The four index engines behind the :class:`GeneIndex` protocol.

Port of :mod:`repro.index.engines`:

=====================  =====================================================
Engine                 Storage (packed int32 words)
=====================  =====================================================
PackedBloomIndex       flat partitioned BF, 64-bit hash path: ``(m/32,)``
CobsIndex              size-grouped bit-sliced matrices: ``(m_g, ⌈F_g/32⌉)``
RamboIndex             stacked bucket BFs: ``(R·B, m_b/32)``
BitSlicedIndex         one bit-sliced matrix, 32-bit lane path:
                       ``(m, ⌈F/32⌉)`` (serving)
=====================  =====================================================

Inserts go through :mod:`repro_torch.index.ingest` (default backend
``"idl_insert"``; ``window_min`` sub-samples minimizers), queries through
:mod:`repro_torch.index.query` (default backend ``"idl_probe"``;
``dedup=True`` probes each distinct kmer once); ``mesh`` is the
``"sharded"`` backends' tuple of devices. Inserts update the words in
place; the input value is marked consumed (``donate=False`` inserts into a
copy). Every engine is a view over an :class:`IndexState` (``.state``,
``.with_state``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core import hashing, idl as idl_mod
from repro_torch.index import ingest, packed, query, registry
from repro_torch.index import state as state_mod
from repro_torch.kernels.rambo_merge import kernel as merge_kernel
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace


class _StateView:
    """Every engine is a thin view over an :class:`IndexState`, and its
    verdicts are the one rule (:func:`~repro_torch.index.state.verdicts`)
    over its ``query_batch``."""

    @property
    def state(self) -> state_mod.IndexState:
        return state_mod.from_engine(self)

    def with_state(self, state: state_mod.IndexState):
        """Rebuild an engine view over ``state`` (same kind required)."""
        kind = state_mod.from_engine(self).meta.engine
        if state.meta.engine != kind:
            raise ValueError(
                f"with_state: state is for engine {state.meta.engine!r}, "
                f"this view is {kind!r}")
        return state_mod.to_engine(state)

    def coverage_batch(self, reads, theta: float = 1.0, *, valid=None,
                       need=None, backend: str = "idl_probe",
                       dedup: bool = False, mesh=None) -> torch.Tensor:
        """(B, n_files) bool (the flat filter: (B, 1)): whether each file's
        kmer coverage reaches ``theta``, or ``need`` (B,) hits per row;
        ``valid`` (B, n_kmers) bool excludes padding kmers."""
        per = self.query_batch(reads, backend=backend, dedup=dedup,
                               mesh=mesh)
        return state_mod.verdicts(self.state.meta, per, theta, valid=valid,
                                  need=need)

    def msmt(self, reads, theta: float = 1.0, **kw) -> torch.Tensor:
        """Multiple-set membership at kmer coverage ``theta``: the
        unpadded :meth:`coverage_batch`."""
        return self.coverage_batch(reads, theta, **kw)


def _as_file_ids(file_ids, batch: int, n_files: int) -> np.ndarray:
    if file_ids is None:
        raise ValueError("this engine requires file_ids for insert_batch")
    if isinstance(file_ids, torch.Tensor):
        file_ids = file_ids.cpu().numpy()
    arr = np.atleast_1d(np.asarray(file_ids, dtype=np.int64))
    if arr.shape != (batch,):
        raise ValueError(f"file_ids shape {arr.shape} != batch ({batch},)")
    # a file id past the last word column would address the next row's
    # words (or memory past the matrix), so it is refused here
    if arr.min() < 0 or arr.max() >= n_files:
        raise ValueError(f"file ids must lie in [0, {n_files}), got "
                         f"[{arr.min()}, {arr.max()}]")
    return arr


@dataclasses.dataclass(frozen=True)
class PackedBloomIndex(_StateView):
    """Single-set partitioned BF over any registered hash scheme."""

    cfg: idl_mod.IDLConfig
    scheme: str = "idl"
    words: Optional[torch.Tensor] = None     # (m/32,) int32

    def __post_init__(self):
        if self.cfg.m % 32:
            raise ValueError(f"m={self.cfg.m} must be a multiple of 32")
        if self.words is None:
            object.__setattr__(self, "words", torch.zeros(
                (self.cfg.m // 32,), dtype=torch.int32, device="cuda"))

    @classmethod
    def build(cls, cfg: idl_mod.IDLConfig, scheme: str = "idl",
              device="cuda") -> "PackedBloomIndex":
        registry.check_config(cfg, scheme)
        return cls(cfg=cfg, scheme=scheme, words=torch.zeros(
            (cfg.m // 32,), dtype=torch.int32, device=device))

    @property
    def _shape(self) -> tuple[int, int]:
        return (self.cfg.m // 32, 1)

    def insert_batch(self, reads, file_ids=None, *,
                     backend: str = "idl_insert", donate: bool = True,
                     window_min: Optional[int] = None,
                     mesh=None) -> "PackedBloomIndex":
        """Index a (B, read_len) batch (``file_ids`` is ignored: one set),
        in place; returns the updated view and marks this one consumed
        (unless ``donate=False``, which inserts into a copy)."""
        del file_ids
        state_mod.ensure_live(self, what="engine")
        reads = query.as_reads(reads, self.words.device)
        plan = ingest.plan_insert(
            self.cfg, self.scheme, tuple(reads.shape), self._shape,
            kind="bits", window_min=window_min, device=self.words.device)
        words = plan.execute(self.words, reads, backend=backend,
                             donate=donate, mesh=mesh)
        if donate:
            state_mod.mark_consumed(self)
        return dataclasses.replace(self, words=words)

    def query_batch(self, reads, *, backend: str = "idl_probe",
                    dedup: bool = False, mesh=None) -> torch.Tensor:
        """(B, n_kmers) bool per-kmer membership."""
        state_mod.ensure_live(self, what="engine")
        reads = query.as_reads(reads, self.words.device)
        plan = query.plan_query(
            self.cfg, self.scheme, tuple(reads.shape), self._shape,
            bit_probe=True, device=self.words.device)
        return plan.execute(self.words, reads, backend=backend,
                            dedup=dedup, mesh=mesh)[..., 0] == 1

    @property
    def bits(self) -> torch.Tensor:
        """Compatibility view: (m,) uint8 bit-per-byte layout."""
        from repro_torch.core import bloom as bloom_mod

        return bloom_mod.unpack_bits(self.words)

    @property
    def fill_fraction(self) -> torch.Tensor:
        """Share of set bits, a float32 scalar (counted on the packed words
        a slice at a time, without the (m,) bit image)."""
        ones = sum(popcount32(part).sum()
                   for part in self.words.split(_POPCOUNT_SLICE))
        return torch.as_tensor(ones).to(torch.float32) / self.cfg.m


# words per popcount pass: bounds the int64 temporaries to 32 MiB
_POPCOUNT_SLICE = 1 << 22


def popcount32(words: torch.Tensor) -> torch.Tensor:
    """Set bits of each int32 word, as int64 (a SWAR count)."""
    x = words.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


# ---------------------------------------------------------------------------
# COBS: the compact bit-sliced signature index (size-grouped).
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CobsGroupState:
    """One size group: files sharing a filter size ``cfg.m``."""

    cfg: idl_mod.IDLConfig
    file_ids: tuple[int, ...]
    words: torch.Tensor      # (m_g, ceil(n_files/32)) int32


@dataclasses.dataclass(frozen=True)
class CobsIndex(_StateView):
    """Size-grouped bit-sliced filters over N files (BIGSI/COBS layout)."""

    groups: tuple[CobsGroupState, ...]
    scheme: str
    n_files: int
    k: int

    def __post_init__(self):
        if not self.groups:
            raise ValueError("CobsIndex needs at least one group")
        ks = {g.cfg.k for g in self.groups}
        if ks != {self.k}:
            raise ValueError(
                f"groups disagree on k: {sorted(ks)} vs k={self.k}")
        # file id -> (group, column)
        object.__setattr__(self, "_slots", {
            fid: (gi, col) for gi, g in enumerate(self.groups)
            for col, fid in enumerate(g.file_ids)})

    @classmethod
    def build(cls, file_sizes: Sequence[int], base_cfg: idl_mod.IDLConfig,
              scheme: str = "idl", bits_per_kmer: float = 10.0,
              n_groups: int = 2, device="cuda") -> "CobsIndex":
        """Group files by kmer count; a group's m is sized from its largest
        file (and at least ``2·η·L``), rounded up to 4096 rows."""
        if len(file_sizes) == 0:
            raise ValueError("CobsIndex.build needs at least one file")
        registry.check_config(base_cfg, scheme)
        order = np.argsort(file_sizes)
        groups = []
        for chunk in np.array_split(order, n_groups):
            if len(chunk) == 0:
                continue
            biggest = max(int(file_sizes[i]) for i in chunk)
            m_g = _round_up(int(bits_per_kmer * biggest), 1 << 12)
            m_g = max(m_g, base_cfg.eta * (base_cfg.L * 2))
            groups.append(CobsGroupState(
                cfg=dataclasses.replace(base_cfg, m=m_g),
                file_ids=tuple(int(i) for i in chunk),
                words=torch.zeros((m_g, -(-len(chunk) // 32)),
                                  dtype=torch.int32, device=device)))
        return cls(groups=tuple(groups), scheme=scheme,
                   n_files=len(file_sizes), k=base_cfg.k)

    @property
    def device(self) -> torch.device:
        return self.groups[0].words.device

    def _slot(self, file_id: int) -> tuple[int, int]:
        try:
            return self._slots[int(file_id)]
        except KeyError:
            raise KeyError(f"file {file_id} not in any group") from None

    def insert_batch(self, reads, file_ids=None, *,
                     backend: str = "idl_insert", donate: bool = True,
                     window_min: Optional[int] = None,
                     mesh=None) -> "CobsIndex":
        """Index reads into their files' group columns (one ``"cols"``
        plan per group), in place; marks this view consumed (unless
        ``donate=False``, which inserts into copies)."""
        state_mod.ensure_live(self, what="engine")
        reads = query.as_reads(reads, self.device)
        fids = _as_file_ids(file_ids, reads.shape[0], self.n_files)
        slots = np.array([self._slot(f) for f in fids]).reshape(-1, 2)
        groups = list(self.groups)
        if not donate:      # the new value shares no group with this one
            groups = [dataclasses.replace(g, words=g.words.clone())
                      for g in groups]
        for gi in np.unique(slots[:, 0]):
            sel = np.flatnonzero(slots[:, 0] == gi)
            g = groups[gi]
            sub = reads[torch.as_tensor(sel, device=self.device)]
            plan = ingest.plan_insert(
                g.cfg, self.scheme, tuple(sub.shape), tuple(g.words.shape),
                kind="cols", window_min=window_min, device=self.device)
            plan.execute(g.words, sub, slots[sel, 1], backend=backend,
                         mesh=mesh)
        if donate:
            state_mod.mark_consumed(self)
        return dataclasses.replace(self, groups=tuple(groups))

    def query_batch(self, reads, *, backend: str = "idl_probe",
                    dedup: bool = False, mesh=None) -> torch.Tensor:
        """(B, n_kmers, n_files) bool MSMT kmer slices (Definition 3)."""
        state_mod.ensure_live(self, what="engine")
        reads = query.as_reads(reads, self.device)
        n_k = reads.shape[1] - self.k + 1
        out = torch.zeros((reads.shape[0], n_k, self.n_files),
                          dtype=torch.bool, device=self.device)
        for g in self.groups:
            plan = query.plan_query(
                g.cfg, self.scheme, tuple(reads.shape), tuple(g.words.shape),
                bit_probe=False, device=self.device)
            masks = plan.execute(g.words, reads, backend=backend, dedup=dedup,
                                 mesh=mesh)
            out[:, :, torch.as_tensor(g.file_ids, device=self.device)] = \
                packed.unpack_file_bits(masks, len(g.file_ids))
        return out

    @property
    def total_bits(self) -> int:
        return sum(int(g.cfg.m) * len(g.file_ids) for g in self.groups)


# ---------------------------------------------------------------------------
# RAMBO: repeated and merged bucketed Bloom filters.
# ---------------------------------------------------------------------------

def rambo_dimensions(n_files: int, B: Optional[int] = None,
                     R: Optional[int] = None) -> tuple[int, int]:
    """Default RAMBO shape: B = O(sqrt N) buckets, R = O(log N)
    repetitions."""
    if B is None:
        B = max(2, int(np.ceil(np.sqrt(n_files))))
    if R is None:
        R = max(2, int(np.ceil(np.log2(max(n_files, 2)))))
    return B, R


@functools.lru_cache(maxsize=64)
def rambo_assignment(n_files: int, n_buckets: int, n_rep: int) -> np.ndarray:
    """(R, N) int32 file -> bucket map (the query path's hash family).
    Made once a shape and shared by every caller, which reads it only: an
    engine view is rebuilt from its state on every served batch."""
    files = np.arange(n_files, dtype=np.uint64)
    return np.stack([
        hashing.np_hash_to_range(files, 0xA3B0 + r, n_buckets).astype(np.int32)
        for r in range(n_rep)], axis=0)


def rambo_merge(grid: torch.Tensor, assignment) -> torch.Tensor:
    """RAMBO's R-fold merge: (..., R·B) bool bucket hits and the (R, N)
    file -> bucket ``assignment`` -> (..., N) bool per-file hits, a file's
    bucket hit in all R repetitions (an AND accumulated over R, never an
    (..., R, N) intermediate). Records nothing."""
    asn = torch.as_tensor(assignment, dtype=torch.int64, device=grid.device)
    grid = grid.unflatten(-1, (asn.shape[0], -1))
    out = grid[..., 0, asn[0]]
    for r in range(1, asn.shape[0]):
        out &= grid[..., r, asn[r]]
    return out


@dataclasses.dataclass(frozen=True)
class RamboIndex(_StateView):
    """B buckets × R repetitions of merged BFs; sub-linear MSMT."""

    cfg: idl_mod.IDLConfig                 # cfg.m = bits per bucket BF
    scheme: str
    n_files: int
    n_buckets: int                         # B
    n_rep: int                             # R
    words: torch.Tensor                    # (R·B, m/32) int32
    assignment: Optional[np.ndarray] = None

    def __post_init__(self):
        if self.cfg.m % 32:
            raise ValueError(
                f"bucket size m={self.cfg.m} must be a multiple of 32")
        if self.assignment is None:
            object.__setattr__(self, "assignment", rambo_assignment(
                self.n_files, self.n_buckets, self.n_rep))

    @classmethod
    def build(cls, n_files: int, cfg: idl_mod.IDLConfig, scheme: str = "idl",
              B: Optional[int] = None, R: Optional[int] = None,
              device="cuda") -> "RamboIndex":
        registry.check_config(cfg, scheme)
        B, R = rambo_dimensions(n_files, B, R)
        return cls(cfg=cfg, scheme=scheme, n_files=n_files, n_buckets=B,
                   n_rep=R, words=torch.zeros((R * B, cfg.m // 32),
                                              dtype=torch.int32,
                                              device=device))

    def _filter_rows(self, fids: np.ndarray) -> np.ndarray:
        """(B, R) filter rows of each read's file."""
        offs = np.arange(self.n_rep, dtype=np.int64) * self.n_buckets
        return self.assignment[:, fids].T + offs[None, :]

    @property
    def _words_t(self) -> torch.Tensor:
        """The contiguous ``(m/32, R·B)`` transposed copy the query layer
        probes, made once per words tensor and kept on it. Inserts update
        the words in place, so every insert drops the copy first
        (:func:`_drop_transposed`)."""
        return transposed_words(self.words)

    def insert_batch(self, reads, file_ids=None, *,
                     backend: str = "idl_insert", donate: bool = True,
                     window_min: Optional[int] = None,
                     mesh=None) -> "RamboIndex":
        """Index reads into their R bucket filters (one ``"rows"`` plan), in
        place; marks this view consumed (unless ``donate=False``)."""
        state_mod.ensure_live(self, what="engine")
        reads = query.as_reads(reads, self.words.device)
        fids = _as_file_ids(file_ids, reads.shape[0], self.n_files)
        plan = ingest.plan_insert(
            self.cfg, self.scheme, tuple(reads.shape), tuple(self.words.shape),
            kind="rows", window_min=window_min, device=self.words.device)
        if donate:
            _drop_transposed(self.words)
        words = plan.execute(self.words, reads, self._filter_rows(fids),
                             backend=backend, donate=donate, mesh=mesh)
        if donate:
            state_mod.mark_consumed(self)
        return dataclasses.replace(self, words=words)

    def _probe(self, reads, backend: str, dedup: bool, mesh
               ) -> torch.Tensor:
        """(B, n_kmers, R·B) int32 {0, 1}: every bucket filter's answer per
        kmer. The R·B filters are probed as one transposed ``(m/32, R·B)``
        bit matrix: each location resolves every bucket's bit from one
        row."""
        state_mod.ensure_live(self, what="engine")
        reads = query.as_reads(reads, self.words.device)
        plan = query.plan_query(
            self.cfg, self.scheme, tuple(reads.shape),
            (self.cfg.m // 32, self.n_rep * self.n_buckets), bit_probe=True,
            device=self.words.device)
        return plan.execute(self._words_t, reads, backend=backend,
                            dedup=dedup, mesh=mesh)

    def query_grid(self, reads, *, backend: str = "idl_probe",
                   dedup: bool = False, mesh=None) -> torch.Tensor:
        """(B, n_kmers, R, buckets) bool: bucket hits per kmer."""
        vals = self._probe(reads, backend, dedup, mesh)
        return (vals == 1).reshape(vals.shape[:2]
                                   + (self.n_rep, self.n_buckets))

    def query_batch(self, reads, *, backend: str = "idl_probe",
                    dedup: bool = False, mesh=None) -> torch.Tensor:
        """(B, n_kmers, n_files) bool: :func:`rambo_merge` of the bucket
        hits, for the callers that need per-kmer hits (the membership
        cache, the LSM and live indexes). The merge's host time, its R
        gathers and R - 1 ANDs enqueued with no wait, is
        ``planner.stage_ms{op=query, stage=merge}``; each call counts in
        ``index.rambo_merges{path=per_kmer}``."""
        grid = self._probe(reads, backend, dedup, mesh) == 1
        t0 = obs_trace.now()
        out = rambo_merge(grid, self._assign_on_device)
        query.record_stage("query", "merge", t0)
        _count_merge("per_kmer")
        return out

    def coverage_batch(self, reads, theta: float = 1.0, *, valid=None,
                       need=None, backend: str = "idl_probe",
                       dedup: bool = False, mesh=None) -> torch.Tensor:
        """(B, n_files) bool: whether each file's kmer hits (a hit in all R
        repetitions) reach ``need`` (B,) per row, or ``theta``'s
        :func:`~repro_torch.index.query.coverage_need` of the kmer axis;
        ``valid`` (B, n_kmers) bool excludes padding kmers. The same
        verdicts as :func:`~repro_torch.index.state.verdicts` over
        :meth:`query_batch`, with the merge and the count in one launch of
        ``rambo_merge_coverage`` on the probe's answers (its plain version
        on a CPU index). The launch's host time is ``planner.stage_ms{op=
        query, stage=merge}``; each call counts in
        ``index.rambo_merges{path=fused}``."""
        vals = self._probe(reads, backend, dedup, mesh)
        t0 = obs_trace.now()
        if need is None:
            need = query.coverage_need(theta, vals.shape[1])
        else:
            need = torch.as_tensor(need, dtype=torch.int32,
                                   device=vals.device)
        if valid is not None:
            valid = torch.as_tensor(valid, dtype=torch.bool,
                                    device=vals.device)
        out = merge_kernel.merge_coverage(vals, self._assign_on_device, need,
                                          valid)
        query.record_stage("query", "merge", t0)
        _count_merge("fused")
        return out

    @property
    def _assign_on_device(self) -> torch.Tensor:
        """The (R, N) int32 assignment on the words' device, moved there
        once and kept on the words tensor, as the transposed copy is (an
        index view is rebuilt from its state every served batch)."""
        cached = getattr(self.words, _ASSIGNED, None)
        if cached is None or cached[0] is not self.assignment:
            a = np.asarray(self.assignment)
            if a.shape != (self.n_rep, self.n_files) or (
                    a.size and not 0 <= a.min() <= a.max() < self.n_buckets):
                raise ValueError(
                    f"RAMBO assignment must map ({self.n_rep}, "
                    f"{self.n_files}) to buckets [0, {self.n_buckets})")
            cached = (self.assignment, torch.as_tensor(
                a, dtype=torch.int32, device=self.words.device).contiguous())
            setattr(self.words, _ASSIGNED, cached)
        return cached[1]

    @property
    def total_bits(self) -> int:
        return int(self.words.shape[0]) * int(self.words.shape[1]) * 32


# the attributes of a RAMBO words tensor that hold its transposed copy and
# its index's assignment on the device
_TRANSPOSED = "_rambo_words_t"
_ASSIGNED = "_rambo_assignment"


def _count_merge(path: str) -> None:
    """Count one merged batch in ``index.rambo_merges{path=...}``: ``fused``
    (:meth:`RamboIndex.coverage_batch`) or ``per_kmer``
    (:meth:`RamboIndex.query_batch`)."""
    counter = _MERGES.get(path)
    if counter is None:
        counter = _MERGES[path] = obs_metrics.DEFAULT.counter(
            "index.rambo_merges", path=path)
    counter.inc()


_MERGES: dict = {}


def transposed_words(words: torch.Tensor) -> torch.Tensor:
    """The contiguous transpose of a RAMBO words tensor (or a word shard of
    it), made once and kept on the tensor until :func:`_drop_transposed`.
    Each copy made counts in ``index.transposed_copies`` and its bytes in
    ``index.transposed_bytes`` (``engine=rambo``); its host time, the copy
    enqueued with no wait, is ``planner.stage_ms{op=query,
    stage=transpose}``."""
    cached = getattr(words, _TRANSPOSED, None)
    if cached is None:
        t0 = obs_trace.now()
        cached = words.t().contiguous()
        query.record_stage("query", "transpose", t0)
        setattr(words, _TRANSPOSED, cached)
        reg = obs_metrics.DEFAULT
        reg.counter("index.transposed_copies", engine="rambo").inc()
        reg.counter("index.transposed_bytes", engine="rambo").inc(
            cached.nbytes)
    return cached


def _drop_transposed(words: torch.Tensor) -> None:
    """Forget the transposed copy kept on ``words`` (before an in-place
    insert changes them)."""
    if getattr(words, _TRANSPOSED, None) is not None:
        setattr(words, _TRANSPOSED, None)


@dataclasses.dataclass(frozen=True)
class BitSlicedIndex(_StateView):
    """One bit-sliced (m, F/32) int32 matrix on the 32-bit lane path."""

    cfg: idl_mod.IDLConfig
    scheme: str
    n_files: int
    words: torch.Tensor      # (m, ceil(n_files/32)) int32

    @classmethod
    def build(cls, cfg: idl_mod.IDLConfig, scheme: str = "idl",
              n_files: int = 1024, device="cuda") -> "BitSlicedIndex":
        registry.check_config(cfg, scheme)
        w = -(-n_files // 32)
        return cls(cfg=cfg, scheme=scheme, n_files=n_files,
                   words=torch.zeros((cfg.m, w), dtype=torch.int32,
                                     device=device))

    def insert_batch(self, reads, file_ids=None, *,
                     backend: str = "idl_insert", donate: bool = True,
                     window_min: Optional[int] = None,
                     mesh=None) -> "BitSlicedIndex":
        """Index reads into their file columns, in place; returns the
        updated view and marks this one consumed (unless ``donate=False``,
        which inserts into a copy)."""
        state_mod.ensure_live(self, what="engine")
        reads = query.as_reads(reads, self.words.device)
        fids = _as_file_ids(file_ids, reads.shape[0], self.n_files)
        plan = ingest.plan_insert(
            self.cfg, self.scheme, tuple(reads.shape), tuple(self.words.shape),
            kind="cols", lane32=True, window_min=window_min,
            device=self.words.device,
        )
        words = plan.execute(self.words, reads, fids, backend=backend,
                             donate=donate, mesh=mesh)
        if donate:
            state_mod.mark_consumed(self)
        return dataclasses.replace(self, words=words)

    def query_batch(self, reads, *, backend: str = "idl_probe",
                    dedup: bool = False, mesh=None) -> torch.Tensor:
        """(B, n_kmers, F/32) int32 per-kmer file masks (packed)."""
        state_mod.ensure_live(self, what="engine")
        reads = query.as_reads(reads, self.words.device)
        plan = query.plan_query(
            self.cfg, self.scheme, tuple(reads.shape), tuple(self.words.shape),
            bit_probe=False, lane32=True, device=self.words.device,
        )
        return plan.execute(self.words, reads, backend=backend, dedup=dedup,
                            mesh=mesh)


def _round_up(x: int, align: int) -> int:
    return -(-x // align) * align
