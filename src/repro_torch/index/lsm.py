"""LSM-style live index: immutable base + small delta + write-ahead journal.

Port of :mod:`repro.index.lsm`. Two algebraic facts make a live write
path exact for every engine:

* scatter-OR inserts are **idempotent and commutative**, so the union of
  two indexes built from read sets A and B equals one index built from
  A ∪ B, bit for bit;
* a match mask is a **conjunction over kmers of per-kmer memberships**,
  so OR-ing the per-kmer membership of two indexes *before* the integer
  coverage threshold answers exactly like the single merged index.

:class:`LiveIndex` holds an immutable **base** :class:`IndexState` plus a
small **delta** :class:`IndexState` that absorbs streaming inserts through
the shared ingest path. The delta shares the base's ``StateMeta`` by
default; for the bit-probe engines (flat BF, RAMBO) a second, smaller-``m``
:class:`IDLConfig` may size the delta independently. Row-probe engines
(COBS, bit-sliced) share row geometry with the base.

Durability is a write-ahead **delta journal** (:class:`DeltaJournal`, the
``IDLJ`` v1 format, byte for byte the reference's): an append-only file
of read batches, each CRC-32 framed, written *before* the delta absorbs
the batch. Boot replays it into a fresh delta (:meth:`LiveIndex.open`); a
torn tail record is detected and dropped.

Compaction folds delta into base off the hot path: with the same
geometry, one elementwise OR of the words (:func:`or_states`); a
smaller-``m`` delta is folded by replaying the journaled batches through
the base's own insert plan. The merged state keeps the base ``StateMeta``;
:meth:`LiveIndex.publish` swaps it in and rebuilds the delta from batches
that arrived mid-compaction. The journal is truncated only once the merged
base reached stable storage.

In-place writes. The port's inserts update words in place (the reference
donates and relies on fresh buffers), so each place where the reference
leans on a fresh buffer copies instead: :func:`or_states` is out of place
(its ``base`` is still serving), :meth:`LiveIndex.plan_compaction` clones
the delta it freezes, and the replay compaction's first insert into the
serving base uses ``donate=False`` (a copy). Only the delta is ever
written in place, and only on the one dispatch thread.
"""

from __future__ import annotations

import dataclasses
import os
import struct
import threading
import zlib
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import idl as idl_mod
from repro_torch.index import store
from repro_torch.index import state as state_mod

__all__ = [
    "DeltaJournal",
    "JournalError",
    "LiveIndex",
    "CompactionPlan",
    "empty_delta",
    "merge_kmer_hits",
    "or_states",
    "merged_msmt",
]


# ---------------------------------------------------------------------------
# The write-ahead delta journal.
# ---------------------------------------------------------------------------

class JournalError(RuntimeError):
    """A journal file failed structural validation (not a torn tail)."""


_MAGIC = b"IDLJ"
_VERSION = 1
_HEADER = struct.Struct("<4sI")           # magic, version
_REC = struct.Struct("<QIIi")             # seq, n_reads, read_len, n_fids


@dataclasses.dataclass(frozen=True)
class JournalRecord:
    """One journaled write batch (reads + optional file ids)."""

    seq: int
    reads: np.ndarray                     # (B, read_len) uint8
    file_ids: Optional[np.ndarray]        # (B,) int32 or None


class DeltaJournal:
    """Append-only, CRC-framed write-ahead log of insert batches.

    Frame layout per record::

        <Q seq> <I n_reads> <I read_len> <i n_fids> <payload> <I crc32>

    ``n_fids`` is ``-1`` when the batch carried no file ids (single-set
    engines); the payload is the raw uint8 read bytes followed by int32
    file-id bytes; the CRC covers header + payload. Appends ``flush`` +
    ``fsync`` before returning, so an acked write survives a crash; a torn
    tail (crash mid-append) fails its CRC or length check on replay and is
    discarded — it was never acked. A bad record with valid records after
    it is NOT a torn tail: that is mid-file corruption of acked writes,
    and the constructor raises :class:`JournalError` rather than silently
    truncating them (see :meth:`_scan`).
    """

    def __init__(self, path: str):
        self.path = str(path)
        self._lock = threading.Lock()
        tail = self._scan()
        self._fh = open(self.path, "ab")
        if self._fh.tell() > tail:        # physically drop a torn tail so
            self._fh.truncate(tail)       # new appends don't land after it
            self._fh.seek(tail)

    def _scan(self) -> int:
        """Validate the file; returns the byte offset after the last good
        record (creating the header if the file is new/empty).

        Only a TORN TAIL may be dropped: the final record failing its CRC
        or running past EOF is a crash mid-append (never acked). A bad
        record with a structurally valid, CRC-passing record anywhere
        after it is mid-file corruption of acked writes — that raises
        :class:`JournalError` instead of silently truncating them away.
        """
        if not os.path.exists(self.path) or os.path.getsize(self.path) == 0:
            with open(self.path, "wb") as fh:
                fh.write(_HEADER.pack(_MAGIC, _VERSION))
            return _HEADER.size
        with open(self.path, "rb") as fh:
            data = fh.read()
        if len(data) < _HEADER.size:
            raise JournalError(f"{self.path}: truncated journal header")
        magic, version = _HEADER.unpack(data[:_HEADER.size])
        if magic != _MAGIC:
            raise JournalError(
                f"{self.path}: not a delta journal (magic {magic!r})")
        if version > _VERSION:
            raise JournalError(
                f"{self.path}: journal version {version} is newer than "
                f"supported {_VERSION}")
        good = _HEADER.size
        while True:
            parsed = self._parse_record(data, good)
            if parsed is None:
                break
            good = parsed[1]
        if good < len(data):
            # a record failed at `good`. A torn tail is the ONLY thing we
            # may drop — probe every later offset for a valid record; a
            # hit means the middle of the file rotted under acked writes.
            probe = good + 1
            while probe + _REC.size + 4 <= len(data):
                if self._parse_record(data, probe) is not None:
                    raise JournalError(
                        f"{self.path}: corrupt record at byte {good} with "
                        f"valid records after it — mid-file corruption, "
                        f"not a torn tail; refusing to drop acked writes")
                probe += 1
        return good

    @staticmethod
    def _parse_record(data: bytes, off: int
                      ) -> Optional[Tuple[JournalRecord, int]]:
        """Try to parse one CRC-framed record at byte offset ``off``.

        Returns ``(record, next_offset)``, or None when no structurally
        valid record starts here (frame runs past EOF, or CRC mismatch —
        a header's declared gigabytes just fail the bounds check, nothing
        is ever allocated beyond what the buffer holds).
        """
        if off + _REC.size > len(data):
            return None
        head = data[off:off + _REC.size]
        seq, n_reads, read_len, n_fids = _REC.unpack(head)
        payload_len = n_reads * read_len + max(n_fids, 0) * 4
        end = off + _REC.size + payload_len + 4
        if end > len(data):
            return None
        payload = data[off + _REC.size:end - 4]
        if zlib.crc32(payload, zlib.crc32(head)) != \
                struct.unpack("<I", data[end - 4:end])[0]:
            return None
        reads = np.frombuffer(payload[:n_reads * read_len],
                              dtype=np.uint8).reshape(n_reads, read_len)
        fids = None
        if n_fids >= 0:
            fids = np.frombuffer(payload[n_reads * read_len:],
                                 dtype=np.int32).copy()
        return JournalRecord(seq=seq, reads=reads.copy(), file_ids=fids), end

    def append(self, seq: int, reads: np.ndarray,
               file_ids: Optional[np.ndarray]) -> None:
        reads = np.ascontiguousarray(reads, dtype=np.uint8)
        if reads.ndim == 1:
            reads = reads[None]
        fids = (None if file_ids is None
                else np.ascontiguousarray(file_ids, dtype=np.int32).reshape(-1))
        head = _REC.pack(int(seq), reads.shape[0], reads.shape[1],
                         -1 if fids is None else fids.shape[0])
        payload = reads.tobytes() + (b"" if fids is None else fids.tobytes())
        crc = zlib.crc32(payload, zlib.crc32(head))
        with self._lock:
            self._fh.write(head + payload + struct.pack("<I", crc))
            self._fh.flush()
            os.fsync(self._fh.fileno())

    def records(self) -> List[JournalRecord]:
        """Every valid record in order (the boot-replay stream)."""
        out: List[JournalRecord] = []
        with self._lock:
            self._fh.flush()
        with open(self.path, "rb") as fh:
            data = fh.read()
        off = _HEADER.size
        while True:
            parsed = self._parse_record(data, off)
            if parsed is None:
                return out
            rec, off = parsed
            out.append(rec)

    def truncate_through(self, upto_seq: int) -> None:
        """Drop records with ``seq <= upto_seq`` (post-compaction), keeping
        later ones — rewritten atomically via a temp file + ``os.replace``."""
        keep = [r for r in self.records() if r.seq > upto_seq]
        tmp = self.path + ".tmp"
        with open(tmp, "wb") as fh:
            fh.write(_HEADER.pack(_MAGIC, _VERSION))
            for r in keep:
                head = _REC.pack(r.seq, r.reads.shape[0], r.reads.shape[1],
                                 -1 if r.file_ids is None
                                 else r.file_ids.shape[0])
                payload = r.reads.tobytes() + (
                    b"" if r.file_ids is None else r.file_ids.tobytes())
                crc = zlib.crc32(payload, zlib.crc32(head))
                fh.write(head + payload + struct.pack("<I", crc))
            fh.flush()
            os.fsync(fh.fileno())
        with self._lock:
            self._fh.close()
            os.replace(tmp, self.path)
            self._fh = open(self.path, "ab")

    def close(self) -> None:
        with self._lock:
            if not self._fh.closed:
                self._fh.close()


# ---------------------------------------------------------------------------
# Delta construction + merge algebra.
# ---------------------------------------------------------------------------

def empty_delta(base: state_mod.IndexState,
                delta_cfg: Optional[idl_mod.IDLConfig] = None
                ) -> state_mod.IndexState:
    """A zeroed delta state for ``base``.

    Default: the base's exact ``StateMeta`` (same word shapes — the
    word-OR compaction fast path applies). ``delta_cfg`` sizes a smaller
    delta for the bit-probe engines (flat BF, RAMBO): any ``m`` keeps the
    two-probe merge exact because the delta is probed with its own plan.
    Row-probe engines (COBS, bit-sliced) must share base geometry — their
    row count is the hash range itself.
    """
    meta = base.meta
    if delta_cfg is None:
        return state_mod.IndexState(
            words=tuple(torch.zeros_like(w) for w in base.words), meta=meta)
    if meta.engine not in ("bloom", "rambo"):
        raise ValueError(
            f"delta_cfg is only meaningful for bit-probe engines "
            f"(bloom, rambo); {meta.engine!r} deltas share the base row "
            f"geometry")
    cfg = meta.cfgs[0]
    if delta_cfg.k != cfg.k:
        raise ValueError(
            f"delta kmer size {delta_cfg.k} != base kmer size {cfg.k}")
    if delta_cfg.m % 32:
        raise ValueError(f"delta m={delta_cfg.m} must be a multiple of 32")
    new_meta = dataclasses.replace(meta, cfgs=(delta_cfg,))
    if meta.engine == "bloom":
        shape = (delta_cfg.m // 32,)
    else:                                  # rambo: (R*B, m/32) bucket stack
        shape = (meta.n_rep * meta.n_buckets, delta_cfg.m // 32)
    words = (torch.zeros(shape, dtype=torch.int32, device=base.device),)
    return state_mod.IndexState(words=words, meta=new_meta)


def merge_kmer_hits(per_base: torch.Tensor, per_delta: torch.Tensor
                    ) -> torch.Tensor:
    """OR per-kmer membership of base and delta — the two-probe merge (out
    of place).

    Works on every engine's ``query_batch`` output: bool membership
    ((B, n_k) flat BF; (B, n_k, n_files) COBS/RAMBO) and packed int32
    file masks ((B, n_k, W) bit-sliced). Because a match is a conjunction
    of per-kmer hits, OR-ing *before* the integer coverage threshold is
    exactly the answer a single merged index would give (equivalently:
    the AND of the two indexes' miss-masks).
    """
    return per_base | per_delta


def or_states(base: state_mod.IndexState,
              delta: state_mod.IndexState) -> state_mod.IndexState:
    """Elementwise OR of two same-geometry states — the compaction fast
    path, one ``torch.bitwise_or`` per word matrix into new tensors, never
    in place: ``base`` keeps serving while the merge computes off the hot
    path. The result carries the base's meta."""
    if len(base.words) != len(delta.words) or any(
            a.shape != b.shape for a, b in zip(base.words, delta.words)):
        raise ValueError("or_states needs two states of one geometry")
    return state_mod.IndexState(
        words=tuple(torch.bitwise_or(a, b)
                    for a, b in zip(base.words, delta.words)),
        meta=base.meta)


def merged_msmt(base: state_mod.IndexState, delta: state_mod.IndexState,
                reads, theta: float = 1.0, *, backend: str = "idl_probe",
                **kw) -> torch.Tensor:
    """MSMT over the logical union of base and delta (two-probe merge).

    The reference the serving layer's batched steps are tested against:
    per-kmer outputs of both states OR-ed before the one verdict rule
    (:func:`~repro_torch.index.state.verdicts`).
    """
    per = merge_kmer_hits(
        state_mod.query(base, reads, backend=backend, **kw),
        state_mod.query(delta, reads, backend=backend, **kw))
    return state_mod.verdicts(base.meta, per, theta)


# ---------------------------------------------------------------------------
# The live index.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CompactionPlan:
    """Snapshot of (base, delta, watermark) taken at plan time.

    The expensive merge runs off the hot path on these immutable values;
    writes that land after ``upto_seq`` stay in the live delta and are
    replayed into the fresh delta at publish time.
    """

    base: state_mod.IndexState
    delta: state_mod.IndexState
    upto_seq: int
    base_version: int
    tail: Tuple[JournalRecord, ...]       # records with seq <= upto_seq


class LiveIndex:
    """Immutable base + mutable delta + write-ahead journal.

    Thread model: ``insert`` / ``publish`` mutate under an internal lock
    and :meth:`states` hands out an atomic ``(base, delta, version, seq)``
    snapshot, but the *storage values* follow the repo's linear-use rule —
    an insert updates the delta's words in place and marks the previous
    delta value consumed. All writes and query dispatches must therefore
    happen on one thread (the serving layer's flusher thread provides
    exactly that; every launch is on the device's default stream, so a
    query enqueued before a write reads the words before the write lands);
    a compactor thread only ever touches the base, which is never written,
    and the delta copy a :class:`CompactionPlan` owns.
    """

    def __init__(self, base, *,
                 delta_cfg: Optional[idl_mod.IDLConfig] = None,
                 journal: Optional[DeltaJournal] = None,
                 base_version: int = 0, start_seq: int = 0):
        self._lock = threading.RLock()
        self._base = state_mod.from_engine(base)
        self._delta_cfg = delta_cfg
        self._delta = empty_delta(self._base, delta_cfg)
        self._journal = journal
        self._base_version = int(base_version)
        # start_seq aligns a fresh replica's watermark with a fleet-level
        # journal whose earlier records were already compacted into `base`
        self._delta_seq = int(start_seq)
        self._compacted_seq = int(start_seq)  # writes <= this live in base
        self._tail: List[JournalRecord] = []
        if journal is not None:
            for rec in journal.records():         # boot replay (crash heal)
                self._apply(rec.reads, rec.file_ids, seq=rec.seq)

    # -- construction -------------------------------------------------------
    @classmethod
    def open(cls, snapshot_dir: str, *,
             journal_path: Optional[str] = None,
             delta_cfg: Optional[idl_mod.IDLConfig] = None,
             base_version: int = 0, **load_kw) -> "LiveIndex":
        """Boot from a versioned snapshot + journal: load the base through
        the store's CRC-verified path, then replay every journaled batch
        into a fresh delta — a crash between compactions loses nothing."""
        base = store.load(snapshot_dir, **load_kw)
        journal = (DeltaJournal(journal_path)
                   if journal_path is not None else None)
        return cls(base, delta_cfg=delta_cfg, journal=journal,
                   base_version=base_version)

    # -- views --------------------------------------------------------------
    @property
    def meta(self) -> state_mod.StateMeta:
        return self._base.meta

    @property
    def base(self) -> state_mod.IndexState:
        with self._lock:
            return self._base

    @property
    def delta(self) -> state_mod.IndexState:
        with self._lock:
            return self._delta

    @property
    def base_version(self) -> int:
        with self._lock:
            return self._base_version

    @property
    def delta_seq(self) -> int:
        """Journal sequence of the last absorbed batch (0 = delta empty)."""
        with self._lock:
            return self._delta_seq

    def delta_batches(self) -> int:
        """Write batches sitting in the delta — the compaction trigger."""
        with self._lock:
            return len(self._tail)

    def states(self) -> Tuple[state_mod.IndexState, state_mod.IndexState,
                              int, int]:
        """Atomic ``(base, delta, base_version, delta_seq)`` snapshot."""
        with self._lock:
            return self._base, self._delta, self._base_version, \
                self._delta_seq

    # -- the write path -----------------------------------------------------
    def _apply(self, reads, file_ids, *, seq: int, **kw) -> None:
        """Absorb one batch into the delta (journal already holds it)."""
        fids = file_ids
        if self._delta.meta.engine == "bloom":
            fids = None
        self._delta = state_mod.insert(
            self._delta, np.asarray(reads, dtype=np.uint8),
            None if fids is None else np.asarray(fids), **kw)
        # max, not assignment: a lagging replica re-applying an explicit
        # fleet seq across a publish must never regress the watermark
        self._delta_seq = max(self._delta_seq, int(seq))
        self._tail.append(JournalRecord(
            seq=int(seq),
            reads=np.asarray(reads, dtype=np.uint8),
            file_ids=None if file_ids is None
            else np.asarray(file_ids, dtype=np.int32)))

    def insert(self, reads, file_ids=None, *, seq: Optional[int] = None,
               donate: bool = True, **kw) -> int:
        """Journal, then absorb one read batch into the delta.

        Write-ahead order: the journal append (flush + fsync) happens
        *before* the delta insert, so an acked sequence number is durable.
        ``seq`` assigns an EXPLICIT fleet-level sequence number (a router
        fanning one write-ahead-journaled stream to many replicas) instead
        of the local ``delta_seq + 1`` — so every replica's watermark is
        the fleet journal's, never a locally invented one. A ``seq`` the
        base already contains (``<=`` the last published compaction
        watermark — a lagging replica re-delivering across a publish) is
        an idempotent no-op. ``kw`` passes through to the shared ingest
        layer (``backend`` in {"torch", "idl_insert"}, ...).
        ``donate`` defaults on, matching ``state.insert``: the scatter
        updates the delta's words in place (the single-writer discipline
        means nothing else holds the pre-insert delta, and
        :meth:`plan_compaction` clones the delta it freezes). Pass
        ``donate=False`` only when an external reference to the current
        delta object must stay live across this call (one copy).
        Returns the batch's journal sequence number.
        """
        reads = np.asarray(reads, dtype=np.uint8)
        if reads.ndim == 1:
            reads = reads[None]
        with self._lock:
            seq = self._delta_seq + 1 if seq is None else int(seq)
            if seq <= self._compacted_seq:
                return seq                # already folded into the base
            if self._journal is not None:
                self._journal.append(seq, reads, file_ids)
            self._apply(reads, file_ids, seq=seq, donate=donate, **kw)
            return seq

    def replay(self, records) -> int:
        """Absorb already-journaled records at their ORIGINAL sequence
        numbers (no re-journaling) — how a router boots a fresh replica's
        delta into alignment with the fleet's write watermark. Returns the
        resulting ``delta_seq``.
        """
        with self._lock:
            for rec in records:
                self._apply(rec.reads, rec.file_ids, seq=rec.seq)
            return self._delta_seq

    # -- the merged read path ----------------------------------------------
    def query(self, reads, *, backend: str = "idl_probe",
              **kw) -> torch.Tensor:
        """Two-probe merged per-kmer membership (engine-shaped output)."""
        base, delta, _, _ = self.states()
        return merge_kmer_hits(
            state_mod.query(base, reads, backend=backend, **kw),
            state_mod.query(delta, reads, backend=backend, **kw))

    def msmt(self, reads, theta: float = 1.0, *, backend: str = "idl_probe",
             **kw) -> torch.Tensor:
        """MSMT over the logical union of base and delta."""
        base, delta, _, _ = self.states()
        return merged_msmt(base, delta, reads, theta, backend=backend, **kw)

    # -- compaction ---------------------------------------------------------
    def plan_compaction(self) -> CompactionPlan:
        """Freeze the merge inputs: everything up to the current seq.

        The delta words are CLONED under the lock: the write path updates
        the delta's words in place (:meth:`insert`), so the plan must own
        its bytes or a later write would leak into the merge. One copy per
        compaction instead of one per insert.
        """
        with self._lock:
            delta = state_mod.IndexState(
                words=tuple(w.clone() for w in self._delta.words),
                meta=self._delta.meta)
            return CompactionPlan(
                base=self._base, delta=delta,
                upto_seq=self._delta_seq, base_version=self._base_version,
                tail=tuple(self._tail))

    @staticmethod
    def compact(plan: CompactionPlan) -> state_mod.IndexState:
        """Fold the plan's delta into its base (run off the hot path).

        Same geometry (default deltas): one elementwise OR of the packed
        words into new tensors. A smaller-``m`` delta (bit-probe engines)
        has different word shapes, so the journaled batches replay through
        the base's own insert plan instead — same union, by idempotence.
        The result always carries the *base* ``StateMeta``, so the publish
        keeps every runner.
        """
        if plan.delta.meta == plan.base.meta:
            return or_states(plan.base, plan.delta)
        merged = plan.base
        for i, rec in enumerate(plan.tail):
            fids = rec.file_ids
            if merged.meta.engine == "bloom":
                fids = None
            # the first insert must not write in place: plan.base is the
            # state still serving queries mid-compaction (donate=False
            # inserts into a copy; the later ones update that copy)
            merged = state_mod.insert(
                merged, rec.reads, fids, donate=i > 0)
        return merged

    def publish(self, merged: state_mod.IndexState, upto_seq: int, *,
                durable: bool = False) -> int:
        """Swap the merged base in; rebuild the delta from late arrivals.

        Batches that landed after ``upto_seq`` (mid-compaction writes)
        replay into a fresh delta. Caller must hold the serving layer's
        hot-swap window (no query/write dispatch in flight) — the same
        discipline as ``GeneSearchService.swap_state``.

        Durability: the journal is the ONLY durable copy of the folded
        writes until the merged base reaches stable storage, so it is
        truncated only under ``durable=True`` — which the caller may pass
        only after saving ``merged`` through the snapshot store (the
        ``save_dir`` paths do exactly that). The default keeps every
        record: a crash after an in-memory-only compaction reboots from
        the previous snapshot + the full journal and loses nothing;
        :meth:`save_base` reclaims the journal at the next snapshot.
        Returns the new base version.
        """
        if merged.meta != self._base.meta:
            raise ValueError(
                "compacted state changed geometry: publish would rebuild "
                "every serving step (meta must equal the base meta)")
        with self._lock:
            late = [r for r in self._tail if r.seq > upto_seq]
            self._base = merged
            self._base_version += 1
            self._delta = empty_delta(self._base, self._delta_cfg)
            self._tail = []
            seq = self._delta_seq
            self._delta_seq = int(upto_seq)
            self._compacted_seq = max(self._compacted_seq, int(upto_seq))
            for rec in late:
                self._apply(rec.reads, rec.file_ids, seq=rec.seq)
            self._delta_seq = max(self._delta_seq, int(seq))
            if durable and self._journal is not None:
                self._journal.truncate_through(upto_seq)
            return self._base_version

    def compact_now(self, *, save_dir: Optional[str] = None) -> int:
        """Inline plan → compact → publish (the synchronous convenience).

        ``save_dir`` writes the merged base through the versioned snapshot
        store BEFORE the publish, which is what licenses the journal
        truncation; without it the journal keeps every acked write (see
        :meth:`publish`). Returns the new base version.
        """
        plan = self.plan_compaction()
        merged = self.compact(plan)
        if save_dir is not None:
            store.save(merged, save_dir)
        return self.publish(merged, plan.upto_seq,
                            durable=save_dir is not None)

    def save_base(self, directory: str) -> str:
        """Write the current base through the versioned snapshot store,
        then reclaim journal records the saved base contains (they existed
        only to re-derive an UNSAVED base after a crash)."""
        with self._lock:
            base = self._base
            compacted = self._compacted_seq
        path = store.save(base, directory)
        if self._journal is not None:
            self._journal.truncate_through(compacted)
        return path

    def close(self) -> None:
        if self._journal is not None:
            self._journal.close()
