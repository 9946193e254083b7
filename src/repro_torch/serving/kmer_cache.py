"""Versioned cross-batch membership cache: the serving half of probe reuse.

Port of :mod:`repro.serving.kmer_cache` (numpy only, copied: numpy has
the uint64 shifts that torch on the CPU lacks, so the cache stays on the
host).

Membership of a kmer is a pure function of ``(kmer, IndexState)`` — the
same fact that makes intra-batch dedup exact (``query.execute(...,
dedup=True)``) makes it exact to memoize per-kmer membership *across*
batches: overlapping shotgun reads from one genomic region re-probe the
same kmers thousands of times, and every repeat after the first is a
cache hit instead of a hash + matrix gather.

:class:`KmerCache` is that memo, built to be cheaper per kmer than the
probe it shortcuts (a python dict of byte keys is not):

* **Keys** are kmers packed 2 bits/base into one ``uint64``
  (:func:`pack_codes` — k <= 32 covers the paper's k=31). Packing a
  whole ``(batch, L)`` read matrix is five vectorized shift-or passes
  (doubling blocks of 1, 2, 4, 8, 16 bases), ~20x faster than per-window
  ``tobytes()``.
* **Store** is two tiers of parallel arrays, both key-sorted: a large
  immutable-between-compactions *main* tier and a small *nursery* that
  absorbs fresh inserts. A batch lookup is one ``np.searchsorted`` per
  tier plus one fancy-index row gather — no per-key python at all.
* **Values** are per-kmer membership rows (the engine-shaped
  ``query_batch`` output for one kmer — a bool for the flat BF, an
  ``(n_files,)`` bool vector for COBS/RAMBO, a packed ``(F/32,)``
  uint32 mask for the bit-sliced index), stacked in one matrix so a
  warm batch is served by a single C-level gather.
* **LRU** is by last-hit tick: every lookup stamps its hits with a
  monotone batch counter, and when an insert pushes the store past
  ``capacity`` the lowest-stamped entries are evicted (the classic
  approximation: exact LRU order *between* evictions is not tracked,
  victims are always the least-recently-hit).

**Invalidation contract.** The logical cache key is ``(packed kmer,
version, delta_seq)`` — the two staleness coordinates every
``SearchResult`` already carries. The static service pins ``version``
as its cache's :meth:`begin` generation: a base swap (``swap_state`` /
compaction ``publish``) drops every entry, because the matrix those
rows were gathered from is gone. The live service runs TWO instances:

* its **front cache** holds merged base|delta rows pinned to the full
  ``(version, delta_seq)`` — the warm batch is one lookup, and any
  write drops every merged row (cheap: see below);
* its **base-row cache** pins ``version`` only, so it survives writes.
  After a ``delta_seq`` bump, re-merging a dropped front row is a pure
  base-cache gather plus a probe of just the (small by construction)
  delta for just the missing kmers — the fine-grained half of the
  contract: a cached negative flips positive the instant a write
  lands, without the engine ever re-probing the base. The per-kmer OR
  is exactly ``lsm.merge_kmer_hits`` — the LSM split restated:
  immutable base (long-lived rows), mutable delta (re-probed rows).

Single-writer discipline: all mutation happens on the thread that
dispatches batches (the scheduler's flusher / the synchronous caller) —
the same discipline the live index's in-place delta writes already
require, so the cache adds no new locking. Counter reads from other
threads (stats scraping) see monotone ints.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Iterable, Optional, Tuple

import numpy as np

from repro_torch.obs import metrics as obs_metrics

__all__ = ["KmerCacheConfig", "KmerCache", "pack_codes",
           "merge_cache_stats"]

# distinguishes each cache instance's gauge series in the process
# registry (two live-service caches per replica must not overwrite each
# other's ``entries``); counters with the same labels would merge fine,
# but one vocabulary for both is simpler to read in a snapshot
_CACHE_IDS = itertools.count()

# nursery merges into the sorted main tier past this many fresh entries —
# bounds per-insert cost (the nursery's own merge sort stays tiny) while
# keeping main-tier re-sorts rare on a warm cache (zero on an all-hit one)
_NURSERY_MAX = 4096

# Fibonacci-hash multiplier (odd, golden-ratio) for the main tier's
# direct-mapped slot table: one wrap-around multiply spreads packed kmer
# codes across the high bits, and the table is sized >= 8x the entry
# count, so almost every warm lookup resolves with a single O(1) probe
# instead of a binary search (collision losers fall back to searchsorted)
_HASH_MULT = np.uint64(0x9E3779B97F4A7C15)


def pack_codes(reads: np.ndarray, k: int) -> np.ndarray:
    """Pack every kmer of ``(batch, L)`` reads into ``uint64`` keys.

    Returns ``(batch, L - k + 1)`` codes with base ``i + j`` of a window
    at bits ``[2j, 2j + 2)`` — the literal 2-bit packing, so codes are
    injective over kmers (requires ``k <= 32``; the paper's k=31 fits
    with 2 bits to spare). Built by block doubling: 5 shift-or passes
    combine 1, 2, 4, 8, 16-base blocks into 32-base codes which are then
    masked to ``2k`` bits, so the cost is ~5 vectorized ops over the
    read matrix instead of a per-window reduction.
    """
    if k > 32:
        raise ValueError(
            f"pack_codes packs kmers into uint64 keys, so k <= 32 "
            f"(got k={k})")
    arr = np.asarray(reads, dtype=np.uint8)
    if arr.ndim == 1:
        arr = arr[None]
    b, length = arr.shape
    n_k = length - k + 1
    if n_k < 1:
        raise ValueError(f"reads of length {length} have no {k}-mers")
    # zero-pad to 32-base windows; pad bases land at bits >= 2k and are
    # masked away, so every real window's code is exact
    acc = np.zeros((b, length + 32 - k), dtype=np.uint64)
    acc[:, :length] = arr
    for level in range(5):
        step = 1 << level
        acc = acc[:, :-step] | (acc[:, step:] << np.uint64(2 * step))
    return acc[:, :n_k] & np.uint64((1 << (2 * k)) - 1)


@dataclasses.dataclass(frozen=True)
class KmerCacheConfig:
    """Knobs of the serving membership cache (static, picklable — rides
    ``ServiceConfig`` across the fabric's process boundary)."""

    capacity: int = 1 << 16   # max cached kmers (least-recently-hit beyond)

    def __post_init__(self):
        if self.capacity < 1:
            raise ValueError("capacity must be >= 1")


class KmerCache:
    """Membership-row memo for ONE served index state (see module doc)."""

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = int(capacity)
        # obs: every counter bump below mirrors into the process registry
        # (pre-bound handles; one inc per batched op, not per kmer)
        labels = {"tier": "kmer_cache", "cache": next(_CACHE_IDS)}
        reg = obs_metrics.DEFAULT
        self._obs_hits = reg.counter("kmer_cache.hits", **labels)
        self._obs_misses = reg.counter("kmer_cache.misses", **labels)
        self._obs_evictions = reg.counter("kmer_cache.evictions", **labels)
        self._obs_invalidations = reg.counter(
            "kmer_cache.invalidations", **labels)
        self._obs_entries = reg.gauge("kmer_cache.entries", **labels)
        self._obs_capacity = reg.gauge("kmer_cache.capacity", **labels)
        self._obs_capacity.set(self.capacity)
        # main tier: key-sorted parallel arrays (keys / row matrix / last-
        # hit tick); nursery: same shape, absorbs inserts between merges
        self._keys: Optional[np.ndarray] = None
        self._vals: Optional[np.ndarray] = None
        self._stamp: Optional[np.ndarray] = None
        self._table: Optional[np.ndarray] = None   # slot -> main-tier index
        self._table_shift = np.uint64(64)
        self._nkeys: Optional[np.ndarray] = None
        self._nvals: Optional[np.ndarray] = None
        self._nstamp: Optional[np.ndarray] = None
        self._generation: Optional[object] = None
        self._tick = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.invalidations = 0

    def __len__(self) -> int:
        n = 0 if self._keys is None else len(self._keys)
        if self._nkeys is not None:
            n += len(self._nkeys)
        return n

    # -- the generation gate -------------------------------------------------
    def begin(self, generation) -> None:
        """Pin the state version this batch probes under.

        A changed generation means the state the cached rows were
        gathered from was replaced (hot swap / compaction publish for a
        version-keyed cache; any write for the live front cache): every
        entry drops. Same generation is the overwhelmingly common case
        and costs one comparison.
        """
        if generation != self._generation:
            if len(self):
                self.invalidations += 1
                self._obs_invalidations.inc()
                self._keys = self._vals = self._stamp = None
                self._table = None
                self._nkeys = self._nvals = self._nstamp = None
                self._obs_entries.set(0)
            self._generation = generation

    # -- lookup / fill -------------------------------------------------------
    def lookup(self, codes: np.ndarray
               ) -> Tuple[Optional[np.ndarray], np.ndarray]:
        """Batch probe: ``(rows, hit)`` for ``(n,)`` packed uint64 codes.

        ``rows`` is a fresh ``(n, ...)`` matrix with miss rows
        zero-filled — or None when the cache is empty (the caller learns
        the row shape from its own probe). ``hit`` is the ``(n,)`` bool
        mask. Hits refresh the LRU stamp.

        The warm all-hit case — the whole point of the cache — is one
        hash-probe of the main tier's direct-mapped slot table (a
        multiply, a shift and two gathers) plus one row gather and one
        stamp scatter. Codes the table can't resolve (hash-collision
        losers and real misses) fall back to a subset-sized searchsorted;
        only main-tier misses pay the (subset-sized) nursery probe.
        ``insert`` keeps the invariant that the nursery is only ever
        populated alongside a main tier.
        """
        self._tick += 1
        n = int(codes.size)
        if self._keys is None:
            self.misses += n
            self._obs_misses.inc(n)
            return None, np.zeros(n, dtype=bool)
        keys = self._keys
        cand = self._table[(codes * _HASH_MULT) >> self._table_shift]
        pos = np.maximum(cand, 0)
        hit = keys[pos] == codes           # empty slots hold index 0's key...
        hit &= cand >= 0                   # ...so mask them back out
        rows = self._vals[pos]             # direct gather (miss rows fixed up)
        if hit.all():
            self._stamp[pos] = self._tick
            self.hits += n
            self._obs_hits.inc(n)
            return rows, hit
        miss = np.flatnonzero(~hit)
        rows[miss] = 0
        self._stamp[pos[hit]] = self._tick
        # collision losers: present in the sorted tier, shadowed in the table
        sub = codes[miss]
        spos = np.minimum(np.searchsorted(keys, sub), len(keys) - 1)
        shit = keys[spos] == sub
        if shit.any():
            found = spos[shit]
            rows[miss[shit]] = self._vals[found]
            self._stamp[found] = self._tick
            hit[miss[shit]] = True
            miss = miss[~shit]
        if self._nkeys is not None and len(miss):
            sub = codes[miss]
            nkeys = self._nkeys
            npos = np.minimum(np.searchsorted(nkeys, sub), len(nkeys) - 1)
            nhit = nkeys[npos] == sub
            if nhit.any():
                found = npos[nhit]
                rows[miss[nhit]] = self._nvals[found]
                self._nstamp[found] = self._tick
                hit[miss[nhit]] = True
        n_hit = int(hit.sum())
        self.hits += n_hit
        self.misses += n - n_hit
        self._obs_hits.inc(n_hit)
        self._obs_misses.inc(n - n_hit)
        return rows, hit

    def insert(self, codes: np.ndarray, rows: np.ndarray) -> None:
        """Add freshly probed rows (``codes`` sorted-unique, all misses).

        Lands in the nursery (a small merge); the nursery folds into the
        sorted main tier — evicting least-recently-hit entries past
        ``capacity`` — when it outgrows ``_NURSERY_MAX``, the cache is
        over capacity, or there is no main tier yet, so a warm cache
        never re-sorts and lookups on a cold one stay single-tier.
        """
        stamp = np.full(codes.shape, self._tick, dtype=np.int64)
        if self._nkeys is None:
            self._nkeys = codes.copy()
            self._nvals = np.array(rows)
            self._nstamp = stamp
        else:
            keys = np.concatenate([self._nkeys, codes])
            order = np.argsort(keys, kind="stable")
            self._nkeys = keys[order]
            self._nvals = np.concatenate([self._nvals, rows])[order]
            self._nstamp = np.concatenate([self._nstamp, stamp])[order]
        if self._keys is None or len(self) > self.capacity \
                or len(self._nkeys) > _NURSERY_MAX:
            self._compact_store()
        self._obs_entries.set(len(self))

    def _compact_store(self) -> None:
        """Fold nursery into main; evict least-recently-hit past capacity."""
        tiers = [(self._keys, self._vals, self._stamp),
                 (self._nkeys, self._nvals, self._nstamp)]
        live = [t for t in tiers if t[0] is not None]
        if len(live) == 2:
            keys = np.concatenate([live[0][0], live[1][0]])
            vals = np.concatenate([live[0][1], live[1][1]])
            stamp = np.concatenate([live[0][2], live[1][2]])
        else:
            keys, vals, stamp = live[0]
        if len(keys) > self.capacity:
            n_evict = len(keys) - self.capacity
            keep = np.argpartition(stamp, n_evict)[n_evict:]
            self.evictions += n_evict
            self._obs_evictions.inc(n_evict)
            keys, vals, stamp = keys[keep], vals[keep], stamp[keep]
        order = np.argsort(keys, kind="stable")
        self._keys = keys[order]
        self._vals = vals[order]
        self._stamp = stamp[order]
        self._nkeys = self._nvals = self._nstamp = None
        # direct-mapped slot table over the sorted tier, >= 8x oversized;
        # later entries win collisions, losers resolve via searchsorted
        p = max(10, (len(self._keys) * 8 - 1).bit_length())
        self._table_shift = np.uint64(64 - p)
        self._table = np.full(1 << p, -1, dtype=np.int64)
        slots = (self._keys * _HASH_MULT) >> self._table_shift
        self._table[slots] = np.arange(len(self._keys), dtype=np.int64)

    # -- observability -------------------------------------------------------
    @property
    def lookups(self) -> int:
        return self.hits + self.misses

    @property
    def hit_rate(self) -> float:
        n = self.lookups
        return self.hits / n if n else 0.0

    def stats(self) -> Dict[str, float]:
        """One picklable dict — the shape ClusterStats scrapers, the
        fabric's ``stats`` reply and the benches all share."""
        return {
            "hits": self.hits,
            "misses": self.misses,
            "lookups": self.lookups,
            "hit_rate": self.hit_rate,
            "entries": len(self),
            "capacity": self.capacity,
            "evictions": self.evictions,
            "invalidations": self.invalidations,
        }


def merge_cache_stats(parts: Iterable[Optional[Dict[str, float]]]
                      ) -> Optional[Dict[str, float]]:
    """Aggregate per-replica/per-worker ``KmerCache.stats()`` dicts.

    None entries (cache-less members) are skipped; returns None when no
    member carries a cache — the routers' and the fabric gateway's
    fleet-wide hit-rate view.
    """
    merged: Optional[Dict[str, float]] = None
    for part in parts:
        if part is None:
            continue
        if merged is None:
            merged = dict(part)
            continue
        for key in ("hits", "misses", "lookups", "entries", "capacity",
                    "evictions", "invalidations"):
            merged[key] += part.get(key, 0)
    if merged is not None:
        merged["hit_rate"] = (merged["hits"] / merged["lookups"]
                              if merged["lookups"] else 0.0)
    return merged
