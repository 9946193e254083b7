"""Cache / DMA traffic models for locality accounting.

The port's own copy of :mod:`repro.core.cache_model`; the arithmetic is
the reference's, line for line. Two complementary metrics:

1. ``LRUCache`` — a software fully-associative LRU cache simulator, mirroring
   the paper's Valgrind two-level experiment (L1 = 2 MB, L3 = 256 MB, 64 B
   lines). Feed it the bit-address trace of BF probes; read miss rates.

2. ``count_block_dmas`` — the number of *changes* in the block-id stream of
   a probe trace (a 1-deep cache holding the current block), plus the
   unique-block count (infinite cache lower bound). The reference reads it
   as the HBM→VMEM block DMAs of its TPU probe kernel; on the card the same
   count is the number of block changes in the probe stream, which the
   port's ``locality.*`` counters also count for every served batch
   (:func:`repro_torch.index.query.record_locality`).

Host-side (numpy + dict) — these are measurement tools, not model code.
Every trace argument may also be a torch tensor (on any device): it is
copied to the host once, then the same numpy code runs.
"""

from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch


def _host(a) -> np.ndarray:
    """A trace as a numpy array: a torch tensor is copied to the host once."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


@dataclasses.dataclass
class CacheStats:
    accesses: int = 0
    misses: int = 0

    @property
    def miss_rate(self) -> float:
        return self.misses / self.accesses if self.accesses else 0.0


class LRUCache:
    """Fully-associative LRU over fixed-size lines (addresses in *bits*)."""

    def __init__(self, capacity_bytes: int, line_bytes: int = 64):
        self.capacity_lines = max(1, capacity_bytes // line_bytes)
        self.line_bits = line_bytes * 8
        self._lines: collections.OrderedDict[int, None] = collections.OrderedDict()
        self.stats = CacheStats()

    def access(self, bit_addr: int) -> bool:
        """Returns True on miss."""
        line = bit_addr // self.line_bits
        self.stats.accesses += 1
        if line in self._lines:
            self._lines.move_to_end(line)
            return False
        self.stats.misses += 1
        self._lines[line] = None
        if len(self._lines) > self.capacity_lines:
            self._lines.popitem(last=False)
        return True

    def access_trace(self, bit_addrs: np.ndarray) -> CacheStats:
        # line-id vectorization then python LRU walk (line ids are small ints)
        lines = _host(bit_addrs).astype(np.int64, copy=False) // self.line_bits
        ln = self._lines
        cap = self.capacity_lines
        misses = 0
        for line in lines.tolist():
            if line in ln:
                ln.move_to_end(line)
            else:
                misses += 1
                ln[line] = None
                if len(ln) > cap:
                    ln.popitem(last=False)
        self.stats.accesses += len(lines)
        self.stats.misses += misses
        return self.stats


def two_level_miss_rates(
    bit_addrs: np.ndarray,
    l1_bytes: int = 2 * 1024 * 1024,
    l3_bytes: int = 256 * 1024 * 1024,
    line_bytes: int = 64,
) -> tuple[float, float]:
    """Paper's Valgrind setup: (L1 miss rate, L3 miss rate of L1 misses)."""
    l1 = LRUCache(l1_bytes, line_bytes)
    l3 = LRUCache(l3_bytes, line_bytes)
    lines = _host(bit_addrs).astype(np.int64, copy=False) // (line_bytes * 8)
    l1_m = 0
    l3_m = 0
    for line in lines.tolist():
        if l1.access(line * l1.line_bits):
            l1_m += 1
            if l3.access(line * l3.line_bits):
                l3_m += 1
    n = len(lines)
    return (l1_m / n if n else 0.0, l3_m / n if n else 0.0)


def count_block_dmas(bit_addrs: np.ndarray, block_bits: int) -> dict[str, int]:
    """Block switches of a 1-block-resident cache + unique blocks.

    ``switches``  — block changes along the trace (the reference's DMA count
                    of its scalar-prefetch Pallas kernel; on the card, the
                    block changes the probe stream makes);
    ``unique``    — lower bound (infinite VMEM);
    ``accesses``  — trace length.
    """
    blocks = _host(bit_addrs).astype(np.int64, copy=False) // block_bits
    if blocks.size == 0:
        return {"switches": 0, "unique": 0, "accesses": 0}
    switches = int(1 + np.count_nonzero(blocks[1:] != blocks[:-1]))
    return {
        "switches": switches,
        "unique": int(len(np.unique(blocks))),
        "accesses": int(blocks.size),
    }


def count_block_dmas_partitioned(locs: np.ndarray, block_bits: int) -> dict[str, int]:
    """Block switches of the partitioned-BF probe.

    One resident block *per hash repetition* (η blocks, the reference's η
    VMEM tiles), so block switches are counted per row of the (η, n_kmers)
    location grid and summed. ``unique`` likewise sums per-row unique blocks
    (each repetition owns a disjoint sub-range anyway).
    """
    locs = _host(locs)
    if locs.ndim == 1:
        locs = locs[None, :]
    tot = {"switches": 0, "unique": 0, "accesses": 0}
    for row in locs:
        d = count_block_dmas(row, block_bits)
        for k in tot:
            tot[k] += d[k]
    return tot


def probe_trace_from_locations(locs: np.ndarray) -> np.ndarray:
    """Flatten (η, n_kmers) location grid into the temporal access order.

    The BF probe loop (Alg. 2) iterates kmers outer, η inner — so the trace
    interleaves the η probes of each kmer: order = locs.T.reshape(-1).
    """
    locs = _host(locs)
    if locs.ndim == 1:
        return locs
    return locs.T.reshape(-1)
