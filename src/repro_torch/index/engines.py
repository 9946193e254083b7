"""The index engines: the flat Bloom filter and the bit-sliced serving index.

Port of :mod:`repro.index.engines`:

=====================  =====================================================
Engine                 Storage (packed int32 words)
=====================  =====================================================
PackedBloomIndex       flat partitioned BF, 64-bit hash path: ``(m/32,)``
BitSlicedIndex         one bit-sliced matrix, 32-bit lane path:
                       ``(m, ⌈F/32⌉)`` (serving)
=====================  =====================================================

Inserts go through :mod:`repro_torch.index.ingest` (default backend
``"idl_insert"``), queries through :mod:`repro_torch.index.query` (default
backend ``"idl_probe"``). Inserts update the words in place; the input
value is marked consumed (``donate=False`` inserts into a copy). COBS and
RAMBO are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import idl as idl_mod
from repro_torch.index import ingest, packed, query
from repro_torch.index import state as state_mod


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
class PackedBloomIndex:
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
        return cls(cfg=cfg, scheme=scheme, words=torch.zeros(
            (cfg.m // 32,), dtype=torch.int32, device=device))

    @property
    def state(self) -> state_mod.IndexState:
        return state_mod.from_engine(self)

    @property
    def _shape(self) -> tuple[int, int]:
        return (self.cfg.m // 32, 1)

    def insert_batch(self, reads, file_ids=None, *,
                     backend: str = "idl_insert",
                     donate: bool = True) -> "PackedBloomIndex":
        """Index a (B, read_len) batch (``file_ids`` is ignored: one set),
        in place; returns the updated view and marks this one consumed
        (unless ``donate=False``, which inserts into a copy)."""
        del file_ids
        state_mod.ensure_live(self, what="engine")
        reads = query.as_reads(reads, self.words.device)
        plan = ingest.plan_insert(
            self.cfg, self.scheme, tuple(reads.shape), self._shape,
            kind="bits", device=self.words.device)
        words = plan.execute(self.words, reads, backend=backend,
                             donate=donate)
        if donate:
            state_mod.mark_consumed(self)
        return dataclasses.replace(self, words=words)

    def query_batch(self, reads, *, backend: str = "idl_probe"
                    ) -> torch.Tensor:
        """(B, n_kmers) bool per-kmer membership."""
        state_mod.ensure_live(self, what="engine")
        reads = query.as_reads(reads, self.words.device)
        plan = query.plan_query(
            self.cfg, self.scheme, tuple(reads.shape), self._shape,
            bit_probe=True, device=self.words.device)
        return plan.execute(self.words, reads, backend=backend)[..., 0] == 1

    def msmt(self, reads, theta: float = 1.0, **kw) -> torch.Tensor:
        """(B,) bool: kmer coverage of the one indexed set >= theta."""
        return query.member_coverage(self.query_batch(reads, **kw), theta)

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


@dataclasses.dataclass(frozen=True)
class BitSlicedIndex:
    """One bit-sliced (m, F/32) int32 matrix on the 32-bit lane path."""

    cfg: idl_mod.IDLConfig
    scheme: str
    n_files: int
    words: torch.Tensor      # (m, ceil(n_files/32)) int32

    @classmethod
    def build(cls, cfg: idl_mod.IDLConfig, scheme: str = "idl",
              n_files: int = 1024, device="cuda") -> "BitSlicedIndex":
        w = -(-n_files // 32)
        return cls(cfg=cfg, scheme=scheme, n_files=n_files,
                   words=torch.zeros((cfg.m, w), dtype=torch.int32,
                                     device=device))

    @property
    def state(self) -> state_mod.IndexState:
        return state_mod.from_engine(self)

    def insert_batch(self, reads, file_ids=None, *,
                     backend: str = "idl_insert",
                     donate: bool = True) -> "BitSlicedIndex":
        """Index reads into their file columns, in place; returns the
        updated view and marks this one consumed (unless ``donate=False``,
        which inserts into a copy)."""
        state_mod.ensure_live(self, what="engine")
        reads = query.as_reads(reads, self.words.device)
        fids = _as_file_ids(file_ids, reads.shape[0], self.n_files)
        plan = ingest.plan_insert(
            self.cfg, self.scheme, tuple(reads.shape), tuple(self.words.shape),
            kind="cols", lane32=True, device=self.words.device,
        )
        words = plan.execute(self.words, reads, fids, backend=backend,
                             donate=donate)
        if donate:
            state_mod.mark_consumed(self)
        return dataclasses.replace(self, words=words)

    def query_batch(self, reads, *, backend: str = "idl_probe"
                    ) -> torch.Tensor:
        """(B, n_kmers, F/32) int32 per-kmer file masks (packed)."""
        state_mod.ensure_live(self, what="engine")
        reads = query.as_reads(reads, self.words.device)
        plan = query.plan_query(
            self.cfg, self.scheme, tuple(reads.shape), tuple(self.words.shape),
            bit_probe=False, lane32=True, device=self.words.device,
        )
        return plan.execute(self.words, reads, backend=backend)

    def msmt(self, reads, theta: float = 1.0, **kw) -> torch.Tensor:
        """(B, n_files) bool — the serve-layout MSMT (one theta rule)."""
        per_kmer = self.query_batch(reads, **kw)          # (B, n_k, W)
        mask = query.file_match_mask(per_kmer, theta)     # (B, W)
        return packed.unpack_file_bits(mask, self.n_files)
