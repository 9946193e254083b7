"""Partitioned Bloom filters over registered hash-scheme location streams.

Port of :mod:`repro.core.bloom`. The canonical flat-filter storage is
:class:`repro_torch.index.PackedBloomIndex` (packed int32 words). This
module keeps the simple ``uint8`` bit-per-byte primitives
(``insert_locations`` / ``query_locations``) as the oracle the parity tests
check engines against, ``pack_bits`` / ``unpack_bits`` between the two
layouts, the packed membership oracle ``query_packed``, the Blocked Bloom
filter's locations (Putze et al., the paper's §3.3 baseline), and
:class:`BloomFilter`, the deprecated adapter over ``PackedBloomIndex``.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

import torch

from repro_torch.core import hashing
from repro_torch.core import idl as idl_mod


def empty_filter(m: int, device="cuda") -> torch.Tensor:
    return torch.zeros((m,), dtype=torch.uint8, device=device)


def insert_locations(bf: torch.Tensor, locs: torch.Tensor) -> torch.Tensor:
    """A copy of ``bf`` with the bits at (η, n) or flat locations set."""
    out = bf.clone()
    out[locs.reshape(-1)] = 1
    return out


def query_locations(bf: torch.Tensor, locs: torch.Tensor) -> torch.Tensor:
    """AND over the η axis → (n,) bool membership."""
    return (bf[locs] == 1).all(dim=0)


@dataclasses.dataclass
class BloomFilter:
    """Deprecated thin adapter over :class:`repro_torch.index.
    PackedBloomIndex` (uint8 ``bits`` field, single-sequence methods).

    New code should build a ``PackedBloomIndex`` directly: it stores packed
    int32 words and inserts whole batches in one planned launch. A fresh
    filter is made on ``device`` (default ``"cuda"``); given ``bits``, the
    filter lives where they do.
    """

    cfg: idl_mod.IDLConfig
    scheme: str = "idl"
    bits: Optional[torch.Tensor] = None
    device: str = "cuda"

    def __post_init__(self):
        if self.bits is None:
            # fresh user construction (internal dataclasses.replace calls
            # always pass bits); stacklevel skips the generated __init__
            warnings.warn(
                "core.bloom.BloomFilter is a deprecated adapter; build a "
                "repro_torch.index.PackedBloomIndex instead (batched "
                "planned inserts and queries).",
                DeprecationWarning, stacklevel=3,
            )
            self.bits = empty_filter(self.cfg.m, self.device)

    def _engine(self, words: torch.Tensor):
        from repro_torch.index import engines

        return engines.PackedBloomIndex(cfg=self.cfg, scheme=self.scheme,
                                        words=words)

    def _query_index(self):
        """Engine view for query use; the packed words are cached, keyed on
        the bits tensor's identity (``pack_bits`` per query would
        dominate). Never hand the cached words to ``insert_batch``: it
        updates them in place."""
        cached = getattr(self, "_packed_cache", None)
        if cached is None or cached[0] is not self.bits:
            cached = (self.bits, pack_bits(self.bits))
            object.__setattr__(self, "_packed_cache", cached)
        return self._engine(cached[1])

    # --- sequence (read / genome chunk) API: the paper's Alg. 1 / Alg. 2 ---
    def insert_sequence(self, codes) -> "BloomFilter":
        codes = torch.as_tensor(codes, device=self.bits.device)
        fresh = self._engine(pack_bits(self.bits)).insert_batch(codes)
        out = dataclasses.replace(self, bits=unpack_bits(fresh.words))
        object.__setattr__(out, "_packed_cache", (out.bits, fresh.words))
        return out

    def query_sequence(self, codes) -> torch.Tensor:
        """Per-kmer membership bits for all stride-1 kmers of the read."""
        codes = torch.as_tensor(codes, device=self.bits.device)
        return self._query_index().query_batch(codes)[0]

    def membership(self, codes) -> torch.Tensor:
        """MT(Q, G): True iff every kmer of Q passes (Definition 2)."""
        return self.query_sequence(codes).all()

    # --- arbitrary kmer-batch API ---
    def insert_kmers(self, kmer_arr: torch.Tensor) -> "BloomFilter":
        locs = self._kmer_locs(kmer_arr)
        return dataclasses.replace(self, bits=insert_locations(self.bits, locs))

    def query_kmers(self, kmer_arr: torch.Tensor) -> torch.Tensor:
        return query_locations(self.bits, self._kmer_locs(kmer_arr))

    def _kmer_locs(self, kmer_arr: torch.Tensor) -> torch.Tensor:
        from repro_torch.index import registry

        kmer_arr = torch.as_tensor(kmer_arr, device=self.bits.device)
        return registry.kmer_locations(self.cfg, kmer_arr, self.scheme)

    @property
    def fill_fraction(self) -> torch.Tensor:
        return self.bits.to(torch.float32).mean()


# ---------------------------------------------------------------------------
# Blocked Bloom filter (Putze et al. 2007) — §3.3 orthogonal baseline.
# ---------------------------------------------------------------------------

def blocked_locations(kmer_arr: torch.Tensor, m: int, eta: int,
                      block_bits: int) -> torch.Tensor:
    """All η probes inside one block of ``block_bits`` chosen by key hash."""
    n_blocks = m // block_bits
    base = hashing.hash_to_range(kmer_arr, 0xB10C, n_blocks) * block_bits
    return torch.stack([
        (base + hashing.hash_to_range(kmer_arr, 0xB10C + 31 * (j + 1),
                                      block_bits)) & hashing.M32
        for j in range(eta)
    ], dim=0)


# ---------------------------------------------------------------------------
# Packed-word layout (used by kernels + serving; 32 bits/word).
# ---------------------------------------------------------------------------

def pack_bits(bf_u8: torch.Tensor) -> torch.Tensor:
    """(m,) uint8 {0,1} -> (m/32,) int32 little-bit-endian words."""
    m = bf_u8.shape[0]
    if m % 32:
        raise ValueError(f"m={m} must be a multiple of 32")
    cols = bf_u8.reshape(-1, 32)
    acc = torch.zeros(m // 32, dtype=torch.int64, device=bf_u8.device)
    for s in range(32):
        acc += cols[:, s].to(torch.int64) << s
    return hashing.to_int32_bits(acc & hashing.M32)


def unpack_bits(words: torch.Tensor) -> torch.Tensor:
    """(n,) int32 words -> (32·n,) uint8 {0,1}."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    return ((words[:, None] >> shifts) & 1).reshape(-1).to(torch.uint8)


def query_packed(words: torch.Tensor, locs: torch.Tensor) -> torch.Tensor:
    """Membership test against the packed layout (the plain oracle of the
    flat-filter kernels): (η, n) locations → (n,) bool."""
    got = (words[locs >> 5] >> (locs & 31).to(torch.int32)) & 1
    return (got == 1).all(dim=0)
