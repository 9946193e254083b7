"""Packed int32 word storage: batched locations, the plain scatter-ORs,
and layout conversions.

Port of :mod:`repro.index.packed`. Bloom-filter bits live packed 32 per
int32 word (the reference's uint32 words, same bits). The reference's
removed v1 entry points (``insert_batch_words``, ``insert_batch_bitsliced``,
``insert_batch_rows``, kept there as ``ImportError`` stubs) have no
counterpart: the port never had them.
"""

from __future__ import annotations

import torch

from repro_torch.core import bloom as bloom_mod
from repro_torch.core import idl as idl_mod
from repro_torch.core.hashing import M32, to_int32_bits
from repro_torch.index import registry


def batch_locations(
    cfg: idl_mod.IDLConfig, reads: torch.Tensor, scheme: str, *,
    lane32: bool = False,
) -> torch.Tensor:
    """(B, η, n_kmers) int64 locations for a (B, read_len) batch of reads.

    ``lane32`` picks the 32-bit lane path over the 64-bit hash path. The
    location functions work along the last axis, so the batch axis is
    written out instead of mapped.
    """
    fn = registry.locations32 if lane32 else registry.locations
    return fn(cfg, reads, scheme)


def scatter_or_matrix(
    matrix: torch.Tensor,
    rows: torch.Tensor,
    word_cols: torch.Tensor,
    bits: torch.Tensor,
) -> torch.Tensor:
    """OR bit ``bits[i]`` of word ``(rows[i], word_cols[i])`` into the
    (n_rows, W) int32 ``matrix`` in place; returns ``matrix``.

    The plain sort-dedup scatter: targets are deduplicated as flat bit keys
    (``torch.unique`` sorts), so each remaining bit is set once and the
    per-word sums of single bits equal their OR. Targets with a row outside
    ``[0, n_rows)`` are dropped.
    """
    n_rows, w = matrix.shape
    r = rows.reshape(-1).to(torch.int64)
    keep = (r >= 0) & (r < n_rows)
    word = r * w + word_cols.reshape(-1).to(torch.int64)
    keys = torch.unique((word * 32 + bits.reshape(-1).to(torch.int64))[keep])
    words, inverse = torch.unique(keys >> 5, return_inverse=True)
    acc = torch.zeros_like(words).index_add_(
        0, inverse, torch.ones_like(keys) << (keys & 31))
    flat = matrix.view(-1)
    flat[words] = flat[words] | to_int32_bits(acc)
    return matrix



def scatter_or_bitsliced(matrix: torch.Tensor, rows: torch.Tensor,
                         file_ids: torch.Tensor) -> torch.Tensor:
    """Set file bits at (row, file) pairs in a bit-sliced (m, F/32)
    matrix, in place."""
    fids = file_ids.reshape(-1).to(torch.int32)
    return scatter_or_matrix(matrix, rows, fids >> 5, fids & 31)


def scatter_or_rows(filters: torch.Tensor, filter_rows: torch.Tensor,
                    locs: torch.Tensor) -> torch.Tensor:
    """Set bit ``locs[i]`` of packed filter row ``filter_rows[i]`` (RAMBO),
    in place."""
    flat = locs.reshape(-1).to(torch.int32)
    return scatter_or_matrix(filters, filter_rows, flat >> 5, flat & 31)

def scatter_or(words: torch.Tensor, locs: torch.Tensor) -> torch.Tensor:
    """OR the bits at flat bit locations ``locs`` into the packed (n,) int32
    ``words`` in place; returns ``words``. Locations are read as uint32 (as
    the reference casts them); those past the last word are dropped."""
    flat = locs.reshape(-1).to(torch.int64) & M32
    scatter_or_matrix(words.view(-1, 1), flat >> 5, torch.zeros_like(flat),
                      flat & 31)
    return words


def pack_rows(bits_u8: torch.Tensor) -> torch.Tensor:
    """(..., m) uint8 {0,1} -> (..., m/32) int32 (rowwise ``pack_bits``)."""
    m = bits_u8.shape[-1]
    if m % 32:
        raise ValueError(f"row length m={m} must be a multiple of 32")
    flat = bloom_mod.pack_bits(bits_u8.reshape(-1))
    return flat.reshape(bits_u8.shape[:-1] + (m // 32,))


def unpack_rows(words: torch.Tensor, m: int) -> torch.Tensor:
    """(..., m/32) int32 -> (..., m) uint8 (rowwise ``unpack_bits``)."""
    flat = bloom_mod.unpack_bits(words.reshape(-1))
    return flat.reshape(words.shape[:-1] + (m,))


def unpack_file_bits(masks: torch.Tensor, n_files: int) -> torch.Tensor:
    """(..., F/32) int32 file masks -> (..., n_files) bool."""
    shifts = torch.arange(32, dtype=torch.int32, device=masks.device)
    bits = (masks[..., None] >> shifts) & 1
    return bits.reshape(masks.shape[:-1] + (-1,))[..., :n_files] == 1


def __getattr__(name: str):
    # coverage_need's single definition lives in repro_torch.index.query,
    # which imports this module: re-exported lazily, as the reference does
    if name == "coverage_need":
        from repro_torch.index import query

        return query.coverage_need
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
