"""Packed int32 word storage: batched locations, the plain scatter-OR, and
file-mask unpacking.

Port of the lane32 half of :mod:`repro.index.packed`. Bloom-filter bits
live packed 32 per int32 word (the reference's uint32 words, same bits).
"""

from __future__ import annotations

import torch

from repro_torch.core import idl as idl_mod
from repro_torch.core.hashing import to_int32_bits
from repro_torch.index import registry


def batch_locations(
    cfg: idl_mod.IDLConfig, reads: torch.Tensor, scheme: str, *,
    lane32: bool = True,
) -> torch.Tensor:
    """(B, η, n_kmers) int64 locations for a (B, read_len) batch of reads.

    The location functions work along the last axis, so the batch axis is
    written out instead of mapped. Only the 32-bit lane path is ported.
    """
    if not lane32:
        raise NotImplementedError(
            "only the 32-bit lane location path (lane32=True) is ported")
    return registry.locations32(cfg, reads, scheme)


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


def unpack_file_bits(masks: torch.Tensor, n_files: int) -> torch.Tensor:
    """(..., F/32) int32 file masks -> (..., n_files) bool."""
    shifts = torch.arange(32, dtype=torch.int32, device=masks.device)
    bits = (masks[..., None] >> shifts) & 1
    return bits.reshape(masks.shape[:-1] + (-1,))[..., :n_files] == 1
