"""Plain PyTorch versions of the ``insert_planned`` kernel: the scatter-OR
of flat bit positions and the flat filter's round-by-round tile insert."""

from __future__ import annotations

import torch

from repro_torch.core.hashing import to_int32_bits


def insert_planned_ref(words: torch.Tensor, positions: torch.Tensor
                       ) -> torch.Tensor:
    """OR bit ``p & 31`` of word ``p >> 5`` of the int32 ``words`` (viewed
    flat) in place for every ``p >= 0`` of the int64 ``positions``; returns
    ``words``.

    The positions are deduplicated first, so the single-bit words of one
    matrix word are disjoint and summing them (int64, per distinct word)
    equals OR-ing them — the reference oracle's trick
    (``repro.kernels.idl_insert.ref.insert_runs_ref``).
    """
    p = positions.reshape(-1).to(torch.int64)
    p = torch.unique(p[p >= 0])
    words_at, inverse = torch.unique(p >> 5, return_inverse=True)
    acc = torch.zeros_like(words_at).index_add_(
        0, inverse, torch.ones_like(p) << (p & 31))
    flat = words.view(-1)
    flat[words_at] = flat[words_at] | to_int32_bits(acc)
    return words


def insert_round_ref(
    bf_words: torch.Tensor,
    block_ids: torch.Tensor,
    offsets: torch.Tensor,
    *,
    block_words: int,
    inserts_per_round: int,
) -> torch.Tensor:
    """(R, block_words) updated tiles: each run's tile of the packed flat
    filter OR the bit image of its valid offsets (block ids unique per
    round). The image is a scatter of the distinct (run, bit) pairs, whose
    single-bit words sum to their OR."""
    del inserts_per_round
    tiles = bf_words.view(-1, block_words)[block_ids.to(torch.int64)]
    valid = offsets >= 0
    run = torch.arange(offsets.shape[0], device=offsets.device)[:, None]
    keys = torch.unique((run * (block_words * 32) + offsets)[valid])
    words, inverse = torch.unique(keys >> 5, return_inverse=True)
    acc = torch.zeros_like(words).index_add_(
        0, inverse, torch.ones_like(keys) << (keys & 31))
    flat = tiles.view(-1)
    flat[words] = flat[words] | to_int32_bits(acc)
    return tiles


def apply_insert_to_words(
    bf_words: torch.Tensor, block_ids: torch.Tensor, tiles: torch.Tensor,
    block_words: int,
) -> torch.Tensor:
    """Write updated tiles back into ``bf_words`` in place (block ids unique
    per call); returns ``bf_words``."""
    bf_words.view(-1, block_words)[block_ids.to(torch.int64)] = tiles
    return bf_words
