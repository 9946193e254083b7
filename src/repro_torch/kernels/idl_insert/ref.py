"""Plain PyTorch version of the ``insert_planned`` kernel."""

from __future__ import annotations

import torch

from repro_torch.core.hashing import to_int32_bits


def insert_planned_ref(
    matrix: torch.Tensor,
    block_ids: torch.Tensor,
    offsets: torch.Tensor,
    *,
    rows_per_block: int,
) -> torch.Tensor:
    """OR every valid lane's bit into the (n_rows, W) int32 ``matrix`` in
    place; returns ``matrix``.

    The planner's offsets are deduplicated, so the single-bit words of one
    matrix word are disjoint and summing them (int64, per distinct word)
    equals OR-ing them — the reference oracle's trick
    (``repro.kernels.idl_insert.ref.insert_runs_ref``).
    """
    valid = offsets >= 0
    off = offsets[valid].to(torch.int64)
    block = block_ids.to(torch.int64)[:, None].expand_as(offsets)[valid]
    word = block * (rows_per_block * matrix.shape[1]) + (off >> 5)
    bit = torch.ones_like(off) << (off & 31)
    words, inverse = torch.unique(word, return_inverse=True)
    acc = torch.zeros_like(words).index_add_(0, inverse, bit)
    flat = matrix.view(-1)
    flat[words] = flat[words] | to_int32_bits(acc)
    return matrix
