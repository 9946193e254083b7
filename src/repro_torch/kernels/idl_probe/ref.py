"""Plain PyTorch versions of the ``gather_planned_rows`` kernel (and its bit
mode), the ``probe_planned_bits`` kernel and the ``probe_plan_counts``
kernel (the planner's run count, on the device), the reference's run-plan
probe layout, and the flat-filter probe oracle."""

from __future__ import annotations

import torch

from repro_torch.core import bloom


def and_reduce(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Bitwise AND over axis ``dim`` (torch has no AND reduction): a
    halving fold, log2(n) elementwise ANDs."""
    x = x.movedim(dim, 0)
    while x.shape[0] > 1:
        half = x.shape[0] // 2
        y = x[:half] & x[half:2 * half]
        if x.shape[0] % 2:
            y[0] &= x[-1]
        x = y
    return x[0]


def gather_and_ref(matrix: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """(..., n_k, W): the AND over η of the rows of the (n_rows, W)
    ``matrix`` that the (..., η, n_k) int64 ``rows`` name."""
    return and_reduce(matrix[rows], dim=-3)


def gather_bits_and_ref(matrix: torch.Tensor, locs: torch.Tensor
                        ) -> torch.Tensor:
    """(..., n_k, W) int32 {0, 1}: the AND over η of bit ``loc & 31`` of
    every word of row ``loc >> 5`` of the (n_rows, W) ``matrix``, for the
    (..., η, n_k) int64 bit locations ``locs`` (the bit mode of
    ``gather_planned_rows``)."""
    bits = (matrix[locs >> 5] >> (locs & 31)[..., None]) & 1
    return and_reduce(bits, dim=-3).to(torch.int32)


def probe_bits_and_ref(words: torch.Tensor, locs: torch.Tensor
                       ) -> torch.Tensor:
    """(..., n_k) int32 {0, 1}: the AND over η of bit ``loc & 31`` of word
    ``loc >> 5`` of the packed (n_words,) ``words``, for the (..., η, n_k)
    int64 bit locations ``locs``; of an (n_rows, W) matrix, (..., n_k, W)
    as :func:`gather_bits_and_ref`. :func:`query_membership_ref` over (η, n)
    locations is the flat case."""
    if words.dim() == 2:
        return gather_bits_and_ref(words, locs)
    bits = (words[locs >> 5] >> (locs & 31)) & 1
    return and_reduce(bits, dim=-2).to(torch.int32)


def run_starts(rows: torch.Tensor, block_bits: int,
               probes_per_run: int) -> torch.Tensor:
    """Flat bool mask of the probes that open a run of the (..., n) stream
    ``rows``, on its device: the reference planner's arithmetic. A run
    starts at each stream's start and wherever the block (``rows //
    block_bits``) changes, and is split every ``probes_per_run`` probes."""
    flat = rows.reshape(-1)
    if flat.numel() == 0:
        return torch.zeros_like(flat, dtype=torch.bool)
    blocks = flat // block_bits
    idx = torch.arange(flat.numel(), device=flat.device)
    start = torch.ones_like(flat, dtype=torch.bool)
    start[1:] = blocks[1:] != blocks[:-1]
    start[::rows.shape[-1]] = True           # a run never crosses streams
    pos_in_run = idx - torch.cummax(torch.where(start, idx, 0), 0).values
    return pos_in_run % probes_per_run == 0


def plan_counts_ref(rows: torch.Tensor, block_bits: int,
                    probes_per_run: int) -> torch.Tensor:
    """(3,) int64 on the stream's device: the planner's run count of the
    non-empty (..., n) int64 probe stream ``rows`` (:func:`run_starts`
    summed), its smallest element and its largest."""
    return torch.stack([run_starts(rows, block_bits, probes_per_run).sum(),
                        rows.min(), rows.max()])


def probe_runs_ref(
    bf_words: torch.Tensor,
    block_ids: torch.Tensor,
    offsets: torch.Tensor,
    *,
    block_words: int,
    probes_per_run: int,
) -> torch.Tensor:
    """(R, C) int32 bits of the packed flat filter; pad lanes (offset < 0)
    read as 1 (the reference's ``probe_runs`` layout)."""
    del probes_per_run
    valid = offsets >= 0
    off = torch.where(valid, offsets, 0)
    word = block_ids.to(torch.int64)[:, None] * block_words + (off >> 5)
    bit = (bf_words[word] >> (off & 31)) & 1
    return torch.where(valid, bit, 1).to(torch.int32)


def scatter_probe_order(bits: torch.Tensor, probe_index: torch.Tensor,
                        n_probes: int) -> torch.Tensor:
    """(R, C) run bits -> (n_probes,) int32 bits in probe order (every
    probe index lies in one valid lane; pad lanes, index -1, are dropped)."""
    out = torch.ones((n_probes,), dtype=torch.int32, device=bits.device)
    valid = probe_index >= 0
    out[probe_index[valid].to(torch.int64)] = bits[valid].to(torch.int32)
    return out


def query_membership_ref(bf_words: torch.Tensor, locs: torch.Tensor
                         ) -> torch.Tensor:
    """Direct packed query on (η, n) locations: ``core.bloom.query_packed``."""
    return bloom.query_packed(bf_words, locs)
