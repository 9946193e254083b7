"""Plain PyTorch versions of the ``gather_planned_rows`` and
``probe_planned_bits`` kernels, and the flat-filter probe oracles."""

from __future__ import annotations

import torch

from repro_torch.core import bloom


def gather_planned_rows_ref(
    matrix: torch.Tensor,
    block_ids: torch.Tensor,
    offsets: torch.Tensor,
    probe_index: torch.Tensor,
    *,
    rows_per_block: int,
    n_probes: int,
) -> torch.Tensor:
    """(n_probes, W) rows in probe order: an index gather of every valid
    lane's row, scattered to its ``probe_index`` slot (pad lanes, offset
    -1, are skipped)."""
    valid = offsets >= 0
    rows = block_ids.to(torch.int64)[:, None] * rows_per_block + offsets
    out = matrix.new_empty((n_probes, matrix.shape[1]))
    out[probe_index[valid].to(torch.int64)] = matrix[rows[valid]]
    return out


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


def probe_planned_bits_ref(
    bf_words: torch.Tensor,
    block_ids: torch.Tensor,
    offsets: torch.Tensor,
    probe_index: torch.Tensor,
    *,
    block_words: int,
    n_probes: int,
) -> torch.Tensor:
    """(n_probes,) bits in probe order: :func:`probe_runs_ref` followed by
    the probe-order scatter."""
    bits = probe_runs_ref(bf_words, block_ids, offsets,
                          block_words=block_words,
                          probes_per_run=offsets.shape[1])
    return scatter_probe_order(bits, probe_index, n_probes)


def query_membership_ref(bf_words: torch.Tensor, locs: torch.Tensor
                         ) -> torch.Tensor:
    """Direct packed query on (η, n) locations: ``core.bloom.query_packed``."""
    return bloom.query_packed(bf_words, locs)
