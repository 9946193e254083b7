"""Plain PyTorch version of the ``gather_planned_rows`` kernel."""

from __future__ import annotations

import torch


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
