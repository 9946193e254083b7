"""Plain PyTorch version of the ``rambo_merge_coverage`` kernel: the
merge and coverage chain it replaces, RAMBO's R gathers and R - 1 ANDs of
bucket columns (``RamboIndex.query_batch``) and the cast, mask, sum and
compare of ``query.member_coverage``."""

from __future__ import annotations

from typing import Optional, Union

import torch


def merge_coverage_ref(ans: torch.Tensor, assign: torch.Tensor,
                       need: Union[int, torch.Tensor],
                       valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, N) bool: for each read b and file f, whether the kmers k with
    ``valid[b, k]`` and ``ans[b, k, r·n_buckets + assign[r, f]] == 1`` for
    every repetition r number at least ``need[b]`` (or the scalar
    ``need``). ``ans`` is the (B, n_k, R·n_buckets) int32 {0, 1} answers,
    ``assign`` the (R, N) file -> bucket map."""
    b, n_k, width = ans.shape
    n_rep = assign.shape[0]
    grid = (ans == 1).reshape(b, n_k, n_rep, width // n_rep)
    idx = assign.to(torch.int64)
    member = grid[:, :, 0, idx[0]]
    for r in range(1, n_rep):
        member &= grid[:, :, r, idx[r]]
    hits = member.to(torch.int64)
    if valid is not None:
        hits = hits * valid.to(torch.int64)[:, :, None]
    hits = hits.sum(dim=1)
    if isinstance(need, torch.Tensor):
        need = need.to(torch.int64)[:, None]
    return hits >= need
