"""Rolling MinHash core: the Gil–Werman sliding-window minimum.

Port of :func:`repro.core.minhash.sliding_window_min`. Stride-1 kmers have
contiguous sub-kmer windows, so a rolling MinHash is a sliding-window
minimum, computed in two prefix-min passes (``torch.cummin``) over blocks
of ``w``. Works along the last axis of any-rank input, so a batch of reads
takes one pass.
"""

from __future__ import annotations

import torch

# Largest 32-bit lane value: the fill of padded slots, and the "empty DOPH
# bin" sentinel of the 32-bit location path.
FILL32 = 0xFFFFFFFF


def sliding_window_min(a: torch.Tensor, w: int) -> torch.Tensor:
    """``out[..., i] = min(a[..., i : i + w])`` over the last axis, for
    32-bit lane values held in int64 (the final partial block is padded
    with :data:`FILL32`, which no lane value exceeds)."""
    n = a.shape[-1]
    if w < 1:
        raise ValueError(f"window must be >= 1, got {w}")
    if n < w:
        raise ValueError(f"length {n} < window {w}")
    if w == 1:
        return a
    nb = -(-n // w)
    pad = nb * w - n
    if pad:
        a = torch.cat([a, a.new_full(a.shape[:-1] + (pad,), FILL32)], dim=-1)
    blocks = a.reshape(a.shape[:-1] + (nb, w))
    # prefix[i] = min(block_start..i); suffix[i] = min(i..block_end)
    prefix = torch.cummin(blocks, dim=-1).values.flatten(-2)
    suffix = torch.cummin(blocks.flip(-1), dim=-1).values.flip(-1).flatten(-2)
    out_len = n - w + 1
    # window [i, i+w-1] spans at most two blocks: suffix of the first plus
    # prefix of the second covers it exactly
    return torch.minimum(suffix[..., :out_len], prefix[..., w - 1:w - 1 + out_len])
