"""MinHash, rolling (sliding-window) MinHash, densified one-permutation hashing.

Port of :mod:`repro.core.minhash`. Stride-1 kmers have contiguous sub-kmer
windows, so a rolling MinHash is a sliding-window minimum
(:func:`sliding_window_min`: the ``window_min`` CUDA kernel on a CUDA
tensor, its Gil–Werman plain version on a CPU one). Every function works
along the last axis of any-rank input, so a batch of reads takes one pass;
the η repetitions sit on the axis before it, ``(..., η, n_kmers)``.

The 64-bit functions carry ``uint64`` hashes in ``int64`` (see
:mod:`repro_torch.core.hashing`). Unsigned order is signed order after the
sign bit is flipped, so each minimum flips it before and after
(:data:`SIGN`); the minimum itself knows nothing of uint64.
:data:`UINT64_MAX`, the empty-bin sentinel, is ``-1``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.core import hashing
from repro_torch.kernels.window_min import ops as window_min_ops

# Largest 32-bit lane value: the "empty DOPH bin" sentinel of the 32-bit
# location path.
FILL32 = 0xFFFFFFFF
# uint64 0xFFFF...FF (the 64-bit empty-bin sentinel) as int64
UINT64_MAX = -1
# XOR with the sign bit maps unsigned order onto signed order
SIGN = -(1 << 63)
# Offset constant used by rotation densification so borrowed values do not
# collide with native values of the donor bin.
_DENSIFY_C = 0x9E3779B97F4A7C15


def sliding_window_min(a: torch.Tensor, w: int) -> torch.Tensor:
    """``out[..., i] = min(a[..., i : i + w])`` over the last axis (signed
    order for integers)."""
    n = a.shape[-1]
    if w < 1:
        raise ValueError(f"window must be >= 1, got {w}")
    if n < w:
        raise ValueError(f"length {n} < window {w}")
    return window_min_ops.window_min(a, w)


def _umin_window(h: torch.Tensor, w: int) -> torch.Tensor:
    """Sliding minimum of int64-carried uint64 values in unsigned order."""
    return sliding_window_min(h ^ SIGN, w) ^ SIGN


def _umin(h: torch.Tensor, dim: int) -> torch.Tensor:
    """Minimum over ``dim`` of int64-carried uint64 values, unsigned order."""
    return (h ^ SIGN).amin(dim) ^ SIGN


def minhash_exact(subk: torch.Tensor, w: int, seeds: Sequence[int]
                  ) -> torch.Tensor:
    """η independent rolling MinHashes: ``(..., η, n_sub - w + 1)``."""
    return torch.stack(
        [_umin_window(hashing.hash64(subk, s), w) for s in seeds], dim=-2)


def _bins(h: torch.Tensor, eta: int) -> torch.Tensor:
    """DOPH bin of each hash: Lemire reduction of its top 32 bits."""
    return (hashing.lshr(h, 32) * eta) >> 32


def doph_minhash(subk: torch.Tensor, w: int, eta: int, seed: int = 0x0D0F
                 ) -> torch.Tensor:
    """Densified one-permutation rolling MinHash: one hash evaluation per
    sub-kmer yields η repetitions per kmer, ``(..., η, n_sub - w + 1)``."""
    h = hashing.hash64(subk, seed)
    bins = _bins(h, eta)
    mh = torch.stack([
        _umin_window(torch.where(bins == j, h, UINT64_MAX), w)
        for j in range(eta)
    ], dim=-2)                      # UINT64_MAX marks empty bins
    return densify_rotation(mh)


def densify_rotation(mh: torch.Tensor) -> torch.Tensor:
    """Rotation densification over the η axis (``dim=-2``): an empty bin
    borrows from the next non-empty bin, offset by ``C * distance`` (mod
    2**64) so donor and borrower do not alias."""
    eta = mh.shape[-2]
    out = mh
    for off in range(1, eta):
        donor = torch.roll(mh, -off, dims=-2)
        candidate = donor + hashing.s64(_DENSIFY_C * off)
        out = torch.where((out == UINT64_MAX) & (donor != UINT64_MAX),
                          candidate, out)
    return out


def minhash_kmer_batch(
    kmers: torch.Tensor, k: int, t: int, eta: int, *,
    mode: str = "doph", seed: int = 0x0D0F,
    seeds: Optional[Sequence[int]] = None,
) -> torch.Tensor:
    """MinHash of arbitrary (not necessarily sequential) packed kmers,
    ``(..., η, n)``: the w = k-t+1 sub-kmers of each kmer come from shifts
    of its packed value. Agrees exactly with the rolling variants on
    stride-1 sequences."""
    w = k - t + 1
    tmask = (1 << (2 * t)) - 1
    # sub-kmer i of kmer (leftmost first) = (kmer >> 2*(k - t - i)) & mask
    subs = torch.stack(
        [(kmers >> (2 * (k - t - i))) & tmask for i in range(w)], dim=0)
    if mode == "exact":
        if seeds is None:
            raise ValueError("exact mode needs seeds")
        return torch.stack(
            [_umin(hashing.hash64(subs, s), 0) for s in seeds], dim=-2)
    h = hashing.hash64(subs, seed)
    bins = _bins(h, eta)
    return densify_rotation(torch.stack([
        _umin(torch.where(bins == j, h, UINT64_MAX), 0) for j in range(eta)
    ], dim=-2))


def jaccard_subkmers(x: int, y: int, k: int, t: int) -> float:
    """Exact Jaccard similarity of two kmers' sub-kmer sets (host-side)."""
    w = k - t + 1
    mask = (1 << (2 * t)) - 1
    sx = {(int(x) >> (2 * (k - t - i))) & mask for i in range(w)}
    sy = {(int(y) >> (2 * (k - t - i))) & mask for i in range(w)}
    return len(sx & sy) / len(sx | sy)
