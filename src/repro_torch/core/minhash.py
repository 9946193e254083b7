"""MinHash, rolling (sliding-window) MinHash, densified one-permutation hashing.

Port of :mod:`repro.core.minhash`. Stride-1 kmers have contiguous sub-kmer
windows, so a rolling MinHash is a sliding-window minimum (the
``window_min`` CUDA kernel on a CUDA tensor, its Gil–Werman plain version
on a CPU one), one launch per MinHash: the η masked DOPH minima, or the η
exact repetitions, come out of one call. Every function works along the
last axis of any-rank input, so a batch of reads takes one pass; the η
repetitions sit on the axis before it, ``(..., η, n_kmers)``.

The 64-bit functions carry ``uint64`` hashes in ``int64`` (see
:mod:`repro_torch.core.hashing`). The rolling minima compare them in
unsigned order (the kernel's ``unsigned`` flag); elsewhere unsigned order
is signed order after the sign bit is flipped (:data:`SIGN`).
:data:`UINT64_MAX`, the empty-bin sentinel, is ``-1``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.core import hashing
from repro_torch.kernels.window_min import ops as window_min_ops
from repro_torch.kernels.window_min import ref as window_min_ref

# Largest 32-bit lane value: the "empty DOPH bin" sentinel of the 32-bit
# location path.
FILL32 = 0xFFFFFFFF
# uint64 0xFFFF...FF (the 64-bit empty-bin sentinel) as int64
UINT64_MAX = -1
# XOR with the sign bit maps unsigned order onto signed order
SIGN = -(1 << 63)
# A 64-bit hash's DOPH bin is the Lemire reduction of the bits above this
BIN_SHIFT = 32
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


def _umin(h: torch.Tensor, dim: int) -> torch.Tensor:
    """Minimum over ``dim`` of int64-carried uint64 values, unsigned order."""
    return (h ^ SIGN).amin(dim) ^ SIGN


def minhash_exact(subk: torch.Tensor, w: int, seeds: Sequence[int]
                  ) -> torch.Tensor:
    """η independent rolling MinHashes: ``(..., η, n_sub - w + 1)``."""
    h = torch.stack([hashing.hash64(subk, s) for s in seeds], dim=-2)
    return window_min_ops.window_min(h, w, unsigned=True)


def _bins(h: torch.Tensor, eta: int) -> torch.Tensor:
    """DOPH bin of each hash: Lemire reduction of its top 32 bits (what the
    ``window_min`` kernel derives with ``bin_shift=BIN_SHIFT``)."""
    return window_min_ref.doph_bins(h, eta, BIN_SHIFT)


def doph_minhash(subk: torch.Tensor, w: int, eta: int, seed: int = 0x0D0F
                 ) -> torch.Tensor:
    """Densified one-permutation rolling MinHash: one hash evaluation per
    sub-kmer yields η repetitions per kmer, ``(..., η, n_sub - w + 1)``."""
    h = hashing.hash64(subk, seed)
    mh = window_min_ops.window_min(h, w, n_bins=eta, bin_shift=BIN_SHIFT,
                                   fill=UINT64_MAX, unsigned=True)
    return densify_rotation(mh)     # UINT64_MAX marks empty bins


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
