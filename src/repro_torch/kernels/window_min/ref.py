"""Plain PyTorch versions of the ``window_min`` kernel: the Gil–Werman
sliding minimum, its binned and unsigned forms, and a naive check."""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.hashing import lshr


def maxval(dtype: torch.dtype, unsigned: bool = False):
    """The value no element exceeds in the order used: the dtype's maximum
    (``inf`` for floats), as the reference's ``_maxval``, or all ones (-1
    in the signed carrier) in unsigned order."""
    if unsigned:
        return -1
    if dtype.is_floating_point:
        return float("inf")
    return torch.iinfo(dtype).max


def doph_bins(h: torch.Tensor, n_bins: int, bin_shift: int) -> torch.Tensor:
    """The DOPH bin of each int64 hash: ``((h >> s) * n_bins) >> s`` in
    uint64 arithmetic (logical shifts; the product wraps as uint64 does)."""
    return lshr(lshr(h, bin_shift) * n_bins, bin_shift)


def window_min_binned_ref(
    a: torch.Tensor, *, w: int, n_bins: Optional[int] = None,
    bin_shift: Optional[int] = None, fill=None, unsigned: bool = False,
) -> torch.Tensor:
    """The kernel's two forms, from plain parts: without ``n_bins``
    :func:`window_min_ref` over the last axis; with them the stack over
    ``j < n_bins`` of ``torch.where(doph_bins(a) == j, a, fill)``, then the
    same minimum, ``(..., n_bins, n - w + 1)``. ``unsigned`` flips the sign
    bit before and after, so signed order does unsigned order's work."""
    if n_bins is not None:
        if fill is None:
            fill = maxval(a.dtype, unsigned)
        bins = doph_bins(a, n_bins, bin_shift)
        a = torch.stack([torch.where(bins == j, a, fill)
                         for j in range(n_bins)], dim=-2)
    if not unsigned:
        return window_min_ref(a, w=w)
    sign = torch.iinfo(a.dtype).min
    return window_min_ref(a ^ sign, w=w) ^ sign


def window_min_ref(a: torch.Tensor, *, w: int) -> torch.Tensor:
    """``out[..., i] = min(a[..., i : i + w])`` over the last axis.

    Gil–Werman: two prefix-min passes (``torch.cummin``) over blocks of
    ``w``; the final partial block is padded with the dtype's maximum, so
    any value the dtype holds — sign-flipped 64-bit hashes included — is
    handled.
    """
    n = a.shape[-1]
    if w == 1:
        return a
    nb = -(-n // w)
    pad = nb * w - n
    if pad:
        a = torch.cat([a, a.new_full(a.shape[:-1] + (pad,), maxval(a.dtype))],
                      dim=-1)
    blocks = a.reshape(a.shape[:-1] + (nb, w))
    # prefix[i] = min(block_start..i); suffix[i] = min(i..block_end)
    prefix = torch.cummin(blocks, dim=-1).values.flatten(-2)
    suffix = torch.cummin(blocks.flip(-1), dim=-1).values.flip(-1).flatten(-2)
    out_len = n - w + 1
    # window [i, i+w-1] spans at most two blocks: suffix of the first plus
    # prefix of the second covers it exactly
    return torch.minimum(suffix[..., :out_len], prefix[..., w - 1:w - 1 + out_len])


def window_min_naive(a: torch.Tensor, *, w: int) -> torch.Tensor:
    """The same minimum, window by window (a check for the others)."""
    return a.unfold(-1, w, 1).amin(-1)
