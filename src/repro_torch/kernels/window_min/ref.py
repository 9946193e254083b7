"""Plain PyTorch versions of the ``window_min`` kernel: the Gil–Werman
sliding minimum and a naive check."""

from __future__ import annotations

import torch


def _maxval(dtype: torch.dtype):
    """The pad value no element exceeds: the dtype's maximum (``inf`` for
    floats), as the reference's ``_maxval``."""
    if dtype.is_floating_point:
        return float("inf")
    return torch.iinfo(dtype).max


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
        a = torch.cat([a, a.new_full(a.shape[:-1] + (pad,), _maxval(a.dtype))],
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
