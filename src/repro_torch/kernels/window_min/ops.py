"""Entry point of the sliding-window minimum (the rolling MinHash core).

:func:`window_min` runs the CUDA kernel on a CUDA tensor and the plain
Gil–Werman version (:mod:`.ref`) on a CPU tensor.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.window_min import kernel


def window_min(a: torch.Tensor, w: int, *, n_bins: Optional[int] = None,
               bin_shift: Optional[int] = None, fill=None,
               unsigned: bool = False) -> torch.Tensor:
    """Sliding-window minima along the last axis of an int64, int32 or
    float32 tensor (1 <= w <= its length), in one launch: plain, or the
    DOPH form's ``n_bins`` masked minima (see :func:`kernel.window_min`)."""
    return kernel.window_min(a.contiguous(), w, n_bins=n_bins,
                             bin_shift=bin_shift, fill=fill,
                             unsigned=unsigned)
