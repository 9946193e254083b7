"""Entry point of the sliding-window minimum (the rolling MinHash core).

:func:`window_min` runs the CUDA kernel on a CUDA tensor and the plain
Gil–Werman version (:mod:`.ref`) on a CPU tensor.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.window_min import kernel


def window_min(a: torch.Tensor, w: int) -> torch.Tensor:
    """``out[..., i] = min(a[..., i : i + w])`` along the last axis of an
    int64, int32 or float32 tensor (1 <= w <= its length)."""
    return kernel.window_min(a.contiguous(), w)
