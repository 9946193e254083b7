"""Wrapper of the CUDA kernel ``csrc/window_min.cu``.

Replaces the Pallas kernel ``repro/kernels/window_min/kernel.py::window_min``.
A CPU tensor takes the plain version (:mod:`.ref`); a CUDA tensor launches
the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.window_min import ref

NAME = "window_min"
SOURCE = "src/repro_torch/csrc/window_min.cu"
REPLACES = "src/repro/kernels/window_min/kernel.py:36"
MAX_WINDOW = 1024   # the TPU kernel's tile: the longest window it took

# Kernel launches so far (reset and read by callers that must show the
# kernel ran); counts launches only, never the plain version.
launches = 0

# the C entry's dtype codes
_DTYPES = {torch.int64: 0, torch.int32: 1, torch.float32: 2}
_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 2 + [
    ctypes.c_int] * 2 + [ctypes.c_void_p]


def window_min(a: torch.Tensor, w: int) -> torch.Tensor:
    """``out[..., i] = min(a[..., i : i + w])`` along the last axis of a
    contiguous int64, int32 or float32 tensor; ``1 <= w <= 1024``."""
    n = a.shape[-1] if a.dim() else 0
    if not 1 <= w <= n:
        raise ValueError(f"{NAME}: need 1 <= w <= length, got w={w}, "
                         f"length {n}")
    if a.device.type == "cpu":
        return ref.window_min_ref(a, w=w)
    if a.device.type != "cuda" or a.dtype not in _DTYPES or \
            not a.is_contiguous():
        raise ValueError(f"{NAME}: needs a contiguous int64, int32 or "
                         f"float32 CUDA tensor, got {a.dtype} on {a.device} "
                         f"(contiguous={a.is_contiguous()})")
    if w > MAX_WINDOW:
        raise ValueError(f"{NAME}: window {w} exceeds {MAX_WINDOW}")
    out = torch.empty(a.shape[:-1] + (n - w + 1,), dtype=a.dtype,
                      device=a.device)
    rows = a.numel() // n
    if rows == 0:
        return out
    fn = getattr(build.library(NAME, _ARGTYPES), NAME)
    with torch.cuda.device(a.device):
        err = fn(a.data_ptr(), out.data_ptr(), rows, n, w, _DTYPES[a.dtype],
                 torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{NAME}: launch failed with CUDA error {err}")
    global launches
    launches += 1
    return out
