"""Wrapper of the CUDA kernel ``csrc/window_min.cu``.

Replaces the Pallas kernel ``repro/kernels/window_min/kernel.py::window_min``.
A CPU tensor takes the plain version (:mod:`.ref`); a CUDA tensor launches
the kernel or raises.
"""

from __future__ import annotations

import ctypes
import struct
from typing import Optional

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
    ctypes.c_int] * 3 + [ctypes.c_longlong] + [ctypes.c_int] * 2 + [
    ctypes.c_void_p]


def window_min(
    a: torch.Tensor,
    w: int,
    *,
    n_bins: Optional[int] = None,
    bin_shift: Optional[int] = None,
    fill=None,
    unsigned: bool = False,
) -> torch.Tensor:
    """Sliding-window minima along the last axis of a contiguous int64,
    int32 or float32 tensor, ``1 <= w <= 1024``, in one launch.

    Without ``n_bins``: ``out[..., i] = min(a[..., i : i + w])`` (an
    ``(..., η, n)`` input gives every MinHash repetition at once). With
    ``n_bins`` and ``bin_shift`` (int64 only), the DOPH form: each hash
    ``h`` falls in bin ``((h >> s) * n_bins) >> s`` (uint64 arithmetic,
    ``s = bin_shift``, ``0 < s < 64``) and ``out[..., j, i]`` is the minimum over ``t < w``
    of the ``a[..., i + t]`` in bin ``j`` (``fill`` when there is none),
    shape ``(..., n_bins, n - w + 1)``; ``fill`` defaults to the largest
    value in the order used. ``unsigned`` compares int64 as uint64.
    """
    n = a.shape[-1] if a.dim() else 0
    if not 1 <= w <= n:
        raise ValueError(f"{NAME}: need 1 <= w <= length, got w={w}, "
                         f"length {n}")
    if unsigned and a.dtype != torch.int64:
        raise ValueError(f"{NAME}: unsigned order needs int64 (the uint64 "
                         f"carrier), got {a.dtype}")
    if n_bins is not None:
        if n_bins < 1 or bin_shift is None or not 0 < bin_shift < 64 or \
                a.dtype != torch.int64:
            raise ValueError(
                f"{NAME}: the DOPH form needs int64 hashes, n_bins >= 1 and "
                f"0 < bin_shift < 64, got {a.dtype}, n_bins={n_bins}, "
                f"bin_shift={bin_shift}")
        if fill is None:
            fill = ref.maxval(a.dtype, unsigned)
    if a.device.type == "cpu":
        return ref.window_min_binned_ref(a, w=w, n_bins=n_bins,
                                         bin_shift=bin_shift, fill=fill,
                                         unsigned=unsigned)
    if a.device.type != "cuda" or a.dtype not in _DTYPES or \
            not a.is_contiguous():
        raise ValueError(f"{NAME}: needs a contiguous int64, int32 or "
                         f"float32 CUDA tensor, got {a.dtype} on {a.device} "
                         f"(contiguous={a.is_contiguous()})")
    if w > MAX_WINDOW:
        raise ValueError(f"{NAME}: window {w} exceeds {MAX_WINDOW}")
    binned = () if n_bins is None else (n_bins,)
    out = torch.empty(a.shape[:-1] + binned + (n - w + 1,), dtype=a.dtype,
                      device=a.device)
    rows = a.numel() // n
    if rows == 0:
        return out
    build.launch(NAME, _ARGTYPES, a.device, a.data_ptr(), out.data_ptr(),
                 rows, n, w, n_bins or 0, bin_shift or 0,
                 _fill_bits(a.dtype, fill), _DTYPES[a.dtype], int(unsigned))
    global launches
    launches += 1
    return out


def _fill_bits(dtype: torch.dtype, fill) -> int:
    """The fill value's bits as the C entry reads them: the low bytes of a
    signed 64-bit integer."""
    if fill is None:
        return 0
    if dtype.is_floating_point:
        return struct.unpack("<i", struct.pack("<f", float(fill)))[0]
    width = torch.iinfo(dtype).bits
    bits = int(fill) & ((1 << width) - 1)
    return bits - (1 << 64) if bits >= 1 << 63 else bits
