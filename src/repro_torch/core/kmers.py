"""DNA tokenization: strings -> 2-bit codes -> packed kmers (32-bit lanes).

Port of :mod:`repro.core.kmers`, 32-bit lane path. Codes are ``uint8``
tensors in {0,1,2,3} (A=0 C=1 G=2 T=3); packed values are ``int64`` tensors
holding the reference's ``uint32`` lane values. Every function packs along
the last axis, so a ``(B, n)`` batch of reads packs in one pass.
"""

from __future__ import annotations

import numpy as np
import torch

BASES = "ACGT"
_LUT = np.zeros(256, dtype=np.uint8)
for _i, _b in enumerate(BASES):
    _LUT[ord(_b)] = _i
    _LUT[ord(_b.lower())] = _i


def encode_bases(s: str | bytes) -> np.ndarray:
    """ASCII DNA string -> uint8 codes in {0,1,2,3} (host-side)."""
    if isinstance(s, str):
        s = s.encode("ascii", errors="replace")
    arr = np.frombuffer(s, dtype=np.uint8)
    return _LUT[arr]


def decode_bases(codes: np.ndarray) -> str:
    return "".join(BASES[int(c)] for c in codes)


def _pack(codes: torch.Tensor, lo: int, hi: int, out_len: int) -> torch.Tensor:
    """Shift-accumulate bases ``lo..hi-1`` of every window (last axis)."""
    c64 = codes.to(torch.int64)
    acc = torch.zeros(codes.shape[:-1] + (out_len,), dtype=torch.int64,
                      device=codes.device)
    for j in range(lo, hi):
        acc = (acc << 2) | c64[..., j:j + out_len]
    return acc


def pack_kmers_u32(codes: torch.Tensor, t: int) -> torch.Tensor:
    """Packed t-mers (t <= 16) on the 32-bit lane path, as int64 values."""
    if not 1 <= t <= 16:
        raise ValueError(f"t must be in [1, 16] for uint32 packing, got {t}")
    return _pack(codes, 0, t, codes.shape[-1] - t + 1)


def pack_kmers_pair32(codes: torch.Tensor, k: int
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Packed kmers as (hi, lo) 32-bit lanes (k <= 31).

    lo = last min(k,16) bases; hi = the remaining leading bases (0 if k<=16).
    """
    if not 1 <= k <= 31:
        raise ValueError(f"k must be in [1, 31], got {k}")
    out_len = codes.shape[-1] - k + 1
    n_hi = k - min(k, 16)
    return _pack(codes, 0, n_hi, out_len), _pack(codes, n_hi, k, out_len)
