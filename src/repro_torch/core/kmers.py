"""DNA tokenization: strings -> 2-bit codes -> packed kmers / sub-kmers.

Port of :mod:`repro.core.kmers`. Codes are ``uint8`` tensors in {0,1,2,3}
(A=0 C=1 G=2 T=3); packed values are ``int64`` tensors. On the 64-bit path
a kmer (k <= 31) packs into fewer than 62 bits, so the reference's
``uint64`` values fit int64 with no sign trouble; on the 32-bit lane path
they hold the reference's ``uint32`` lane values. Every function packs
along the last axis, so a ``(B, n)`` batch of reads packs in one pass.
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


def pack_kmers(codes: torch.Tensor, k: int) -> torch.Tensor:
    """All stride-1 kmers of a code sequence, packed (1 <= k <= 31):
    ``kmer[i] = sum_j codes[i+j] << 2(k-1-j)``, shape ``(..., n - k + 1)``."""
    if not 1 <= k <= 31:
        raise ValueError(f"k must be in [1, 31], got {k}")
    n = codes.shape[-1]
    if n < k:
        raise ValueError(f"sequence length {n} < k={k}")
    return _pack(codes, 0, k, n - k + 1)


def pack_kmers_np(codes: np.ndarray, k: int) -> np.ndarray:
    """numpy mirror of :func:`pack_kmers` (host-side pipelines; uint64)."""
    n = codes.shape[0]
    out_len = n - k + 1
    acc = np.zeros((out_len,), dtype=np.uint64)
    c64 = codes.astype(np.uint64)
    for j in range(k):
        acc = (acc << np.uint64(2)) | c64[j : j + out_len]
    return acc


def subkmers_of_kmers(codes: torch.Tensor, k: int, t: int) -> torch.Tensor:
    """The packed t-mers of the whole sequence: kmer ``i``'s sub-kmer set is
    ``subk[i : i + k - t + 1]`` (the identity rolling MinHash rests on)."""
    if not 1 <= t <= k:
        raise ValueError(f"need 1 <= t <= k, got t={t}, k={k}")
    return pack_kmers(codes, t)


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


def unpack_kmer(kmer: int, k: int) -> str:
    out = []
    for j in range(k - 1, -1, -1):
        out.append(BASES[(int(kmer) >> (2 * j)) & 3])
    return "".join(out)


def kmer_subkmer_window(k: int, t: int) -> int:
    """Number of t-sub-kmers per kmer: |S(x, t)| = k - t + 1."""
    return k - t + 1
