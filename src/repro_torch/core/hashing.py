"""Seeded integer hashes on the 32-bit lane path.

Port of the 32-bit half of :mod:`repro.core.hashing` (the murmur3 finalizer
with seed-derived odd multipliers, and the Lemire-style range reduction).
Lane values are ``int64`` tensors holding ``uint32`` values in
``[0, 2**32)``: every product and sum is reduced with ``& M32``, so the low
32 bits equal the reference's wrapped ``uint32`` arithmetic exactly and
``>>`` on the non-negative values is a logical shift.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
_M1_32 = 0x85EBCA6B
_M2_32 = 0xC2B2AE35
_GOLDEN_32 = 0x9E3779B9


def to_int32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in ``[0, 2**32)`` -> int32 words with the same bits."""
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2**32`` for lane values ``x`` and a constant ``c``.

    A product of two 32-bit values can pass 2**63; splitting ``c`` into
    16-bit halves keeps every intermediate below 2**49, so no int64
    product ever overflows.
    """
    c &= M32
    if c < (1 << 31):
        return (x * c) & M32
    return ((((x * (c >> 16)) & 0xFFFF) << 16) + x * (c & 0xFFFF)) & M32


def mix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 32-bit finalizer (bijective avalanche on uint32 lanes)."""
    x = x ^ (x >> 16)
    x = mul32(x, _M1_32)
    x = x ^ (x >> 13)
    x = mul32(x, _M2_32)
    return x ^ (x >> 16)


def hash_pair32(hi: torch.Tensor, lo: torch.Tensor, seed: int) -> torch.Tensor:
    """Seeded 32-bit hash of a 64-bit key given as (hi, lo) 32-bit lanes."""
    s = int(seed) & M32
    c1 = ((s * _GOLDEN_32) & M32) | 1
    c2 = (((s ^ 0xDEADBEEF) * _M1_32) & M32) | 1
    h = mix32((mul32(lo, c1) + c2) & M32)
    return mix32(h ^ ((mul32(hi, c2) + c1) & M32))


def hash32_to_range(h32: torch.Tensor, m: int) -> torch.Tensor:
    """Reduce 32-bit hashes into ``[0, m)``, branch for branch as the
    reference: a split Lemire product for m < 2**15, a top-bits shift for
    powers of two, and a modulo otherwise."""
    if m <= 0 or m > (1 << 31):
        raise ValueError(f"bad range {m}")
    if m < (1 << 15):
        top = (h32 >> 16) * m
        return (top + (((h32 & 0xFFFF) * m) >> 16)) >> 16
    if m & (m - 1) == 0:
        p = int(m).bit_length() - 1
        return h32 >> (32 - p)
    return h32 % m


def hash_pair32_to_range(hi: torch.Tensor, lo: torch.Tensor, seed: int,
                         m: int) -> torch.Tensor:
    return hash32_to_range(hash_pair32(hi, lo, seed), m)
