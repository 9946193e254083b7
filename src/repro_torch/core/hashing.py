"""Seeded integer hashes: the 64-bit family and the 32-bit lane path.

Port of :mod:`repro.core.hashing` (the murmur3 finalizers with
seed-derived odd multipliers, and the Lemire-style range reductions).

* **64-bit family** — ``uint64`` values travel in ``int64`` tensors with the
  same 64 bits. Products and sums wrap mod 2**64 exactly as ``uint64``
  does; every ``>>`` is made logical with :func:`lshr` (mask after the
  arithmetic shift). Constants above 2**63 enter as their signed twins
  (:func:`s64`).
* **32-bit lane path** — ``int64`` tensors hold ``uint32`` values in
  ``[0, 2**32)``: every product and sum is reduced with ``& M32``, so the
  low 32 bits equal the reference's wrapped ``uint32`` arithmetic exactly
  and ``>>`` on the non-negative values is a logical shift.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

M32 = 0xFFFFFFFF
M64 = (1 << 64) - 1
_M1_64 = 0xFF51AFD7ED558CCD
_M2_64 = 0xC4CEB9FE1A85EC53
_GOLDEN_64 = 0x9E3779B97F4A7C15
_M1_32 = 0x85EBCA6B
_M2_32 = 0xC2B2AE35
_GOLDEN_32 = 0x9E3779B9


def s64(c: int) -> int:
    """The int64 value with the same 64 bits as the uint64 constant ``c``."""
    c &= M64
    return c - (1 << 64) if c >> 63 else c


def lshr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64-carried uint64 values (0 < s < 64)."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def seed_const64(seed: int) -> int:
    """Derive a well-mixed odd 64-bit multiplier from a small integer seed
    (a Python int in ``[0, 2**64)``: the reference's uint64 scalar)."""
    s = ((int(seed) + _GOLDEN_64) * _M1_64) & M64
    s ^= s >> 29
    s = (s * _M2_64) & M64
    s ^= s >> 32
    return s | 1


def mix64(x: torch.Tensor) -> torch.Tensor:
    """murmur3 64-bit finalizer (bijective avalanche on uint64 values)."""
    x = x.to(torch.int64)
    x = x ^ lshr(x, 33)
    x = x * s64(_M1_64)
    x = x ^ lshr(x, 33)
    x = x * s64(_M2_64)
    return x ^ lshr(x, 33)


def hash64(x: torch.Tensor, seed: int) -> torch.Tensor:
    """Seeded 64-bit hash: full-range uint64 values carried in int64."""
    c = seed_const64(seed)
    return mix64(x.to(torch.int64) * s64(c) + (c >> 17))


def hash_to_range(x: torch.Tensor, seed: int, m: int) -> torch.Tensor:
    """Seeded hash of integer keys into ``[0, m)`` (int64 values).

    The multiply-shift (Lemire) reduction on the top 32 bits of a 64-bit
    hash. ``hi * m`` can reach 2**64 (m = 2**32), so the int64 product
    wraps negative; its top 32 bits are still ``(p >> 32) & M32``.
    """
    if m <= 0:
        raise ValueError(f"range m must be positive, got {m}")
    if m > (1 << 32):
        raise ValueError(f"range m={m} exceeds uint32")
    hi = lshr(hash64(x, seed), 32)
    return ((hi * s64(m)) >> 32) & M32


def hash_family_to_range(x: torch.Tensor, seeds: Sequence[int], m: int
                         ) -> torch.Tensor:
    """``(len(seeds),) + x.shape`` independent hashes of x into [0, m)."""
    return torch.stack([hash_to_range(x, s, m) for s in seeds], dim=0)


def np_hash64(x: np.ndarray, seed: int) -> np.ndarray:
    """Pure-numpy mirror of :func:`hash64` (host-side pipelines; uint64)."""
    with np.errstate(over="ignore"):
        s = np.uint64(seed)
        s = (s + np.uint64(_GOLDEN_64)) * np.uint64(_M1_64)
        s ^= s >> np.uint64(29)
        s *= np.uint64(_M2_64)
        s ^= s >> np.uint64(32)
        c = s | np.uint64(1)
        x = x.astype(np.uint64) * c + (c >> np.uint64(17))
        x ^= x >> np.uint64(33)
        x *= np.uint64(_M1_64)
        x ^= x >> np.uint64(33)
        x *= np.uint64(_M2_64)
        x ^= x >> np.uint64(33)
    return x


def np_hash_to_range(x: np.ndarray, seed: int, m: int) -> np.ndarray:
    h = np_hash64(x, seed)
    hi = h >> np.uint64(32)
    with np.errstate(over="ignore"):
        return ((hi * np.uint64(m)) >> np.uint64(32)).astype(np.uint32)


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
