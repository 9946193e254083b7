"""The 64-bit hash path of the flat and RAMBO filters, frozen in plain
PyTorch: packed kmers, the seeded 64-bit murmur3-style hash, the rolling
densified one-permutation MinHash (DOPH), the IDL anchor + offset and the
partitioned random hash (RH).

Values ride in int64 tensors holding the same 64 bits as the uint64
values they stand for: products and sums wrap mod 2**64 as uint64 does,
every right shift is made logical by a mask, and unsigned order is signed
order after the sign bit is flipped. Locations are int64 bit offsets in
``[0, m)``. Codes are uint8 bases in {0, 1, 2, 3} along the last axis;
every function takes any leading axes and any device.
"""

from __future__ import annotations

import dataclasses

import torch

M32 = 0xFFFFFFFF
M64 = (1 << 64) - 1
_M1 = 0xFF51AFD7ED558CCD
_M2 = 0xC4CEB9FE1A85EC53
_GOLDEN = 0x9E3779B97F4A7C15
SALT_MH = 0x0D0F
SALT_ANCHOR = 0xA17C
SALT_LOCAL = 0x10CA
SALT_RH = 0x5EED
EMPTY = -1               # an empty DOPH bin: uint64 0xFFFF...FF
SIGN = -(1 << 63)        # XOR with it maps unsigned order onto signed


@dataclasses.dataclass(frozen=True)
class Geometry:
    """One filter's hashing geometry (the keys of a configuration file);
    ``m`` is the bits of one filter."""

    k: int
    t: int
    L: int
    eta: int
    m: int
    scheme: str              # "idl" | "rh"
    minhash_mode: str = "doph"
    align: bool = True

    def __post_init__(self):
        if self.scheme not in ("idl", "rh"):
            raise ValueError(f"reference scheme must be idl or rh, got "
                             f"{self.scheme!r}")
        if self.minhash_mode != "doph":
            raise ValueError("the reference computes the DOPH MinHash only")
        if not 1 <= self.t <= self.k <= 31:
            raise ValueError(f"need 1 <= t <= k <= 31, got t={self.t} "
                             f"k={self.k}")
        if not 0 < self.m <= (1 << 32):
            raise ValueError(f"m={self.m} must lie in (0, 2**32]")

    @property
    def w(self) -> int:
        return self.k - self.t + 1

    @property
    def m_part(self) -> int:
        part = self.m // self.eta
        return (part // self.L) * self.L if self.align else part


def signed(c: int) -> int:
    """The int64 value with the same 64 bits as the uint64 constant ``c``."""
    c &= M64
    return c - (1 << 64) if c >> 63 else c


def shr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of uint64 bits carried in int64 (0 < s < 64)."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def seed_multiplier(seed: int) -> int:
    """The odd 64-bit multiplier of a seed, as a Python int."""
    s = ((int(seed) + _GOLDEN) * _M1) & M64
    s ^= s >> 29
    s = (s * _M2) & M64
    s ^= s >> 32
    return s | 1


def mix64(x: torch.Tensor) -> torch.Tensor:
    """The murmur3 64-bit finalizer."""
    x = x ^ shr(x, 33)
    x = x * signed(_M1)
    x = x ^ shr(x, 33)
    x = x * signed(_M2)
    return x ^ shr(x, 33)


def hash64(x: torch.Tensor, seed: int) -> torch.Tensor:
    """Seeded 64-bit hash of int64 keys."""
    c = seed_multiplier(seed)
    return mix64(x.to(torch.int64) * signed(c) + (c >> 17))


def to_range(x: torch.Tensor, seed: int, m: int) -> torch.Tensor:
    """Seeded hash of int64 keys into ``[0, m)``: the top 32 bits of
    :func:`hash64` times ``m``, shifted down 32. The product is below
    2**64, so its top half survives the int64 wrap."""
    hi = shr(hash64(x, seed), 32)
    return ((hi * signed(m)) >> 32) & M32


def pack(codes: torch.Tensor, n: int) -> torch.Tensor:
    """Every stride-1 window of ``n`` bases of the last axis, two bits a
    base, the first base highest."""
    c = codes.to(torch.int64)
    out_len = codes.shape[-1] - n + 1
    acc = torch.zeros(codes.shape[:-1] + (out_len,), dtype=torch.int64,
                      device=codes.device)
    for j in range(n):
        acc = (acc << 2) | c[..., j:j + out_len]
    return acc


def doph_minhash(g: Geometry, codes: torch.Tensor) -> torch.Tensor:
    """``(..., η, n_kmers)`` rolling DOPH MinHash of every kmer's ``w``
    sub-kmers, in unsigned order; each empty bin borrows from the nearest
    bin after it that was not empty before any borrowing, offset by the
    golden constant times the distance."""
    h = hash64(pack(codes, g.t), SALT_MH)
    bins = shr(shr(h, 32) * g.eta, 32)
    mh = torch.stack([
        (torch.where(bins == j, h, EMPTY) ^ SIGN).unfold(-1, g.w, 1)
        .amin(-1) ^ SIGN
        for j in range(g.eta)], dim=-2)
    out = mh
    for off in range(1, g.eta):
        donor = torch.roll(mh, -off, dims=-2)
        out = torch.where((out == EMPTY) & (donor != EMPTY),
                          donor + signed(_GOLDEN * off), out)
    return out


def locations(g: Geometry, codes: torch.Tensor) -> torch.Tensor:
    """``(..., η, n_kmers)`` int64 bit locations of every stride-1 kmer."""
    if codes.shape[-1] < g.k:
        raise ValueError(f"{codes.shape[-1]} bases hold no {g.k}-mer")
    kmer = pack(codes, g.k)
    mh = doph_minhash(g, codes) if g.scheme == "idl" else None
    out = []
    for j in range(g.eta):
        if g.scheme == "idl":
            if g.align:
                anchor = to_range(mh[..., j, :], SALT_ANCHOR + 31 * j,
                                  g.m_part // g.L) * g.L
            else:
                anchor = to_range(mh[..., j, :], SALT_ANCHOR + 31 * j,
                                  g.m_part - g.L)
            base = anchor + to_range(kmer, SALT_LOCAL + 31 * j, g.L)
        else:
            base = to_range(kmer, SALT_RH + 31 * j, g.m_part)
        out.append((base + j * g.m_part) & M32)
    return torch.stack(out, dim=-2)
