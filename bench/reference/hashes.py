"""The 32-bit lane hash path of the bit-sliced index, frozen in plain
PyTorch: packed kmers, the seeded murmur3-style pair hash, the rolling
densified one-permutation MinHash (DOPH), the IDL anchor + offset and the
partitioned random hash (RH).

Values ride in int64 tensors holding uint32 lanes in ``[0, 2**32)``:
every product and sum is masked back to 32 bits, so ``>>`` is a logical
shift. Locations are int64 row indices in ``[0, m)``. Codes are uint8
bases in {0, 1, 2, 3} along the last axis; every function takes any
leading axes and any device.
"""

from __future__ import annotations

import dataclasses

import torch

M32 = 0xFFFFFFFF
_M1 = 0x85EBCA6B
_M2 = 0xC2B2AE35
_GOLDEN = 0x9E3779B9
SALT_MH = 0x0D0F
SALT_LOCAL = 0x10CA
SALT_RH = 0x5EED
EMPTY = M32          # an empty DOPH bin


@dataclasses.dataclass(frozen=True)
class Geometry:
    """One index's hashing geometry (the keys of a configuration file)."""

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
        if not 1 <= self.t <= 16 or not self.t <= self.k <= 31:
            raise ValueError(f"need t <= 16 and t <= k <= 31 on the 32-bit "
                             f"path, got t={self.t} k={self.k}")

    @property
    def w(self) -> int:
        return self.k - self.t + 1

    @property
    def m_part(self) -> int:
        part = self.m // self.eta
        return (part // self.L) * self.L if self.align else part


def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32``; ``c`` split in 16-bit halves when the int64
    product could pass 2**63."""
    c &= M32
    if c < (1 << 31):
        return (x * c) & M32
    return ((((x * (c >> 16)) & 0xFFFF) << 16) + x * (c & 0xFFFF)) & M32


def mix32(x: torch.Tensor) -> torch.Tensor:
    """The murmur3 32-bit finalizer."""
    x = x ^ (x >> 16)
    x = mul32(x, _M1)
    x = x ^ (x >> 13)
    x = mul32(x, _M2)
    return x ^ (x >> 16)


def hash_pair32(hi: torch.Tensor, lo: torch.Tensor, seed: int
                ) -> torch.Tensor:
    """Seeded 32-bit hash of a 64-bit key given as its two 32-bit halves."""
    s = int(seed) & M32
    c1 = ((s * _GOLDEN) & M32) | 1
    c2 = (((s ^ 0xDEADBEEF) * _M1) & M32) | 1
    h = mix32((mul32(lo, c1) + c2) & M32)
    return mix32(h ^ ((mul32(hi, c2) + c1) & M32))


def to_range(h: torch.Tensor, m: int) -> torch.Tensor:
    """A 32-bit hash into ``[0, m)``: a split multiply-shift under 2**15,
    the top bits for a power of two, a modulo otherwise."""
    if m < (1 << 15):
        return (((h >> 16) * m) + (((h & 0xFFFF) * m) >> 16)) >> 16
    if m & (m - 1) == 0:
        return h >> (32 - (m.bit_length() - 1))
    return h % m


def pack(codes: torch.Tensor, lo: int, hi: int, out_len: int
         ) -> torch.Tensor:
    """Bases ``lo .. hi-1`` of every window of the last axis, two bits
    each, the first base highest."""
    c = codes.to(torch.int64)
    acc = torch.zeros(codes.shape[:-1] + (out_len,), dtype=torch.int64,
                      device=codes.device)
    for j in range(lo, hi):
        acc = (acc << 2) | c[..., j:j + out_len]
    return acc


def doph_minhash(g: Geometry, codes: torch.Tensor) -> torch.Tensor:
    """``(..., η, n_kmers)`` rolling DOPH MinHash of every kmer's
    ``w`` sub-kmers, each empty bin filled by rotation from the next
    non-empty one (each rotation reading what the last one filled)."""
    sub = pack(codes, 0, g.t, codes.shape[-1] - g.t + 1)
    h = mix32((mul32(sub, _GOLDEN) + SALT_MH) & M32)
    bins = ((h >> 16) * g.eta) >> 16
    mins = []
    for j in range(g.eta):
        masked = torch.where(bins == j, h, EMPTY)
        mins.append(masked.unfold(-1, g.w, 1).amin(-1))
    mh = torch.stack(mins, dim=-2)
    for off in range(1, g.eta):
        donor = torch.roll(mh, -off, dims=-2)
        mh = torch.where((mh == EMPTY) & (donor != EMPTY),
                         (donor + ((_GOLDEN * off) & M32)) & M32, mh)
    return mh


def locations(g: Geometry, codes: torch.Tensor) -> torch.Tensor:
    """``(..., η, n_kmers)`` int64 row locations of every stride-1 kmer."""
    n_k = codes.shape[-1] - g.k + 1
    if n_k < 1:
        raise ValueError(f"{codes.shape[-1]} bases hold no {g.k}-mer")
    n_hi = g.k - min(g.k, 16)
    hi, lo = pack(codes, 0, n_hi, n_k), pack(codes, n_hi, g.k, n_k)
    mh = doph_minhash(g, codes) if g.scheme == "idl" else None
    out = []
    for j in range(g.eta):
        if g.scheme == "idl":
            mixed = mix32(mul32(mh[..., j, :], 2 * j + 3))
            if g.align:
                anchor = to_range(mixed, g.m_part // g.L) * g.L
            else:
                anchor = to_range(mixed, g.m_part - g.L)
            base = anchor + to_range(
                hash_pair32(hi, lo, SALT_LOCAL + 31 * j), g.L)
        else:
            base = to_range(hash_pair32(hi, lo, SALT_RH + 31 * j), g.m_part)
        out.append((base + j * g.m_part) & M32)
    return torch.stack(out, dim=-2)
