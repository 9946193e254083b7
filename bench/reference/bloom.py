"""The flat Bloom filter's semantics in plain PyTorch: one partitioned
filter of ``m`` bits, the ``(m/32,)`` int32 words (bit ``l`` is bit
``l % 32`` of word ``l // 32``), that every kmer of every file sets its η
locations in. A kmer hits when all η of its bits are set, and a read
matches the one set when at least ``ceil(θ · n_kmers)`` of its kmers hit;
the answers are one file's column, ``(len(reads), 1)``.

The locations are :mod:`reference.hashes64`'s, summed without its wrap
mod 2**32: a filter of a human reference's kmers holds 2**35 bits, and
each repetition ``j`` lands in its own part ``[j·m', (j + 1)·m')``. Every
hash range stays within 2**32 bits (the IDL anchor ``m'/L`` and offset
``L``; the random hash's part ``m'``), as :func:`hashes64.to_range`
needs."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from reference import hashes64
from reference import index as ref_index


@dataclasses.dataclass(frozen=True)
class Geometry:
    """The flat filter's hashing geometry (the keys of a configuration
    file); ``m`` is the filter's bits, up to 2**63."""

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
        if self.m % 32 or not 0 < self.m < (1 << 63):
            raise ValueError(f"m={self.m} must be a positive multiple of 32 "
                             f"below 2**63")
        widest = max(self.ranges())
        if widest > (1 << 32):
            raise ValueError(f"a hash range of {widest} bits exceeds 2**32")

    @property
    def w(self) -> int:
        return self.k - self.t + 1

    @property
    def m_part(self) -> int:
        part = self.m // self.eta
        return (part // self.L) * self.L if self.align else part

    def ranges(self) -> tuple:
        """The ranges the locations hash into."""
        if self.scheme == "rh":
            return (self.m_part,)
        anchor = self.m_part // self.L if self.align else self.m_part - self.L
        return (anchor, self.L)


def locations(g: Geometry, codes: torch.Tensor) -> torch.Tensor:
    """``(..., η, n_kmers)`` int64 bit locations in ``[0, m)`` of every
    stride-1 kmer."""
    if codes.shape[-1] < g.k:
        raise ValueError(f"{codes.shape[-1]} bases hold no {g.k}-mer")
    kmer = hashes64.pack(codes, g.k)
    mh = hashes64.doph_minhash(g, codes) if g.scheme == "idl" else None
    out = []
    for j in range(g.eta):
        if g.scheme == "idl":
            anchor = hashes64.to_range(mh[..., j, :],
                                       hashes64.SALT_ANCHOR + 31 * j,
                                       g.ranges()[0])
            if g.align:
                anchor = anchor * g.L
            base = anchor + hashes64.to_range(
                kmer, hashes64.SALT_LOCAL + 31 * j, g.L)
        else:
            base = hashes64.to_range(kmer, hashes64.SALT_RH + 31 * j,
                                     g.m_part)
        out.append(base + j * g.m_part)
    return torch.stack(out, dim=-2)


def build_words(g: Geometry, genomes, device, *, chunk: int = 1 << 21,
                skip_last_kmer: bool = False) -> torch.Tensor:
    """The ``(m/32,)`` int32 words that indexing every kmer of every
    genome sets, ``chunk`` kmers at a time. ``skip_last_kmer`` leaves
    each file's last kmer out: the control that breaks "every kmer
    indexed"."""
    words = torch.zeros((g.m // 32,), dtype=torch.int32, device=device)
    codes, kfid, ends = ref_index.kmer_file_ids(genomes, g.k, device)
    if skip_last_kmer:
        kfid[ends - g.k] = -1
    n_starts = kfid.numel()
    for p0 in range(0, n_starts, chunk):
        p1 = min(p0 + chunk, n_starts)
        locs = locations(g, codes[p0:p1 + g.k - 1])          # (η, n)
        ref_index.or_bits(words, locs[:, kfid[p0:p1] >= 0].reshape(-1))
    return words


def kmer_hits(g: Geometry, words: torch.Tensor,
              reads: torch.Tensor) -> torch.Tensor:
    """``(S, n_kmers)`` bool: all η of the kmer's bits are set, for
    ``(S, n)`` reads."""
    locs = locations(g, reads)                           # (S, η, n_k)
    bits = words[locs >> 5] >> (locs & 31).to(torch.int32)
    return (bits & 1).bool().all(dim=1)


def verdicts(g: Geometry, words: torch.Tensor, reads, theta: float, *,
             slack: int = 0, block: int = 256) -> np.ndarray:
    """``(S, 1)`` bool: whether each read (a list of uint8 arrays, any
    lengths >= k) matches the filter's one set at coverage ``theta``,
    ``block`` reads at a time. ``slack`` lowers every read's hit
    threshold: the control that breaks θ."""
    out = np.zeros((len(reads), 1), dtype=bool)
    by_len: dict = {}
    for i, r in enumerate(reads):
        by_len.setdefault(len(r), []).append(i)
    for n, idx in by_len.items():
        need = ref_index.coverage_need(theta, n - g.k + 1) - slack
        for b0 in range(0, len(idx), block):
            sel = idx[b0:b0 + block]
            batch = torch.as_tensor(np.stack([reads[i] for i in sel]),
                                    device=words.device)
            hits = kmer_hits(g, words, batch).sum(dim=1)
            out[sel, 0] = (hits >= need).cpu().numpy()
    return out
