"""RAMBO's semantics in plain PyTorch: R repetitions of B bucket filters
of ``m`` bits each, stacked as the ``(R·B, m/32)`` int32 words (filter
``r·B + b`` is repetition ``r``'s bucket ``b``; bit ``l`` of a filter is
bit ``l % 32`` of its word ``l // 32``). Repetition ``r`` puts file ``f``
in bucket ``assign[r, f]``, and every kmer of the file sets its η
locations in that bucket's filter, for every ``r``. A kmer hits file ``f``
when all η of its bits are set in the file's bucket filter of every
repetition, and a read matches the file when at least
``ceil(θ · n_kmers)`` of its kmers hit it."""

from __future__ import annotations

import numpy as np
import torch

from reference import hashes64
from reference import index as ref_index

ASSIGN_SEED = 0xA3B0       # repetition r hashes file ids with seed + r


def assignment(n_files: int, n_buckets: int, n_rep: int) -> np.ndarray:
    """``(R, N)`` int64: the bucket of every file in every repetition, the
    seeded 64-bit hash of its id into ``[0, B)``."""
    files = torch.arange(n_files, dtype=torch.int64)
    return np.stack([hashes64.to_range(files, ASSIGN_SEED + r,
                                       n_buckets).numpy()
                     for r in range(n_rep)])


def build_words(g: hashes64.Geometry, n_files: int, n_buckets: int,
                n_rep: int, genomes, device, *, chunk: int = 1 << 21,
                skip_last_kmer: bool = False) -> torch.Tensor:
    """The ``(R·B, m/32)`` int32 words that indexing every kmer of every
    genome (file ``i`` = ``genomes[i]``) sets. ``skip_last_kmer`` leaves
    each file's last kmer out: the control that breaks "every kmer
    indexed"."""
    words = torch.zeros((n_rep * n_buckets, g.m // 32), dtype=torch.int32,
                        device=device)
    flat = words.view(-1)
    assign = torch.as_tensor(assignment(n_files, n_buckets, n_rep),
                             device=device)
    reps = torch.arange(n_rep, device=device)[:, None] * n_buckets
    codes, kfid, ends = ref_index.kmer_file_ids(genomes, g.k, device)
    if skip_last_kmer:
        kfid[ends - g.k] = -1
    n_starts = kfid.numel()
    for p0 in range(0, n_starts, chunk):
        p1 = min(p0 + chunk, n_starts)
        locs = hashes64.locations(g, codes[p0:p1 + g.k - 1])   # (η, n)
        f = kfid[p0:p1]
        keep = f >= 0
        filters = reps + assign[:, f[keep]]                        # (R, n)
        keys = filters[:, None] * g.m + locs[:, keep][None]        # (R, η, n)
        ref_index.or_bits(flat, keys.reshape(-1))
    return words


def kmer_hits(g: hashes64.Geometry, words: torch.Tensor,
              assign: torch.Tensor, reads: torch.Tensor) -> torch.Tensor:
    """``(N, S, n_kmers)`` bool: the kmer hits the file, for ``(S, n)``
    reads: the AND over η of each filter's bit, then over the R filters of
    the file's buckets."""
    locs = hashes64.locations(g, reads)                 # (S, η, n_k)
    rows, shift = locs >> 5, (locs & 31).to(torch.int32)
    bits = words[:, rows[:, 0]] >> shift[:, 0]          # (R·B, S, n_k)
    for j in range(1, g.eta):
        bits &= words[:, rows[:, j]] >> shift[:, j]
    grid = (bits & 1).bool().view((len(assign), -1) + bits.shape[1:])
    hit = grid[0, assign[0]]
    for r in range(1, len(assign)):
        hit &= grid[r, assign[r]]
    return hit


def verdicts(g: hashes64.Geometry, words: torch.Tensor, reads, theta: float,
             n_files: int, n_buckets: int, n_rep: int, *, slack: int = 0,
             block: int = 256) -> np.ndarray:
    """``(S, n_files)`` bool: which files each read (a list of uint8
    arrays, any lengths >= k) matches at coverage ``theta``, ``block``
    reads at a time. ``slack`` lowers every read's hit threshold: the
    control that breaks θ."""
    out = np.zeros((len(reads), n_files), dtype=bool)
    assign = torch.as_tensor(assignment(n_files, n_buckets, n_rep),
                             device=words.device)
    by_len: dict = {}
    for i, r in enumerate(reads):
        by_len.setdefault(len(r), []).append(i)
    for n, idx in by_len.items():
        need = ref_index.coverage_need(theta, n - g.k + 1) - slack
        for b0 in range(0, len(idx), block):
            sel = idx[b0:b0 + block]
            batch = torch.as_tensor(np.stack([reads[i] for i in sel]),
                                    device=words.device)
            hits = kmer_hits(g, words, assign, batch).sum(dim=2)  # (N, S)
            out[sel] = (hits >= need).T.cpu().numpy()
    return out
