"""The bit-sliced index's semantics in plain PyTorch: every kmer of file
``f`` ORs bit ``f`` into the η rows its locations name (the ``(m, W)``
int32 matrix, file ``f`` at bit ``f % 32`` of word ``f // 32``), and a
read matches file ``f`` when at least ``ceil(θ · n_kmers)`` of its kmers
find bit ``f`` set in all η of their rows."""

from __future__ import annotations

import math

import numpy as np
import torch

from reference import hashes


def word_count(n_files: int) -> int:
    return -(-n_files // 32)


def coverage_need(theta: float, n_kmers: int) -> int:
    """Hits a read of ``n_kmers`` kmers needs for coverage ``theta``."""
    return int(math.ceil(theta * n_kmers - 1e-9))


def _as_int32(v: torch.Tensor) -> torch.Tensor:
    return torch.where(v >= (1 << 31), v - (1 << 32), v).to(torch.int32)


def or_bits(flat: torch.Tensor, keys: torch.Tensor) -> None:
    """OR bit ``key & 31`` of word ``key >> 5`` into the flat int32 words,
    for every key (duplicates allowed)."""
    keys = torch.unique(keys)
    word, bit = keys >> 5, keys & 31
    uw, counts = torch.unique_consecutive(word, return_counts=True)
    # distinct bits of one word: their sum is their OR
    cs = torch.cumsum(torch.ones_like(bit) << bit, 0)
    ends = torch.cumsum(counts, 0) - 1
    seg = cs[ends]
    seg[1:] -= cs[ends[:-1]]
    flat[uw] |= _as_int32(seg)


def kmer_file_ids(genomes, k: int, device) -> tuple:
    """The archive joined end to end, as codes on ``device``; the file id
    of every kmer start (-1 where the kmer crosses into the next file);
    the end of each file in the joined codes."""
    lens = torch.as_tensor([len(g) for g in genomes], device=device)
    codes = torch.as_tensor(np.concatenate(genomes), device=device)
    fid = torch.repeat_interleave(
        torch.arange(len(genomes), device=device), lens)
    n = fid.numel() - k + 1
    kfid = torch.where(fid[:n] == fid[k - 1:], fid[:n], -1)
    return codes, kfid, torch.cumsum(lens, 0)


def build_words(g: hashes.Geometry, n_files: int, genomes, device, *,
                chunk: int = 1 << 22, skip_last_kmer: bool = False
                ) -> torch.Tensor:
    """The ``(m, W)`` int32 words that indexing every kmer of every genome
    (file ``i`` = ``genomes[i]``) sets. ``skip_last_kmer`` leaves each
    file's last kmer out: the control that breaks "every kmer indexed"."""
    w = word_count(n_files)
    words = torch.zeros((g.m, w), dtype=torch.int32, device=device)
    flat = words.view(-1)
    codes, kfid, ends = kmer_file_ids(genomes, g.k, device)
    if skip_last_kmer:
        kfid[ends - g.k] = -1
    n_starts = kfid.numel()
    for p0 in range(0, n_starts, chunk):
        p1 = min(p0 + chunk, n_starts)
        locs = hashes.locations(g, codes[p0:p1 + g.k - 1])   # (η, n)
        f = kfid[p0:p1]
        keep = f >= 0
        keys = locs[:, keep] * (w * 32) + f[keep]
        or_bits(flat, keys.reshape(-1))
    return words


def per_kmer_masks(g: hashes.Geometry, words: torch.Tensor,
                   reads: torch.Tensor) -> torch.Tensor:
    """``(S, n_kmers, W)`` AND over η of the rows each kmer probes."""
    locs = hashes.locations(g, reads)                      # (S, η, n_k)
    rows = words[locs[:, 0]]
    for j in range(1, g.eta):
        rows &= words[locs[:, j]]
    return rows


def verdicts(g: hashes.Geometry, words: torch.Tensor, reads, theta: float,
             n_files: int, *, slack: int = 0, block: int = 256
             ) -> np.ndarray:
    """``(S, n_files)`` bool: which files each read (a list of uint8
    arrays, any lengths >= k) matches at coverage ``theta``. ``slack``
    lowers every read's hit threshold: the control that breaks θ."""
    out = np.zeros((len(reads), n_files), dtype=bool)
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    by_len: dict = {}
    for i, r in enumerate(reads):
        by_len.setdefault(len(r), []).append(i)
    for n, idx in by_len.items():
        need = coverage_need(theta, n - g.k + 1) - slack
        for b0 in range(0, len(idx), block):
            sel = idx[b0:b0 + block]
            batch = torch.as_tensor(np.stack([reads[i] for i in sel]),
                                    device=words.device)
            masks = per_kmer_masks(g, words, batch)
            hits = ((masks[..., None] >> shifts) & 1).sum(dim=1)
            hits = hits.reshape(len(sel), -1)[:, :n_files]
            out[sel] = (hits >= need).cpu().numpy()
    return out
