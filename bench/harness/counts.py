"""The yardstick of the kernels: the least bytes a probe or an insert
batch needs, counted from the reference's own locations, and the card's
published peak they are held against.

Each input byte is counted read once and each output byte written once,
whatever the kernel reads again; the locations are not counted as an
input, so the bound stays the same if a later change fuses their hashing
into the kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from reference import hashes

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (NVIDIA data sheet)
SECTOR = 32                    # bytes: the unit device memory moves


def sector_bytes(first_word, n_words: int) -> int:
    """Bytes of the distinct 32-byte sectors covered by the ``n_words``-word
    spans (int32 words) that start at the word indices ``first_word``: the
    least device memory moves to read, or to write, each of them once."""
    first = np.asarray(first_word, dtype=np.int64).reshape(-1)
    if n_words % 8 == 0 and not (first % 8).any():
        return SECTOR * np.unique(first).size * (n_words // 8)
    spans = first[:, None] + np.arange(n_words)
    return SECTOR * np.unique(spans // 8).size


def probe_bytes(g: hashes.Geometry, row_words: int, reads: np.ndarray,
                device) -> int:
    """Least bytes of one row probe of a ``(B, n)`` read batch: each
    distinct row of the index it reads once (``row_words`` int32 words),
    and the ``(B, n_kmers, row_words)`` per-kmer AND written once."""
    locs = hashes.locations(g, torch.as_tensor(reads, device=device))
    rows = torch.unique(locs).cpu().numpy()
    n_kmers = reads.shape[0] * (reads.shape[1] - g.k + 1)
    return sector_bytes(rows * row_words, row_words) + 4 * n_kmers * row_words


def probe_bytes_each(g: hashes.Geometry, row_words: int,
                     batches: np.ndarray, device, chunk: int = 32) -> list:
    """:func:`probe_bytes` of each ``(B, n)`` batch of ``batches``, ``chunk``
    batches to a call: the distinct rows of each batch counted at once,
    where whole rows fill whole sectors."""
    if row_words % (SECTOR // 4):
        return [probe_bytes(g, row_words, b, device) for b in batches]
    n_b, b, n = batches.shape
    out_bytes = 4 * b * (n - g.k + 1) * row_words
    sizes = []
    for c0 in range(0, n_b, chunk):
        part = torch.as_tensor(batches[c0:c0 + chunk], device=device)
        c = part.shape[0]
        locs = hashes.locations(g, part.reshape(c * b, n)).reshape(c, -1)
        keys = torch.unique(locs + g.m * torch.arange(c, device=device)[:, None])
        rows = torch.bincount(keys // g.m, minlength=c).cpu().tolist()
        sizes += [SECTOR * r * (row_words * 4 // SECTOR) + out_bytes
                  for r in rows]
    return sizes


def insert_bytes(g: hashes.Geometry, row_words: int, reads: np.ndarray,
                 file_ids: np.ndarray, device) -> int:
    """Least bytes of one insert of a ``(B, n)`` read batch into file
    columns: each 32-byte sector that a bit lands in, read and written
    once."""
    locs = hashes.locations(g, torch.as_tensor(reads, device=device))
    fid = torch.as_tensor(file_ids, dtype=torch.int64, device=device)
    words = locs * row_words + (fid // 32)[:, None, None]
    sectors = torch.unique(words // (SECTOR // 4))
    return 2 * SECTOR * int(sectors.numel())


def window_reads(codes: np.ndarray, read_len: int, k: int) -> np.ndarray:
    """Fixed-length windows covering every kmer of ``codes`` once, each
    overlapping the last by ``k - 1`` bases, the last re-anchored to the
    end: how ``build_archive`` cuts a genome into insert reads."""
    n = len(codes)
    if n < k:
        return np.empty((0, n), dtype=codes.dtype)
    if n <= read_len:
        return codes[None, :]
    starts = list(range(0, n - read_len + 1, read_len - (k - 1)))
    if starts[-1] != n - read_len:
        starts.append(n - read_len)
    return np.stack([codes[s:s + read_len] for s in starts])


def window_count(n: int, read_len: int, k: int) -> int:
    """How many windows :func:`window_reads` cuts from ``n`` bases."""
    if n < k:
        return 0
    if n <= read_len:
        return 1
    stride = read_len - (k - 1)
    count = (n - read_len) // stride + 1
    return count + ((n - read_len) % stride != 0)


def build_batches(genomes: list, read_len: int, k: int, chunk: int) -> list:
    """``[(reads, file_ids), ...]``: the insert batches of one archive
    build, ``chunk`` windows each in file order, the last one filled up
    with repeats of its first window (the archive's genomes all hold at
    least ``read_len`` bases, so every window has that length)."""
    reads, fids = [], []
    for fid, codes in enumerate(genomes):
        win = window_reads(codes, read_len, k)
        reads.append(win)
        fids.append(np.full(len(win), fid, dtype=np.int64))
    reads, fids = np.concatenate(reads), np.concatenate(fids)
    out = []
    for b0 in range(0, len(reads), chunk):
        r, f = reads[b0:b0 + chunk], fids[b0:b0 + chunk]
        if len(r) < chunk:
            pad = chunk - len(r)
            r = np.concatenate([r, np.repeat(r[:1], pad, axis=0)])
            f = np.concatenate([f, np.repeat(f[:1], pad)])
        out.append((r, f))
    return out
