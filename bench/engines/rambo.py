"""RAMBO (``RamboIndex``, B buckets × R repetitions of bucket filters on the
64-bit hash path): how the benchmark drives the program's engine, and the
reference and yardstick of the same deployment.

Configuration keys read here: ``n_files``, ``n_buckets``, ``n_rep``, ``m``
(the bits of one bucket filter), ``k``, ``t``, ``L``, ``eta``,
``scheme``, ``minhash_mode``, ``align``; the loops read ``build``.
"""

from __future__ import annotations

import numpy as np
import torch

from harness import counts
from reference import hashes64
from reference import rambo as ref_rambo


def geometry(config: dict) -> hashes64.Geometry:
    return hashes64.Geometry(
        k=config["k"], t=config["t"], L=config["L"], eta=config["eta"],
        m=config["m"], scheme=config["scheme"],
        minhash_mode=config["minhash_mode"], align=config["align"])


def n_filters(config: dict) -> int:
    """R·B: the words of one row of the transposed ``(m/32, R·B)`` copy
    that the query probes."""
    return config["n_rep"] * config["n_buckets"]


# -- the program ------------------------------------------------------------

def new_index(config: dict, device):
    """An empty index on ``device``."""
    from repro_torch.core import idl
    from repro_torch.index import engines

    cfg = idl.IDLConfig(k=config["k"], t=config["t"], L=config["L"],
                        eta=config["eta"], m=config["m"],
                        minhash_mode=config["minhash_mode"],
                        align=config["align"])
    return engines.RamboIndex.build(config["n_files"], cfg, config["scheme"],
                                    B=config["n_buckets"], R=config["n_rep"],
                                    device=device)


def build(index, genomes: list, read_bases: int, chunk_reads: int):
    """The whole archive streamed into ``index`` through the program's
    archive builder; returns the updated index."""
    from repro_torch.index import ingest

    return ingest.build_archive(index, list(enumerate(genomes)),
                                read_len=read_bases, chunk_reads=chunk_reads)


def output_words(index) -> torch.Tensor:
    """The ``(R·B, m/32)`` words a build wrote."""
    return index.words


# -- the reference and the yardstick ----------------------------------------

def reference_words(config: dict, genomes: list, device, *,
                    skip_last_kmer: bool = False) -> torch.Tensor:
    return ref_rambo.build_words(geometry(config), config["n_files"],
                                 config["n_buckets"], config["n_rep"],
                                 genomes, device,
                                 skip_last_kmer=skip_last_kmer)


def reference_verdicts(config: dict, words: torch.Tensor, reads: list,
                       theta: float, *, slack: int = 0) -> np.ndarray:
    return ref_rambo.verdicts(geometry(config), words, reads, theta,
                              config["n_files"], config["n_buckets"],
                              config["n_rep"], slack=slack)


def probe_bytes_each(config: dict, batches: np.ndarray, device,
                     chunk: int = 32) -> list:
    """Least bytes of the bit probe of each ``(B, n)`` read batch of
    ``batches``, ``chunk`` batches to a call: each distinct row of the
    transposed ``(m/32, R·B)`` words the batch reads once (R·B int32
    words), and the ``(B, n_kmers, R·B)`` int32 {0, 1} answers the gather's
    bit mode writes, once. Where rows fill whole sectors, a batch's rows
    are only counted."""
    g, rb = geometry(config), n_filters(config)
    whole = rb % (counts.SECTOR // 4) == 0
    n_b, b, n = batches.shape
    n_rows = g.m // 32
    out_bytes = 4 * b * (n - g.k + 1) * rb
    sizes = []
    for c0 in range(0, n_b, chunk):
        part = torch.as_tensor(batches[c0:c0 + chunk], device=device)
        c = part.shape[0]
        locs = hashes64.locations(g, part.reshape(c * b, n)).reshape(c, -1)
        keys = torch.unique((locs >> 5) + n_rows * torch.arange(
            c, device=device)[:, None])
        if whole:
            rows = torch.bincount(keys // n_rows, minlength=c).cpu().tolist()
            sizes += [4 * r * rb + out_bytes for r in rows]
            continue
        keys = keys.cpu().numpy()
        per_batch = np.split(keys, np.searchsorted(keys,
                                                   n_rows * np.arange(1, c)))
        sizes += [counts.sector_bytes((rows - i * n_rows) * rb, rb)
                  + out_bytes for i, rows in enumerate(per_batch)]
    return sizes


def insert_bytes(config: dict, reads: np.ndarray, file_ids: np.ndarray,
                 device) -> int:
    """Least bytes of one insert of a ``(B, n)`` read batch into its files'
    R bucket filters: each 32-byte sector of the ``(R·B, m/32)`` words that
    a bit lands in, read and written once."""
    g = geometry(config)
    locs = hashes64.locations(g, torch.as_tensor(reads, device=device))
    assign = torch.as_tensor(ref_rambo.assignment(
        config["n_files"], config["n_buckets"], config["n_rep"]),
        device=device)
    fid = torch.as_tensor(file_ids, dtype=torch.int64, device=device)
    reps = torch.arange(config["n_rep"], device=device) * config["n_buckets"]
    filters = assign[:, fid].T + reps                          # (B, R)
    # (B, R, η, n_k) word indices
    words = filters[:, :, None, None] * (g.m // 32) + (locs >> 5)[:, None]
    sectors = torch.unique(words // (counts.SECTOR // 4))
    return 2 * counts.SECTOR * int(sectors.numel())


def insert_batches(config: dict, genomes: list, read_bases: int,
                   chunk_reads: int) -> list:
    return counts.build_batches(genomes, read_bases, config["k"],
                                chunk_reads)
