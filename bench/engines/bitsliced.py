"""The bit-sliced index (``BitSlicedIndex``, the 32-bit lane path): how the
benchmark drives the program's engine, and the reference and yardstick
of the same deployment.

Configuration keys read here: ``n_files``, ``m``, ``k``, ``t``, ``L``,
``eta``, ``scheme``, ``minhash_mode``, ``align``.
"""

from __future__ import annotations

import numpy as np
import torch

from harness import counts
from reference import hashes
from reference import index as ref_index


def geometry(config: dict) -> hashes.Geometry:
    return hashes.Geometry(
        k=config["k"], t=config["t"], L=config["L"], eta=config["eta"],
        m=config["m"], scheme=config["scheme"],
        minhash_mode=config["minhash_mode"], align=config["align"])


def row_words(config: dict) -> int:
    return ref_index.word_count(config["n_files"])


# -- the program ------------------------------------------------------------

def new_index(config: dict, device):
    """An empty index on ``device``."""
    from repro_torch.core import idl
    from repro_torch.index import engines

    cfg = idl.IDLConfig(k=config["k"], t=config["t"], L=config["L"],
                        eta=config["eta"], m=config["m"],
                        minhash_mode=config["minhash_mode"],
                        align=config["align"])
    return engines.BitSlicedIndex.build(cfg, config["scheme"],
                                        n_files=config["n_files"],
                                        device=device)


def build(index, genomes: list, read_bases: int, chunk_reads: int):
    """The whole archive streamed into ``index`` through the program's
    archive builder; returns the updated index."""
    from repro_torch.index import ingest

    return ingest.build_archive(index, list(enumerate(genomes)),
                                read_len=read_bases, chunk_reads=chunk_reads)


def output_words(index) -> torch.Tensor:
    """The index words a build wrote."""
    return index.words


# -- the reference and the yardstick ----------------------------------------

def reference_words(config: dict, genomes: list, device, *,
                    skip_last_kmer: bool = False) -> torch.Tensor:
    return ref_index.build_words(geometry(config), config["n_files"],
                                 genomes, device,
                                 skip_last_kmer=skip_last_kmer)


def reference_verdicts(config: dict, words: torch.Tensor, reads: list,
                       theta: float, *, slack: int = 0) -> np.ndarray:
    return ref_index.verdicts(geometry(config), words, reads, theta,
                              config["n_files"], slack=slack)


def probe_bytes_each(config: dict, batches: np.ndarray, device) -> list:
    return counts.probe_bytes_each(geometry(config), row_words(config),
                                   batches, device)


def insert_bytes(config: dict, reads: np.ndarray, file_ids: np.ndarray,
                 device) -> int:
    return counts.insert_bytes(geometry(config), row_words(config), reads,
                               file_ids, device)


def insert_batches(config: dict, genomes: list, read_bases: int,
                   chunk_reads: int) -> list:
    return counts.build_batches(genomes, read_bases, config["k"],
                                chunk_reads)

