"""The flat Bloom filter (``PackedBloomIndex``, one partitioned filter of
``m`` bits on the 64-bit hash path): how the benchmark drives the
program's engine, and the reference and yardstick of the same deployment.

The filter holds one set, every file of the archive, and answers as an
index of one file: the service's ``matches`` is a ``(1,)`` row, and
:func:`reference_verdicts` gives ``(len(reads), 1)``. Each row of the
adapter table in ``bench/README.md``:

- ``new_index``: ``PackedBloomIndex.build(cfg, scheme, device)``, after
  :func:`check_program` (a program that cannot address the configured
  filter, or does not answer as one file, is refused before the build);
- ``build``: the program's archive builder (the ``"bits"`` insert plan);
- ``output_words``: the ``(m/32,)`` int32 words;
- ``reference_words`` / ``reference_verdicts``: ``reference/bloom.py``;
- ``probe_bytes_each``: each batch's distinct 32-byte sectors of the
  words (``counts.sector_bytes`` of the words ``locs >> 5``, counted on
  the device), and its ``(B, n_kmers)`` int32 answers written once;
- ``insert_bytes``: each sector a bit lands in, read and written once;
- ``insert_batches``: ``counts.build_batches``.

Configuration keys read here: ``m``, ``k``, ``t``, ``L``, ``eta``,
``scheme``, ``minhash_mode``, ``align``; the loops read ``build``.
"""

from __future__ import annotations

import numpy as np
import torch

from harness import counts
from reference import bloom as ref_bloom

WORDS_PER_SECTOR = counts.SECTOR // 4


def geometry(config: dict) -> ref_bloom.Geometry:
    return ref_bloom.Geometry(
        k=config["k"], t=config["t"], L=config["L"], eta=config["eta"],
        m=config["m"], scheme=config["scheme"],
        minhash_mode=config["minhash_mode"], align=config["align"])


# -- the program ------------------------------------------------------------

def program_config(config: dict):
    from repro_torch.core import idl

    return idl.IDLConfig(k=config["k"], t=config["t"], L=config["L"],
                         eta=config["eta"], m=config["m"],
                         minhash_mode=config["minhash_mode"],
                         align=config["align"])


def check_program(config: dict) -> None:
    """Raise unless the program hashes a read to the reference's bit
    locations at the configured ``m`` (a program whose locations wrap
    mod 2**32 addresses an eighth of a 2**35-bit filter) and its flat
    filter answers as an index of one file, ``(B, 1)``: both on the CPU,
    on one read."""
    from repro_torch.core import idl
    from repro_torch.index import engines, registry

    cfg, scheme = program_config(config), config["scheme"]
    codes = torch.as_tensor(np.arange(3 * config["k"]) * 7 % 4,
                            dtype=torch.uint8)[None]
    got = registry.locations(cfg, codes, scheme)
    if not torch.equal(got, ref_bloom.locations(geometry(config), codes)):
        raise RuntimeError(
            f"the program's bit locations at m={config['m']} are not the "
            f"reference's (largest {int(got.max())}): it cannot address "
            f"this filter")
    small = idl.IDLConfig(k=cfg.k, t=cfg.t, L=64, eta=cfg.eta, m=1 << 12,
                          minhash_mode=cfg.minhash_mode, align=cfg.align)
    shape = tuple(engines.PackedBloomIndex.build(small, scheme, device="cpu")
                  .coverage_batch(codes).shape)
    if shape != (1, 1):
        raise RuntimeError(f"the program's flat filter answers {shape} for "
                           f"one read, not (1, 1): one file's column")


def new_index(config: dict, device):
    """An empty index on ``device``."""
    from repro_torch.index import engines

    check_program(config)
    return engines.PackedBloomIndex.build(program_config(config),
                                          config["scheme"], device=device)


def build(index, genomes: list, read_bases: int, chunk_reads: int):
    """The whole archive streamed into ``index`` through the program's
    archive builder (every file into the one set); returns the updated
    index."""
    from repro_torch.index import ingest

    return ingest.build_archive(index, list(enumerate(genomes)),
                                read_len=read_bases, chunk_reads=chunk_reads)


def output_words(index) -> torch.Tensor:
    """The ``(m/32,)`` words a build wrote."""
    return index.words


# -- the reference and the yardstick ----------------------------------------

def reference_words(config: dict, genomes: list, device, *,
                    skip_last_kmer: bool = False) -> torch.Tensor:
    return ref_bloom.build_words(geometry(config), genomes, device,
                                 skip_last_kmer=skip_last_kmer)


def reference_verdicts(config: dict, words: torch.Tensor, reads: list,
                       theta: float, *, slack: int = 0) -> np.ndarray:
    return ref_bloom.verdicts(geometry(config), words, reads, theta,
                              slack=slack)


def probe_bytes_each(config: dict, batches: np.ndarray, device,
                     chunk: int = 32) -> list:
    """Least bytes of the bit probe of each ``(B, n)`` read batch of
    ``batches``, ``chunk`` batches to a call: each distinct 32-byte sector
    of the words that the batch's locations name, read once (what
    ``counts.sector_bytes`` gives for the words ``locs >> 5``, counted on
    the device), and the ``(B, n_kmers)`` int32 {0, 1} answers
    ``probe_planned_bits`` writes, once. The locations are not counted."""
    g = geometry(config)
    n_b, b, n = batches.shape
    n_sectors = g.m // 32 // WORDS_PER_SECTOR
    out_bytes = 4 * b * (n - g.k + 1)
    sizes = []
    for c0 in range(0, n_b, chunk):
        part = torch.as_tensor(batches[c0:c0 + chunk], device=device)
        c = part.shape[0]
        locs = ref_bloom.locations(g, part.reshape(c * b, n)).reshape(c, -1)
        keys = torch.unique((locs >> 5) // WORDS_PER_SECTOR + n_sectors
                            * torch.arange(c, device=device)[:, None])
        sectors = torch.bincount(keys // n_sectors, minlength=c)
        sizes += [counts.SECTOR * s + out_bytes for s in sectors.tolist()]
    return sizes


def insert_bytes(config: dict, reads: np.ndarray, file_ids: np.ndarray,
                 device) -> int:
    """Least bytes of one insert of a ``(B, n)`` read batch (``file_ids``
    unused: one set): each 32-byte sector of the words that a bit lands
    in, read and written once."""
    locs = ref_bloom.locations(geometry(config),
                               torch.as_tensor(reads, device=device))
    sectors = torch.unique((locs >> 5) // WORDS_PER_SECTOR)
    return 2 * counts.SECTOR * int(sectors.numel())


def insert_batches(config: dict, genomes: list, read_bases: int,
                   chunk_reads: int) -> list:
    return counts.build_batches(genomes, read_bases, config["k"],
                                chunk_reads)
