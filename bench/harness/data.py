"""The benchmark's inputs, made from ``--seed``: the archive of synthetic
genomes and the query reads (sampled from indexed files, or 1-poisoned).

Every seed gets the same sizes in another order: the file lengths are
the log-uniform distribution's quantiles, permuted, and each batch holds
the same number of positive and poisoned reads. So a seed changes the
content of the work and never its amount.
"""

from __future__ import annotations

import numpy as np
import torch


def synthesize_genome(length: int, rng: np.random.Generator,
                      repeat_fraction: float, repeat_unit: int
                      ) -> np.ndarray:
    """Random uint8 codes in {0..3} with ``repeat_fraction`` of the bases
    tiled from a library of eight ``repeat_unit``-base repeats, so kmer
    multiplicities resemble a real genome's."""
    out = rng.integers(0, 4, size=length, dtype=np.uint8)
    n_repeat = int(length * repeat_fraction)
    if n_repeat and length > repeat_unit * 2:
        library = rng.integers(0, 4, size=(8, repeat_unit), dtype=np.uint8)
        n_units = -(-n_repeat // repeat_unit)
        which = rng.integers(0, 8, size=n_units)
        starts = rng.integers(0, length - repeat_unit, size=n_units)
        for u, s in zip(which, starts):
            out[s:s + repeat_unit] = library[u]
    return out


def file_lengths(n_files: int, lo: int, hi: int,
                 rng: np.random.Generator) -> np.ndarray:
    """``n_files`` lengths log-uniform in ``[lo, hi]`` bases: the
    distribution's quantiles at ``(i + 0.5) / n``, in a seeded order."""
    q = (np.arange(n_files) + 0.5) / n_files
    lens = np.exp(np.log(lo) + q * (np.log(hi) - np.log(lo)))
    return rng.permutation(lens.astype(np.int64))


def archive(config: dict, seed: int) -> list:
    """The configuration's archive: ``n_files`` genomes (file ``i`` is
    element ``i``), lengths from ``file_bases``."""
    rng = np.random.default_rng([seed, 0])
    lo, hi = config["file_bases"]
    lens = file_lengths(config["n_files"], lo, hi, rng)
    return [synthesize_genome(int(n), np.random.default_rng([seed, 1, fid]),
                              config["repeat_fraction"],
                              config["repeat_unit"])
            for fid, n in enumerate(lens)]


def read_pool(genomes: list, n_batches: int, batch_reads: int,
              read_bases: int, positive_share: float, n_flips: int,
              seed: int, device, chunk: int = 1 << 16) -> tuple:
    """``(reads, sources)`` on the host: ``(n_batches, batch_reads,
    read_bases)`` uint8 reads, each cut from a uniformly chosen file at a
    uniform offset, and ``(n_batches, batch_reads)`` their files. Every
    batch holds ``round(positive_share * batch_reads)`` reads as cut and
    the rest poisoned (``sources`` -1), in a seeded order. Made on
    ``device`` from ``seed``, ``chunk`` batches a call."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(np.random.SeedSequence([seed, 2]).generate_state(
        1, np.uint64)[0]))
    codes = torch.as_tensor(np.concatenate(genomes), device=device)
    lens = torch.as_tensor([len(g) for g in genomes], device=device)
    first = torch.cumsum(lens, 0) - lens
    n_pos = int(round(batch_reads * positive_share))
    span = torch.arange(read_bases, device=device)
    reads = np.empty((n_batches, batch_reads, read_bases), dtype=np.uint8)
    sources = np.empty((n_batches, batch_reads), dtype=np.int64)
    per = max(chunk // batch_reads, 1)
    for b0 in range(0, n_batches, per):
        shape = (min(per, n_batches - b0), batch_reads)
        fids = torch.randint(0, len(genomes), shape, generator=gen,
                             device=device)
        starts = (torch.rand(shape, generator=gen, device=device)
                  * (lens[fids] - read_bases + 1)).long()
        got = codes[(first[fids] + starts)[..., None] + span]
        order = torch.rand(shape, generator=gen, device=device).argsort(-1)
        poisoned = torch.ones(shape, dtype=torch.bool, device=device)
        poisoned.scatter_(-1, order[..., :n_pos], False)
        for _ in range(n_flips):
            pos = torch.randint(0, read_bases, shape + (1,), generator=gen,
                                device=device)
            delta = torch.randint(1, 4, shape + (1,), generator=gen,
                                  device=device, dtype=torch.uint8)
            old = got.gather(-1, pos)
            new = torch.where(poisoned[..., None], (old + delta) % 4, old)
            got.scatter_(-1, pos, new)
        reads[b0:b0 + shape[0]] = got.cpu().numpy()
        sources[b0:b0 + shape[0]] = torch.where(poisoned, -1, fids).cpu(
            ).numpy()
    return reads, sources
