"""Synthetic genome generation + FASTA/FASTQ-ish IO + query poisoning.

The paper evaluates on ENA FASTQ files (offline here), so the data substrate
provides: (a) reproducible synthetic genomes with realistic repeat structure,
(b) read extraction (fixed-length fragments, the unit the paper indexes),
(c) the paper's 1-poisoning query generator ("for each sequence ... sample a
subsequence of length > 31 and poison it by changing one character at a
random location" — §7), and (d) minimal FASTA read/write so examples can
round-trip real files when present.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from repro_torch.core import kmers

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def synthesize_genome(
    length: int,
    seed: int = 0,
    repeat_fraction: float = 0.3,
    repeat_unit: int = 500,
) -> np.ndarray:
    """Random genome codes with planted repeats (uint8 in {0..3}).

    Real genomes are highly repetitive; ``repeat_fraction`` of the output is
    tiled from a small library of repeat units so kmer-multiplicity and BF
    fill statistics resemble real data rather than iid noise.
    """
    rng = np.random.default_rng(seed)
    out = rng.integers(0, 4, size=length, dtype=np.uint8)
    n_repeat = int(length * repeat_fraction)
    if n_repeat and length > repeat_unit * 2:
        library = [
            rng.integers(0, 4, size=repeat_unit, dtype=np.uint8) for _ in range(8)
        ]
        placed = 0
        while placed < n_repeat:
            unit = library[rng.integers(0, len(library))]
            start = int(rng.integers(0, length - repeat_unit))
            out[start : start + repeat_unit] = unit
            placed += repeat_unit
    return out


def extract_reads(
    genome: np.ndarray, read_len: int, n_reads: int, seed: int = 1
) -> np.ndarray:
    """(n_reads, read_len) uint8 fragments sampled uniformly (with overlap)."""
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, len(genome) - read_len + 1, size=n_reads)
    return np.stack([genome[s : s + read_len] for s in starts])


def window_reads(codes: np.ndarray, read_len: int, k: int) -> np.ndarray:
    """Fixed-length windows of ``codes`` covering every kmer exactly.

    Consecutive windows overlap by ``k - 1`` bases so no boundary kmer is
    lost; the final window is re-anchored to the sequence end (the extra
    overlap re-inserts kmers, which is free — scatter-OR is idempotent).
    Sequences shorter than ``read_len`` come back as one window of their
    own length; sequences shorter than ``k`` (no kmers) as an empty batch.
    This is the chunking unit of the streaming archive builder
    (:func:`repro_torch.index.ingest.build_archive`).
    """
    codes = np.asarray(codes)
    if read_len < k:
        raise ValueError(
            f"read_len={read_len} must be >= k={k} (a window must hold at "
            "least one kmer)")
    n = len(codes)
    if n < k:
        return np.empty((0, n), dtype=codes.dtype)
    if n <= read_len:
        return codes[None, :]
    stride = read_len - (k - 1)
    starts = list(range(0, n - read_len + 1, stride))
    if starts[-1] != n - read_len:
        starts.append(n - read_len)
    return np.stack([codes[s : s + read_len] for s in starts])


def poison_queries(
    reads: np.ndarray, seed: int = 2, n_flips: int = 1
) -> np.ndarray:
    """The paper's 1-poisoning attack: flip ``n_flips`` random bases per read.

    Each query then maximally resembles an inserted sequence while (whp) not
    being a member — the hard negative for FPR measurement.
    """
    rng = np.random.default_rng(seed)
    out = reads.copy()
    n, length = out.shape
    for _ in range(n_flips):
        pos = rng.integers(0, length, size=n)
        delta = rng.integers(1, 4, size=n).astype(np.uint8)  # guaranteed change
        out[np.arange(n), pos] = (out[np.arange(n), pos] + delta) % 4
    return out


@dataclasses.dataclass
class GenomeFile:
    """One 'file' of the archive: a genome plus its reads."""

    file_id: int
    genome: np.ndarray

    def reads(self, read_len: int, n_reads: int) -> np.ndarray:
        return extract_reads(self.genome, read_len, n_reads, seed=100 + self.file_id)

    @property
    def n_kmers(self) -> int:
        return len(self.genome) - 31 + 1


def synth_archive(
    n_files: int, genome_len: int, seed: int = 0
) -> list[GenomeFile]:
    """An archive of distinct genomes (distinct seeds => ~disjoint kmer sets)."""
    return [
        GenomeFile(file_id=i, genome=synthesize_genome(genome_len, seed=seed + 31 * i))
        for i in range(n_files)
    ]


# --------------------------------------------------------------------------
# FASTA round-trip (examples can consume real files when available)
# --------------------------------------------------------------------------

def write_fasta(path: str, records: dict[str, np.ndarray]) -> None:
    with open(path, "w") as f:
        for name, codes in records.items():
            f.write(f">{name}\n")
            s = kmers.decode_bases(codes)
            for i in range(0, len(s), 80):
                f.write(s[i : i + 80] + "\n")


def read_fasta(path: str) -> dict[str, np.ndarray]:
    records: dict[str, list[str]] = {}
    name = None
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith(">"):
                name = line[1:].split()[0]
                records[name] = []
            elif name is not None:
                records[name].append(line)
    return {
        n: kmers.encode_bases("".join(parts)) for n, parts in records.items()
    }
