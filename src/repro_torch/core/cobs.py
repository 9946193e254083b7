"""COBS, the Compact Bit-sliced Signature index (Bingmann et al.), with IDL.

Port of :mod:`repro.core.cobs`. Layout (BIGSI/COBS): a bit matrix whose
rows are hash locations and whose columns are files; a kmer's query ANDs
η rows into a membership slice over every file at once. Files are grouped
by size and each group gets its own row count m_g. IDL-COBS is the same
structure with IDL locations (the paper's §5.2).

:class:`Cobs` is a deprecated thin adapter over
:class:`repro_torch.index.CobsIndex` that keeps the seed's single-sequence
call signatures; new code uses the engine directly.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Sequence

import torch

from repro_torch.core import idl as idl_mod
from repro_torch.index import engines


@dataclasses.dataclass
class Cobs:
    """Deprecated adapter: size-grouped bit-sliced filters over N files."""

    index: engines.CobsIndex

    @classmethod
    def build(cls, file_sizes: Sequence[int], base_cfg: idl_mod.IDLConfig,
              scheme: str = "idl", bits_per_kmer: float = 10.0,
              n_groups: int = 2, device="cuda") -> "Cobs":
        """Group files by kmer count; m_g sized from the group's largest
        file (see :meth:`CobsIndex.build`)."""
        warnings.warn(
            "core.cobs.Cobs is a deprecated adapter; build a "
            "repro_torch.index.CobsIndex instead (batched planned inserts "
            "and queries).", DeprecationWarning, stacklevel=2)
        return cls(index=engines.CobsIndex.build(
            file_sizes, base_cfg, scheme=scheme, bits_per_kmer=bits_per_kmer,
            n_groups=n_groups, device=device))

    @property
    def groups(self):
        return self.index.groups

    @property
    def n_files(self) -> int:
        return self.index.n_files

    @property
    def k(self) -> int:
        return self.index.k

    def insert_sequence(self, file_id: int, codes) -> "Cobs":
        """A new adapter with ``codes`` indexed under ``file_id``; this one
        keeps its words (the insert goes into a copy)."""
        return dataclasses.replace(self, index=self.index.insert_batch(
            codes, [file_id], donate=False))

    def query_sequence(self, codes) -> torch.Tensor:
        """MSMT kmer slice: (n_kmers, N) bool across all files
        (Definition 3)."""
        return self.index.query_batch(codes)[0]

    def msmt(self, codes, theta: float = 1.0) -> torch.Tensor:
        """Per-file match: share of query kmers present >= theta (1.0 is
        Definition 2, every kmer present)."""
        return self.index.msmt(codes, theta=theta)[0]

    @property
    def total_bits(self) -> int:
        return self.index.total_bits
