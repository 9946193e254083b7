"""RAMBO, Repeated And Merged Bloom filters (Gupta et al.), with IDL.

Port of :mod:`repro.core.rambo`. N files are hashed into B buckets, R times
independently; bucket (r, b) holds one Bloom filter of the union of its
files' kmers. A file is a candidate for a kmer iff its bucket hit in every
repetition. IDL-RAMBO (the paper's §5.2, Table 3) swaps each bucket
filter's hash for IDL locations, all else unchanged.

:class:`Rambo` is a deprecated thin adapter over
:class:`repro_torch.index.RamboIndex` that keeps the seed's uint8
``filters`` field and single-sequence call signatures.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

import numpy as np
import torch

from repro_torch.core import idl as idl_mod
from repro_torch.index import engines, packed


@dataclasses.dataclass
class Rambo:
    """Deprecated adapter over ``repro_torch.index.RamboIndex``. Fresh
    filters are made on ``device``; given ``filters``, the adapter works
    where they live."""

    cfg: idl_mod.IDLConfig                # cfg.m = bits per bucket BF (m_b)
    scheme: str
    n_files: int
    B: int                                # buckets per repetition
    R: int                                # repetitions
    filters: Optional[torch.Tensor] = None     # (R*B, m_b) uint8
    assignment: Optional[np.ndarray] = None    # (R, N) int32 file -> bucket
    device: str = "cuda"

    def __post_init__(self):
        if self.assignment is None:
            self.assignment = engines.rambo_assignment(
                self.n_files, self.B, self.R)
        if self.filters is None:
            self.filters = torch.zeros((self.R * self.B, self.cfg.m),
                                       dtype=torch.uint8, device=self.device)

    @classmethod
    def build(cls, n_files: int, cfg: idl_mod.IDLConfig, scheme: str = "idl",
              B: Optional[int] = None, R: Optional[int] = None,
              device="cuda") -> "Rambo":
        warnings.warn(
            "core.rambo.Rambo is a deprecated adapter; build a "
            "repro_torch.index.RamboIndex instead (packed storage, batched "
            "planned inserts and queries).", DeprecationWarning, stacklevel=2)
        B, R = engines.rambo_dimensions(n_files, B, R)
        return cls(cfg=cfg, scheme=scheme, n_files=n_files, B=B, R=R,
                   device=device)

    def _as_index(self) -> engines.RamboIndex:
        return engines.RamboIndex(
            cfg=self.cfg, scheme=self.scheme, n_files=self.n_files,
            n_buckets=self.B, n_rep=self.R,
            words=packed.pack_rows(self.filters), assignment=self.assignment)

    def insert_sequence(self, file_id: int, codes) -> "Rambo":
        eng = self._as_index().insert_batch(codes, [file_id])
        return dataclasses.replace(
            self, filters=packed.unpack_rows(eng.words, self.cfg.m))

    def query_kmer_grid(self, codes) -> torch.Tensor:
        """(n_kmers, R, B) bool: bucket hits per kmer."""
        return self._as_index().query_grid(codes)[0]

    def msmt(self, codes, theta: float = 1.0) -> torch.Tensor:
        """Candidate files whose kmer coverage >= theta (N-bool)."""
        return self._as_index().msmt(codes, theta=theta)[0]

    @property
    def total_bits(self) -> int:
        return int(self.filters.shape[0]) * int(self.filters.shape[1])
