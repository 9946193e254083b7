"""The bit-sliced serving engine.

Port of :class:`repro.index.engines.BitSlicedIndex`: one bit-sliced
``(m, ⌈F/32⌉)`` int32 matrix over the 32-bit lane path. Inserts go through
:mod:`repro_torch.index.ingest` (default backend ``"idl_insert"``), queries
through :mod:`repro_torch.index.query` (default backend ``"idl_probe"``).
The other engines of the reference (flat BF, COBS, RAMBO) are not ported
yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import idl as idl_mod
from repro_torch.index import ingest, packed, query
from repro_torch.index import state as state_mod


def _as_file_ids(file_ids, batch: int, n_files: int) -> np.ndarray:
    if file_ids is None:
        raise ValueError("this engine requires file_ids for insert_batch")
    if isinstance(file_ids, torch.Tensor):
        file_ids = file_ids.cpu().numpy()
    arr = np.atleast_1d(np.asarray(file_ids, dtype=np.int64))
    if arr.shape != (batch,):
        raise ValueError(f"file_ids shape {arr.shape} != batch ({batch},)")
    # a file id past the last word column would address the next row's
    # words (or memory past the matrix), so it is refused here
    if arr.min() < 0 or arr.max() >= n_files:
        raise ValueError(f"file ids must lie in [0, {n_files}), got "
                         f"[{arr.min()}, {arr.max()}]")
    return arr


@dataclasses.dataclass(frozen=True)
class BitSlicedIndex:
    """One bit-sliced (m, F/32) int32 matrix on the 32-bit lane path."""

    cfg: idl_mod.IDLConfig
    scheme: str
    n_files: int
    words: torch.Tensor      # (m, ceil(n_files/32)) int32

    @classmethod
    def build(cls, cfg: idl_mod.IDLConfig, scheme: str = "idl",
              n_files: int = 1024, device="cuda") -> "BitSlicedIndex":
        w = -(-n_files // 32)
        return cls(cfg=cfg, scheme=scheme, n_files=n_files,
                   words=torch.zeros((cfg.m, w), dtype=torch.int32,
                                     device=device))

    @property
    def state(self) -> state_mod.IndexState:
        return state_mod.from_engine(self)

    def insert_batch(self, reads, file_ids=None, *,
                     backend: str = "idl_insert",
                     donate: bool = True) -> "BitSlicedIndex":
        """Index reads into their file columns, in place; returns the
        updated view and marks this one consumed (unless ``donate=False``,
        which inserts into a copy)."""
        state_mod.ensure_live(self, what="engine")
        reads = query.as_reads(reads, self.words.device)
        fids = _as_file_ids(file_ids, reads.shape[0], self.n_files)
        plan = ingest.plan_insert(
            self.cfg, self.scheme, tuple(reads.shape), tuple(self.words.shape),
            kind="cols", lane32=True, device=self.words.device,
        )
        words = plan.execute(self.words, reads, fids, backend=backend,
                             donate=donate)
        if donate:
            state_mod.mark_consumed(self)
        return dataclasses.replace(self, words=words)

    def query_batch(self, reads, *, backend: str = "idl_probe"
                    ) -> torch.Tensor:
        """(B, n_kmers, F/32) int32 per-kmer file masks (packed)."""
        state_mod.ensure_live(self, what="engine")
        reads = query.as_reads(reads, self.words.device)
        plan = query.plan_query(
            self.cfg, self.scheme, tuple(reads.shape), tuple(self.words.shape),
            bit_probe=False, lane32=True, device=self.words.device,
        )
        return plan.execute(self.words, reads, backend=backend)

    def msmt(self, reads, theta: float = 1.0, **kw) -> torch.Tensor:
        """(B, n_files) bool — the serve-layout MSMT (one theta rule)."""
        per_kmer = self.query_batch(reads, **kw)          # (B, n_k, W)
        mask = query.file_match_mask(per_kmer, theta)     # (B, W)
        return packed.unpack_file_bits(mask, self.n_files)
