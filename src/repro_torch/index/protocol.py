"""The ``GeneIndex`` protocol: one index API for every engine.

Port of :mod:`repro.index.protocol`. Every engine of
:mod:`repro_torch.index.engines` (flat Bloom filter, COBS, RAMBO, the
bit-sliced serving index) is a thin view over an
:class:`~repro_torch.index.state.IndexState` and speaks the same methods:

* ``build(cfg, ...)``                 — classmethod constructor;
* ``insert_batch(reads, file_ids)``   — index a ``(B, read_len)`` batch
  through the shared ingest layer, in place (the input value is marked
  consumed); ``file_ids`` is ignored by the single-set flat filter;
* ``query_batch(reads, backend=...)`` — per-kmer membership for a batch,
  through the shared query layer;
* ``msmt(reads, theta)``              — Multiple-Set Membership Testing
  (the paper's Definition 3): per-file kmer coverage >= ``theta``;
* ``state`` / ``with_state(state)``   — the storage behind the view, and
  a view of the same kind over another state.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Optional, Protocol, runtime_checkable

import torch

if TYPE_CHECKING:  # pragma: no cover - typing only
    from repro_torch.index.state import IndexState


@runtime_checkable
class GeneIndex(Protocol):
    """Structural protocol shared by all index engines."""

    scheme: str

    @property
    def state(self) -> "IndexState":
        """The storage behind this view."""
        ...

    def with_state(self, state: "IndexState") -> "GeneIndex":
        """Rebuild an engine view of the same kind over ``state``."""
        ...

    def insert_batch(self, reads, file_ids: Optional[object] = None
                     ) -> "GeneIndex":
        """Index a batch of reads; returns the updated index."""
        ...

    def query_batch(self, reads, *, backend: str = "idl_probe"
                    ) -> torch.Tensor:
        """Per-kmer membership for a batch of reads."""
        ...

    def msmt(self, reads, theta: float = 1.0) -> torch.Tensor:
        """Per-file match verdicts at kmer-coverage threshold ``theta``."""
        ...
