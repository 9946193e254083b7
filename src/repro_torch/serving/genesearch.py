"""Gene-search serving geometry: the config dataclass and its plan helpers.

Port of the parts of :mod:`repro.serving.genesearch` that are still the
source of truth: :class:`GeneSearchConfig` and the :func:`insert_plan` /
:func:`query_plan` helpers that map it onto the shared planner layers,
and the re-exports of the serving surface from
:mod:`repro_torch.serving.service`. The reference's six removed v1 entry
points (``empty_index``, ``insert_read_batch``, ``build_archive``,
``insert_read``, ``serve_step``, ``match_file_ids``, kept there as
``ImportError`` stubs) have no counterpart: the port never had them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core import idl as idl_mod
from repro_torch.index import ingest, query


@dataclasses.dataclass(frozen=True)
class GeneSearchConfig:
    name: str = "idl-genesearch"
    n_files: int = 1024
    m: int = 1 << 26          # shared row count (bit-sliced index)
    k: int = 31
    t: int = 16
    L: int = 1 << 17          # locality window
    eta: int = 4
    read_len: int = 230       # query read length (200 kmers, paper's metric)
    scheme: str = "idl"       # "idl" | "rh"
    theta: float = 1.0        # kmer-coverage threshold for a file match

    @property
    def file_words(self) -> int:
        return self.n_files // 32

    @property
    def n_kmers(self) -> int:
        return self.read_len - self.k + 1

    def idl_config(self) -> idl_mod.IDLConfig:
        return idl_mod.IDLConfig(
            k=self.k, t=self.t, L=self.L, eta=self.eta, m=self.m, align=True
        )


def insert_plan(
    cfg: GeneSearchConfig, batch: int, index_shape: tuple[int, int],
    read_len: Optional[int] = None, device="cuda",
) -> ingest.InsertPlan:
    """The cached shared-layer plan for this service's insert geometry
    (``read_len`` defaults to the query read length)."""
    return ingest.plan_insert(
        cfg.idl_config(), cfg.scheme,
        (batch, cfg.read_len if read_len is None else read_len),
        tuple(index_shape), kind="cols", lane32=True, device=device,
    )


def query_plan(
    cfg: GeneSearchConfig, batch: int, index_shape: tuple[int, int],
    device="cuda",
) -> query.QueryPlan:
    """The cached shared-layer plan for this service's query geometry."""
    return query.plan_query(
        cfg.idl_config(), cfg.scheme, (batch, cfg.read_len),
        tuple(index_shape), bit_probe=False, lane32=True, device=device,
    )


# -- the serving surface's re-exports (home: repro_torch.serving.service) ---
from repro_torch.serving.service import (  # noqa: E402,F401  (tail import)
    BatchStats,
    GeneSearchService,
    SearchRequest,
    SearchResult,
    ServiceConfig,
)
