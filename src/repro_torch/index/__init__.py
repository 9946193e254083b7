"""Gene-sequence index: hash registry, packed storage, query and ingest
layers, index state, snapshot store, and the four engines (flat Bloom
filter, COBS, RAMBO, bit-sliced) behind one :class:`GeneIndex` protocol."""

from repro_torch.index import ingest, packed, query, registry, state, store
from repro_torch.index.engines import (
    BitSlicedIndex,
    CobsIndex,
    PackedBloomIndex,
    RamboIndex,
)
from repro_torch.index.ingest import InsertPlan, build_archive, plan_insert
from repro_torch.index.protocol import GeneIndex
from repro_torch.index.query import QueryPlan, plan_query
from repro_torch.index.state import IndexState, StaleIndexError, StateMeta
from repro_torch.index.store import SnapshotError

__all__ = [
    "BitSlicedIndex",
    "CobsIndex",
    "GeneIndex",
    "IndexState",
    "InsertPlan",
    "PackedBloomIndex",
    "QueryPlan",
    "RamboIndex",
    "SnapshotError",
    "StaleIndexError",
    "StateMeta",
    "build_archive",
    "ingest",
    "packed",
    "plan_insert",
    "plan_query",
    "query",
    "registry",
    "state",
    "store",
]
