"""Gene-sequence index: hash registry, packed storage, query and ingest
layers, index state, snapshot store, and the flat-filter and bit-sliced
engines."""

from repro_torch.index import ingest, packed, query, registry, state, store
from repro_torch.index.engines import BitSlicedIndex, PackedBloomIndex
from repro_torch.index.ingest import InsertPlan, build_archive, plan_insert
from repro_torch.index.query import QueryPlan, plan_query
from repro_torch.index.state import IndexState, StaleIndexError, StateMeta
from repro_torch.index.store import SnapshotError

__all__ = [
    "BitSlicedIndex",
    "IndexState",
    "InsertPlan",
    "PackedBloomIndex",
    "QueryPlan",
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
