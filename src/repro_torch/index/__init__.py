"""Gene-sequence index: hash registry, packed storage, query and ingest
layers, index state, snapshot store, the four engines (flat Bloom filter,
COBS, RAMBO, bit-sliced) behind one :class:`GeneIndex` protocol, and the
live index (base + delta + write-ahead journal, :mod:`lsm`), and sharded
archives (:mod:`shards`)."""

from repro_torch.index import ingest, lsm, packed, query, registry, shards, \
    state, store
from repro_torch.index.engines import (
    BitSlicedIndex,
    CobsIndex,
    PackedBloomIndex,
    RamboIndex,
)
from repro_torch.index.ingest import InsertPlan, build_archive, \
    build_sharded_archive, plan_insert
from repro_torch.index.lsm import DeltaJournal, LiveIndex
from repro_torch.index.protocol import GeneIndex
from repro_torch.index.query import QueryPlan, plan_query
from repro_torch.index.registry import HashScheme
from repro_torch.index.shards import ShardSetError, ShardSetMeta, ShardSpec
from repro_torch.index.state import IndexState, StaleIndexError, StateMeta
from repro_torch.index.store import SnapshotError

__all__ = [
    "BitSlicedIndex",
    "CobsIndex",
    "DeltaJournal",
    "GeneIndex",
    "HashScheme",
    "IndexState",
    "InsertPlan",
    "LiveIndex",
    "PackedBloomIndex",
    "QueryPlan",
    "RamboIndex",
    "ShardSetError",
    "ShardSetMeta",
    "ShardSpec",
    "SnapshotError",
    "StaleIndexError",
    "StateMeta",
    "build_archive",
    "build_sharded_archive",
    "ingest",
    "lsm",
    "packed",
    "plan_insert",
    "plan_query",
    "query",
    "registry",
    "shards",
    "state",
    "store",
]
