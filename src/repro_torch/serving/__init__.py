"""Serving layer: the dynamic-batching service and the serving cluster.

:mod:`repro_torch.serving.service` is the synchronous surface (typed
requests, shape-bucketed batching over any ``IndexState``, snapshot
startup, hot swap, the membership cache of
:mod:`repro_torch.serving.kmer_cache`). On top of it:
:mod:`repro_torch.serving.scheduler` (futures, deadline flusher, pipelined
batches), :mod:`repro_torch.serving.router` (K replicas sharing one state
per device, routing policies, hot snapshot swap under traffic) and
:mod:`repro_torch.serving.autoscale` (admission policy and replica
autoscaler). :mod:`repro_torch.serving.live` adds the write path:
``LiveGeneSearchService`` / ``LiveReplicaRouter`` serve a
:class:`repro_torch.index.lsm.LiveIndex` (base + delta) with background
compaction. :mod:`repro_torch.serving.genesearch` keeps the serve-geometry
helpers.
"""

from repro_torch.serving import autoscale, genesearch, kmer_cache, live, \
    router, scheduler, service
from repro_torch.serving.autoscale import (
    AdmissionPolicy,
    AutoscaleConfig,
    ReplicaAutoscaler,
)
from repro_torch.serving.kmer_cache import KmerCache, KmerCacheConfig, \
    merge_cache_stats, pack_codes
from repro_torch.serving.live import Compactor, LiveGeneSearchService, \
    LiveReplicaRouter
from repro_torch.serving.router import ReplicaRouter, RouterConfig, \
    RoutingPolicy
from repro_torch.serving.scheduler import AsyncScheduler, ClusterStats, \
    InsertAck, SchedulerConfig
from repro_torch.serving.service import (
    BatchStats,
    GeneSearchService,
    SearchRequest,
    SearchResult,
    ServiceConfig,
)

__all__ = [
    "AdmissionPolicy",
    "AsyncScheduler",
    "AutoscaleConfig",
    "BatchStats",
    "ClusterStats",
    "Compactor",
    "GeneSearchService",
    "InsertAck",
    "KmerCache",
    "KmerCacheConfig",
    "LiveGeneSearchService",
    "LiveReplicaRouter",
    "ReplicaAutoscaler",
    "ReplicaRouter",
    "RouterConfig",
    "RoutingPolicy",
    "SchedulerConfig",
    "SearchRequest",
    "SearchResult",
    "ServiceConfig",
    "autoscale",
    "genesearch",
    "kmer_cache",
    "live",
    "merge_cache_stats",
    "pack_codes",
    "router",
    "scheduler",
    "service",
]
