"""Gene-search serving: the dynamic-batching service and its config."""

from repro_torch.serving.service import (
    BatchStats,
    GeneSearchService,
    SearchRequest,
    SearchResult,
    ServiceConfig,
)

__all__ = [
    "BatchStats",
    "GeneSearchService",
    "SearchRequest",
    "SearchResult",
    "ServiceConfig",
]
