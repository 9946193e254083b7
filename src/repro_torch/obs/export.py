"""Obs export: one snapshot shape, one fleet merge, one dump format.

Port of :mod:`repro.obs.export` (pure Python, copied).

``snapshot()`` bundles the process's metrics snapshot and finished trace
records into a single plain dict — the payload a fabric worker or shard
member returns for a ``stats`` IPC request. ``merge()`` folds any number
of those (gateway + workers, router + shards) into one fleet view:
counters/histograms sum via :func:`repro_torch.obs.metrics.merge`, trace
records concatenate (span ids are pid-scoped so stitching needs no renumbering).

``dump()`` writes the fleet view to disk as two artifacts next to each
other: ``PATH`` (metrics + traces, JSON) and ``PATH`` with a ``.chrome``
suffix inserted (Chrome ``trace_event`` file for chrome://tracing) — the
``launch/serve.py --obs-dump`` and CI-artifact format.

``cache_stats_view()`` derives the classic membership-cache stats dict
(hits / misses / lookups / hit_rate / entries / capacity / evictions /
invalidations) from a (possibly merged) snapshot's ``kmer_cache.*``
series — the registry-backed replacement for each tier hand-merging
per-cache dicts.
"""

from __future__ import annotations

import json
import pathlib
from typing import Iterable, List, Optional

from repro_torch.obs import metrics as metrics_mod
from repro_torch.obs import trace as trace_mod


def snapshot(registry: Optional[metrics_mod.Registry] = None,
             tracer: Optional[trace_mod.Tracer] = None) -> dict:
    """This process's full obs state: ``{"metrics": <registry snapshot>,
    "spans": [finished records...]}``. Plain data — safe to pickle over
    IPC or json.dump to disk."""
    reg = registry if registry is not None else metrics_mod.DEFAULT
    trc = tracer if tracer is not None else trace_mod.DEFAULT
    return {"metrics": reg.snapshot(), "spans": trc.records()}


def merge(snapshots: Iterable[dict]) -> dict:
    """Fleet merge of :func:`snapshot` dicts: metrics fold through
    :func:`repro_torch.obs.metrics.merge`, span records concatenate in time
    order."""
    snaps = [s for s in snapshots if s]
    spans: List[dict] = []
    for s in snaps:
        spans.extend(s.get("spans", ()))
    spans.sort(key=lambda r: r.get("t0", 0.0))
    return {"metrics": metrics_mod.merge(s.get("metrics", {})
                                         for s in snaps),
            "spans": spans}


def traces_of(snap: dict) -> dict:
    """Group a (merged) snapshot's span records per trace id."""
    traces: dict = {}
    for rec in snap.get("spans", ()):
        traces.setdefault(rec["trace"], []).append(rec)
    for recs in traces.values():
        recs.sort(key=lambda r: r["t0"])
    return traces


def chrome_events(snap: dict) -> dict:
    """Chrome ``trace_event`` JSON for a (merged) snapshot's spans."""
    events = [{"name": rec["name"], "ph": "X", "cat": rec["status"],
               "ts": rec["t0"] * 1e6, "dur": rec["dur"] * 1e6,
               "pid": rec["pid"], "tid": rec["trace"],
               "args": {"span": rec["span"], "parent": rec["parent"],
                        **rec.get("attrs", {})}}
              for rec in snap.get("spans", ())]
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def dump(snap: dict, path: str) -> List[str]:
    """Write a (merged) snapshot to ``path`` (metrics + traces, JSON) and
    a sibling ``<stem>.chrome.json`` Chrome trace. Returns the written
    paths."""
    p = pathlib.Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    doc = {"metrics": snap.get("metrics", {}),
           "traces": traces_of(snap)}
    p.write_text(json.dumps(doc, indent=2, default=float) + "\n")
    chrome = p.with_suffix(".chrome.json")
    chrome.write_text(json.dumps(chrome_events(snap), default=float) + "\n")
    return [str(p), str(chrome)]


def cache_stats_view(snap: dict) -> dict:
    """Membership-cache stats dict from a snapshot's ``kmer_cache.*``
    series — counters sum across every cache instance / process in the
    snapshot, so one helper serves the single-service, router, fabric and
    scatter tiers alike (shape-compatible with the historical
    ``KmerCache.stats()`` / ``merge_cache_stats()`` dicts)."""
    m = snap.get("metrics", snap)   # accept a bare metrics snapshot too
    hits = metrics_mod.counter_total(m, "kmer_cache.hits")
    misses = metrics_mod.counter_total(m, "kmer_cache.misses")
    lookups = hits + misses
    return {
        "hits": int(hits),
        "misses": int(misses),
        "lookups": int(lookups),
        "hit_rate": (hits / lookups) if lookups else 0.0,
        "entries": int(metrics_mod.gauge_total(m, "kmer_cache.entries")),
        "capacity": int(metrics_mod.gauge_total(m, "kmer_cache.capacity")),
        "evictions": int(metrics_mod.counter_total(
            m, "kmer_cache.evictions")),
        "invalidations": int(metrics_mod.counter_total(
            m, "kmer_cache.invalidations")),
    }
