"""Process-local metrics registry: counters, gauges, log2 histograms.

One registry per process (module-level :data:`DEFAULT`), threaded through
every serving tier. Instruments are *pre-bound handles*: a tier calls
``counter("serving.requests", tier="scheduler")`` once at construction and
keeps the returned handle; the hot path then calls ``handle.inc(n)`` which
touches no dict, formats no label string, and allocates nothing — the only
per-event work is one lock acquire and one add. Histograms use fixed log2
buckets (``bucket = bit_length(int(value))``, clamped to
:data:`N_BUCKETS`), so observing a latency is an index increment into a
pre-allocated list.

``snapshot()`` renders the whole registry as a plain nested dict (JSON- and
pickle-clean) and ``merge()`` folds any number of snapshots from other
processes into one — the single cross-process aggregation path used by the
fabric gateway and the scatter router (replacing their per-tier ad-hoc
dict merging).

Labels follow one vocabulary across the stack: ``tier`` (service /
scheduler / router / fabric / scatter), ``engine``, ``scheme``, and
``replica`` / ``shard`` / ``worker`` for fan-out tiers. Extra labels are
allowed; they are sorted into a canonical ``k=v,k2=v2`` string at bind
time, never on the hot path.

Disabling (``set_enabled(False)``) turns every already-bound handle into a
cheap no-op (one attribute load + branch per event) — used by the obs
overhead bench to time obs-off serving without rebuilding the stack.

Host stages are timed by :class:`StageTimer`: the milliseconds between two
readings of :func:`repro_torch.obs.trace.now` (the spans' clock), one
pre-bound histogram series per stage.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, Iterable, List, Mapping, Optional, Tuple

from repro_torch.obs.trace import now

N_BUCKETS = 64          # log2 buckets: value v lands in int(v).bit_length()


def _label_key(labels: Mapping[str, object]) -> str:
    """Canonical, sorted ``k=v,k2=v2`` string ('' for unlabelled)."""
    if not labels:
        return ""
    return ",".join(f"{k}={labels[k]}" for k in sorted(labels))


def parse_label_key(key: str) -> Dict[str, str]:
    """Inverse of the label key: ``'a=1,b=x'`` -> ``{'a': '1', 'b': 'x'}``."""
    if not key:
        return {}
    return dict(part.split("=", 1) for part in key.split(","))


class Counter:
    """Monotonic counter handle. ``inc`` is the zero-allocation hot path."""

    __slots__ = ("_registry", "_lock", "_value")

    def __init__(self, registry: "Registry"):
        self._registry = registry
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, v: float = 1.0) -> None:
        if not self._registry.enabled:
            return
        with self._lock:
            self._value += v

    @property
    def value(self) -> float:
        return self._value

    def _reset(self) -> None:
        with self._lock:
            self._value = 0.0


class Gauge:
    """Last-write-wins gauge handle (entries, occupancy, fleet size...)."""

    __slots__ = ("_registry", "_value")

    def __init__(self, registry: "Registry"):
        self._registry = registry
        self._value = 0.0

    def set(self, v: float) -> None:
        if not self._registry.enabled:
            return
        self._value = float(v)

    @property
    def value(self) -> float:
        return self._value

    def _reset(self) -> None:
        self._value = 0.0


class Histogram:
    """Fixed-bucket log2 histogram: 64 pre-allocated buckets, no per-event
    allocation. Bucket ``i`` counts values with ``int(v).bit_length() == i``
    (i.e. ``2^(i-1) <= v < 2^i``; bucket 0 holds v < 1), clamped at the
    top. Tracks count / sum / min / max alongside the buckets."""

    __slots__ = ("_registry", "_lock", "buckets", "count", "sum",
                 "min", "max")

    def __init__(self, registry: "Registry"):
        self._registry = registry
        self._lock = threading.Lock()
        self.buckets = [0] * N_BUCKETS
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")

    def observe(self, v: float) -> None:
        if not self._registry.enabled:
            return
        i = int(v).bit_length()
        if i >= N_BUCKETS:
            i = N_BUCKETS - 1
        with self._lock:
            self.buckets[i] += 1
            self.count += 1
            self.sum += v
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v

    def _reset(self) -> None:
        with self._lock:
            for i in range(N_BUCKETS):
                self.buckets[i] = 0
            self.count = 0
            self.sum = 0.0
            self.min = float("inf")
            self.max = float("-inf")


class StageTimer:
    """Host milliseconds of named stages into one histogram, a series per
    stage: ``StageTimer("planner.stage_ms", tier="planner", op="build")``
    binds ``planner.stage_ms{op=build,stage=<s>,tier=planner}`` on stage
    ``s``'s first observation in the default registry and keeps the
    handle. Stamps are readings of :func:`~repro_torch.obs.trace.now`, the
    clock the spans use, so a stage that ends where a span ends can take
    the span's stamp."""

    __slots__ = ("_registry", "_name", "_labels", "_hists")

    def __init__(self, name: str, **labels: object):
        self._registry = DEFAULT
        self._name = name
        self._labels = labels
        self._hists: Dict[str, Histogram] = {}

    def observe(self, stage: str, t0: float, t1: float) -> None:
        """Add ``t1 - t0`` (two ``now()`` readings) as ms to ``stage``."""
        if not self._registry.enabled:
            return
        hist = self._hists.get(stage)
        if hist is None:
            hist = self._hists[stage] = self._registry.histogram(
                self._name, stage=stage, **self._labels)
        hist.observe(1e3 * (t1 - t0))

    def lap(self, stage: str, t0: float) -> float:
        """Observe ``stage`` from ``t0`` to now; returns the reading, the
        next stage's ``t0``."""
        t1 = now()
        self.observe(stage, t0, t1)
        return t1


class Registry:
    """Thread-safe instrument registry. Binding (``counter`` / ``gauge`` /
    ``histogram``) takes the creation lock and canonicalizes labels once;
    the returned handle is then lock-free to *hold* and cheap to hit.
    Binding the same (name, labels) twice returns the same handle, so
    replicas of one process share a counter series when their labels
    coincide and diverge when a ``replica=``/``shard=`` label splits them.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.enabled = True
        self._counters: Dict[Tuple[str, str], Counter] = {}
        self._gauges: Dict[Tuple[str, str], Gauge] = {}
        self._hists: Dict[Tuple[str, str], Histogram] = {}

    # -- binding ---------------------------------------------------------
    def counter(self, name: str, **labels: object) -> Counter:
        key = (name, _label_key(labels))
        with self._lock:
            h = self._counters.get(key)
            if h is None:
                h = self._counters[key] = Counter(self)
            return h

    def gauge(self, name: str, **labels: object) -> Gauge:
        key = (name, _label_key(labels))
        with self._lock:
            h = self._gauges.get(key)
            if h is None:
                h = self._gauges[key] = Gauge(self)
            return h

    def histogram(self, name: str, **labels: object) -> Histogram:
        key = (name, _label_key(labels))
        with self._lock:
            h = self._hists.get(key)
            if h is None:
                h = self._hists[key] = Histogram(self)
            return h

    # -- export ----------------------------------------------------------
    def snapshot(self) -> dict:
        """Plain nested dict of everything the process has recorded:
        ``{"pid", "utc", "counters": {name: {labelkey: value}}, "gauges":
        {...}, "hists": {name: {labelkey: {count, sum, min, max,
        buckets}}}}``. JSON- and pickle-clean; this is the unit the fleet
        merge operates on."""
        with self._lock:
            counters = list(self._counters.items())
            gauges = list(self._gauges.items())
            hists = list(self._hists.items())
        snap: dict = {
            "pid": os.getpid(),
            "utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
            "counters": {}, "gauges": {}, "hists": {},
        }
        for (name, lk), c in counters:
            snap["counters"].setdefault(name, {})[lk] = c.value
        for (name, lk), g in gauges:
            snap["gauges"].setdefault(name, {})[lk] = g.value
        for (name, lk), h in hists:
            with h._lock:
                snap["hists"].setdefault(name, {})[lk] = {
                    "count": h.count,
                    "sum": h.sum,
                    "min": h.min if h.count else 0.0,
                    "max": h.max if h.count else 0.0,
                    "buckets": list(h.buckets),
                }
        return snap

    def reset(self) -> None:
        """Zero every bound instrument (handles stay valid) — test isolation
        and per-stream deltas in the benches."""
        with self._lock:
            instruments = (list(self._counters.values())
                           + list(self._gauges.values())
                           + list(self._hists.values()))
        for h in instruments:
            h._reset()


def merge(snapshots: Iterable[dict]) -> dict:
    """Fold process snapshots into one fleet snapshot: counters and
    histogram buckets/count/sum SUM per (name, labelkey); histogram
    min/max take the extrema; gauges are last-write-wins per (name,
    labelkey) — fan-out tiers keep gauges distinct with ``pid=`` /
    ``worker=`` / ``shard=`` labels so nothing collides. This is the one
    cross-process aggregation path (gateway and scatter router both call
    it)."""
    out: dict = {"pid": os.getpid(),
                 "utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
                 "merged_from": 0,
                 "counters": {}, "gauges": {}, "hists": {}}
    for snap in snapshots:
        if not snap:
            continue
        # provenance: leaf snapshots count 1, already-merged ones carry
        # their own process count forward
        prior = int(snap.get("merged_from", 0) or 0)
        out["merged_from"] += prior if prior else 1
        for name, series in snap.get("counters", {}).items():
            dst = out["counters"].setdefault(name, {})
            for lk, v in series.items():
                dst[lk] = dst.get(lk, 0.0) + v
        for name, series in snap.get("gauges", {}).items():
            dst = out["gauges"].setdefault(name, {})
            for lk, v in series.items():
                dst[lk] = v
        for name, series in snap.get("hists", {}).items():
            dst = out["hists"].setdefault(name, {})
            for lk, h in series.items():
                cur = dst.get(lk)
                if cur is None:
                    dst[lk] = {"count": h["count"], "sum": h["sum"],
                               "min": h["min"], "max": h["max"],
                               "buckets": list(h["buckets"])}
                else:
                    cur["count"] += h["count"]
                    cur["sum"] += h["sum"]
                    if h["count"]:
                        cur["min"] = (min(cur["min"], h["min"])
                                      if cur["count"] != h["count"]
                                      else h["min"])
                        cur["max"] = max(cur["max"], h["max"])
                    for i, b in enumerate(h["buckets"]):
                        cur["buckets"][i] += b
    return out


def counter_total(snapshot: dict, name: str,
                  where: Optional[Mapping[str, str]] = None) -> float:
    """Sum a counter across every label series in a snapshot, optionally
    filtered (``where={"scheme": "idl"}`` keeps only series whose parsed
    labels contain those pairs). The standard way views roll a fleet
    snapshot up to one number."""
    total = 0.0
    for lk, v in snapshot.get("counters", {}).get(name, {}).items():
        if where:
            labels = parse_label_key(lk)
            if any(labels.get(k) != str(w) for k, w in where.items()):
                continue
        total += v
    return total


def gauge_total(snapshot: dict, name: str,
                where: Optional[Mapping[str, str]] = None) -> float:
    """Sum a gauge across label series (entries across caches, etc.)."""
    total = 0.0
    for lk, v in snapshot.get("gauges", {}).get(name, {}).items():
        if where:
            labels = parse_label_key(lk)
            if any(labels.get(k) != str(w) for k, w in where.items()):
                continue
        total += v
    return total


# The process-local default registry: every serving tier binds against
# this unless handed an explicit registry (tests build private ones).
DEFAULT = Registry()


def registry() -> Registry:
    return DEFAULT


def set_enabled(enabled: bool) -> None:
    """Flip the default registry's master switch. Already-bound handles
    see it immediately (per-event branch), so the obs overhead bench can
    compare on/off without reconstructing the serving stack."""
    DEFAULT.enabled = bool(enabled)


def reset() -> None:
    DEFAULT.reset()
