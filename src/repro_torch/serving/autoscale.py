"""Adaptive serving policy: admission control + replica autoscaling.

Port of :mod:`repro.serving.autoscale` (pure Python, copied).

The service records per-batch telemetry (:class:`BatchStats`: occupancy,
padding waste, wall time) but nothing *acted* on it. This module closes
the loop with two pure, clock-injected policies (no threads, no sleeps —
every decision is a function of observed events and an explicit ``now``,
so tests drive them deterministically):

* :class:`AdmissionPolicy` — per-bucket batching knobs for the async
  scheduler. It tracks an arrival-rate EWMA per kmer bucket plus an
  occupancy EWMA from executed batches, and derives (a) the **flush
  deadline** (how long the oldest request may wait for peers) and (b) the
  **admission target** (how many requests to wait for before flushing).
  The *physical* batch shape stays fixed at ``ServiceConfig.max_batch`` —
  that is what keeps one cached runner per (bucket, backend); the policy
  only moves how full a batch must be before it launches.
  Busy buckets batch up (occupancy↑, amortized dispatch); idle buckets
  flush almost immediately (latency↓, pad waste accepted).

* :class:`ReplicaAutoscaler` — replica-count recommendation for the
  router. It estimates total arrival rate (EWMA over submits) and
  per-replica service rate (EWMA of ``n_requests / wall`` over executed
  batches), sizes the fleet for ``target_utilization``, forces a step up
  when the outstanding backlog exceeds ``backlog_per_replica`` batches per
  replica, and rate-limits changes with a cooldown + one-step hysteresis
  so a noisy minute cannot thrash replicas up and down.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

__all__ = [
    "AutoscaleConfig",
    "EwmaRate",
    "Ewma",
    "AdmissionPolicy",
    "ReplicaAutoscaler",
]


@dataclasses.dataclass(frozen=True)
class AutoscaleConfig:
    """Knobs shared by the admission policy and the replica autoscaler."""

    # -- EWMA horizons ------------------------------------------------------
    halflife_s: float = 0.5        # arrival-rate estimator memory
    # -- admission (per bucket) --------------------------------------------
    deadline_ms_min: float = 0.2   # never hold a lone request longer than
    deadline_ms_max: float = 20.0  # ... and never wait past this for peers
    fill_slack: float = 1.0        # fraction of the fill time to wait
    target_occupancy: float = 0.7  # occupancy below this shrinks deadlines
    # -- replica scaling ----------------------------------------------------
    min_replicas: int = 1
    max_replicas: int = 4
    target_utilization: float = 0.6   # size fleet for rate/(mu*this)
    backlog_per_replica: float = 2.0  # queued batches/replica forcing +1
    cooldown_s: float = 1.0           # min seconds between size changes

    def __post_init__(self):
        if self.deadline_ms_min > self.deadline_ms_max:
            raise ValueError("deadline_ms_min must be <= deadline_ms_max")
        if not (0 < self.target_utilization <= 1):
            raise ValueError("target_utilization must be in (0, 1]")
        if self.min_replicas < 1 or self.max_replicas < self.min_replicas:
            raise ValueError("need 1 <= min_replicas <= max_replicas")


# ---------------------------------------------------------------------------
# Clock-injected estimators.
# ---------------------------------------------------------------------------

class EwmaRate:
    """Exponentially decayed event counter -> events/sec estimate.

    ``observe(now)`` bumps a count that decays with time constant
    ``tau = halflife / ln 2``; at steady state the decayed count of a rate-r
    stream is ``r * tau``, so ``rate(now) = count / tau``. No windows, no
    buffers — O(1) state, exact decay between arbitrary timestamps.
    """

    def __init__(self, halflife_s: float):
        if halflife_s <= 0:
            raise ValueError("halflife_s must be > 0")
        self._tau = halflife_s / math.log(2.0)
        self._count = 0.0
        self._t = None  # type: Optional[float]

    def _decay_to(self, now: float) -> None:
        if self._t is not None and now > self._t:
            self._count *= math.exp(-(now - self._t) / self._tau)
        self._t = now if self._t is None else max(self._t, now)

    def observe(self, now: float, weight: float = 1.0) -> None:
        self._decay_to(now)
        self._count += weight

    def rate(self, now: float) -> float:
        """Estimated events/sec at ``now`` (decays while idle)."""
        if self._t is None:
            return 0.0
        count = self._count
        if now > self._t:
            count *= math.exp(-(now - self._t) / self._tau)
        return count / self._tau


class Ewma:
    """Plain exponentially weighted mean of a sampled value."""

    def __init__(self, alpha: float = 0.2):
        if not (0 < alpha <= 1):
            raise ValueError("alpha must be in (0, 1]")
        self._alpha = alpha
        self._value = None  # type: Optional[float]

    def observe(self, x: float) -> None:
        self._value = (x if self._value is None
                       else self._alpha * x + (1 - self._alpha) * self._value)

    def value(self, default: float = 0.0) -> float:
        return default if self._value is None else self._value


# ---------------------------------------------------------------------------
# Admission policy: per-bucket deadline + admission target.
# ---------------------------------------------------------------------------

class AdmissionPolicy:
    """Adapt per-bucket flush deadline and admission target to the load.

    The rule, per bucket:

    * ``deadline_ms`` — the time a full batch would take to fill at the
      current arrival rate (``max_batch / rate``), scaled by ``fill_slack``
      and an occupancy correction, clamped to
      ``[deadline_ms_min, deadline_ms_max]``. Fast streams fill batches
      before the deadline matters; slow streams are not held hostage.
    * ``target_batch`` — the number of requests the deadline is actually
      expected to gather (``rate * deadline``), clamped to
      ``[1, max_batch]``. An idle bucket therefore flushes at 1 request
      after ``deadline_ms_min`` — minimum latency — while a hot bucket
      waits for a full batch — maximum occupancy.

    Occupancy feedback (the BatchStats consumer): batches that keep
    flushing on deadline with occupancy below ``target_occupancy`` shrink
    the bucket's deadline scale (we waited and peers never came); full
    batches relax it back. The scale is bounded so one burst cannot wedge
    the knob at an extreme.
    """

    _SCALE_LO, _SCALE_HI = 0.25, 4.0

    def __init__(self, config: Optional[AutoscaleConfig] = None):
        self.config = config or AutoscaleConfig()
        self._rates: Dict[int, EwmaRate] = {}
        self._occ: Dict[int, Ewma] = {}
        self._scale: Dict[int, float] = {}

    # -- observations -------------------------------------------------------
    def observe_arrival(self, bucket: int, now: float) -> None:
        rate = self._rates.get(bucket)
        if rate is None:
            rate = self._rates[bucket] = EwmaRate(self.config.halflife_s)
        rate.observe(now)

    def observe_batch(self, stats, now: float) -> None:
        """Feed one executed batch (BatchStats/ClusterStats duck-typed)."""
        bucket = stats.bucket
        occ = self._occ.get(bucket)
        if occ is None:
            occ = self._occ[bucket] = Ewma()
        occ.observe(stats.n_requests / max(stats.batch_rows, 1))
        scale = self._scale.get(bucket, 1.0)
        reason = getattr(stats, "flush_reason", None)
        if stats.n_requests >= stats.batch_rows:
            scale = min(scale * 1.1, self._SCALE_HI)
        elif reason == "deadline" and \
                occ.value(1.0) < self.config.target_occupancy:
            scale = max(scale * 0.9, self._SCALE_LO)
        self._scale[bucket] = scale

    # -- recommendations ----------------------------------------------------
    def deadline_ms(self, bucket: int, now: float, max_batch: int) -> float:
        cfg = self.config
        rate = self._rates.get(bucket)
        r = rate.rate(now) if rate is not None else 0.0
        if r <= 1e-9:
            return cfg.deadline_ms_min          # idle: don't hold requests
        fill_ms = 1e3 * max_batch / r
        dl = fill_ms * cfg.fill_slack * self._scale.get(bucket, 1.0)
        return min(max(dl, cfg.deadline_ms_min), cfg.deadline_ms_max)

    def target_batch(self, bucket: int, now: float, max_batch: int) -> int:
        rate = self._rates.get(bucket)
        r = rate.rate(now) if rate is not None else 0.0
        expected = r * self.deadline_ms(bucket, now, max_batch) * 1e-3
        return min(max(int(math.ceil(expected)), 1), max_batch)


# ---------------------------------------------------------------------------
# Replica autoscaler: fleet sizing between min/max bounds.
# ---------------------------------------------------------------------------

class ReplicaAutoscaler:
    """Recommend a replica count from arrival rate, service rate, backlog."""

    def __init__(self, config: Optional[AutoscaleConfig] = None):
        self.config = config or AutoscaleConfig()
        self._arrivals = EwmaRate(self.config.halflife_s)
        self._mu = Ewma()                     # per-replica req/s while busy
        self._t_last_change = None            # type: Optional[float]

    def observe_arrival(self, now: float) -> None:
        self._arrivals.observe(now)

    def observe_batch(self, stats, now: float) -> None:
        if stats.wall_ms > 0:
            self._mu.observe(stats.n_requests / (stats.wall_ms * 1e-3))

    def recommend(self, now: float, n_replicas: int,
                  outstanding: int, max_batch: int) -> int:
        """Next replica count: one hysteresis step toward the demand size,
        clamped to ``[min_replicas, max_replicas]``, cooldown-gated."""
        cfg = self.config
        rate = self._arrivals.rate(now)
        mu = self._mu.value(0.0)
        if mu > 0:
            desired = math.ceil(rate / (mu * cfg.target_utilization))
        else:
            desired = n_replicas                 # no service-rate sample yet
        if outstanding > cfg.backlog_per_replica * max_batch * n_replicas:
            desired = max(desired, n_replicas + 1)   # queue is winning
        desired = min(max(desired, cfg.min_replicas), cfg.max_replicas)
        if desired == n_replicas:
            return n_replicas
        if self._t_last_change is not None and \
                now - self._t_last_change < cfg.cooldown_s:
            return n_replicas                    # cooling down
        self._t_last_change = now
        # one step at a time: a noisy estimate moves the fleet by 1, not 3
        return n_replicas + (1 if desired > n_replicas else -1)
