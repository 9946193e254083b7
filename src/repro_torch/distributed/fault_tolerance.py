"""Fault tolerance on the host: heartbeats, stragglers, preemption, elasticity.

The port's copy of :mod:`repro.distributed.fault_tolerance`; it touches
no device, so it is the reference's code line for line:

* ``Heartbeat`` — per-step wall-clock monitor. A step slower than
  ``straggler_factor`` x the rolling median of the last ``window`` steps
  (once 8 are known) is a straggler event.
* ``PreemptionGuard`` — SIGTERM/SIGINT -> "checkpoint at the next step
  boundary" flag.
* ``plan_elastic_mesh`` / ``reassign_shards`` — from the surviving device
  set, the largest (data, model) grid that keeps the model-parallel
  groups whole, and a deterministic round-robin of data shards over the
  surviving workers.
"""

from __future__ import annotations

import dataclasses
import signal
import statistics
import time


@dataclasses.dataclass
class StragglerEvent:
    step: int
    duration: float
    median: float


class Heartbeat:
    def __init__(self, straggler_factor: float = 3.0, window: int = 32):
        self.straggler_factor = straggler_factor
        self.window = window
        self.durations: list[float] = []
        self.events: list[StragglerEvent] = []
        self._t0: float | None = None
        self._step = 0

    def start_step(self, step: int) -> None:
        self._step = step
        self._t0 = time.monotonic()

    def end_step(self) -> StragglerEvent | None:
        if self._t0 is None:
            return None
        dt = time.monotonic() - self._t0
        self._t0 = None
        hist = self.durations[-self.window:]
        self.durations.append(dt)
        if len(hist) >= 8:
            med = statistics.median(hist)
            if dt > self.straggler_factor * med:
                ev = StragglerEvent(step=self._step, duration=dt, median=med)
                self.events.append(ev)
                return ev
        return None


class PreemptionGuard:
    """Convert SIGTERM/SIGINT into a graceful checkpoint-and-exit request."""

    def __init__(self, install: bool = True):
        self.requested = False
        self._prev: dict[int, object] = {}
        if install:
            for sig in (signal.SIGTERM, signal.SIGINT):
                try:
                    self._prev[sig] = signal.signal(sig, self._handler)
                except ValueError:
                    pass  # non-main thread (tests)

    def _handler(self, signum, frame):
        self.requested = True

    def restore(self) -> None:
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)


@dataclasses.dataclass
class ElasticPlan:
    data: int
    model: int
    dropped: int

    @property
    def n_devices(self) -> int:
        return self.data * self.model


def plan_elastic_mesh(
    n_alive: int, model_parallel: int, *, min_data: int = 1
) -> ElasticPlan:
    """Largest (data, model) grid from survivors, keeping TP groups whole.

    Model-parallel groups cannot be split across failures (params are
    sharded inside a group), so ``model_parallel`` stays fixed and the
    data axis shrinks to the largest multiple that fits. Raises if even
    ``min_data`` groups can't be formed.
    """
    if model_parallel <= 0:
        raise ValueError("model_parallel must be positive")
    data = n_alive // model_parallel
    if data < min_data:
        raise RuntimeError(
            f"cannot form a mesh: {n_alive} devices < {min_data}×{model_parallel}"
        )
    used = data * model_parallel
    return ElasticPlan(data=data, model=model_parallel, dropped=n_alive - used)


def reassign_shards(
    n_shards: int, failed: set[int], n_workers: int
) -> dict[int, list[int]]:
    """Round-robin data shards over surviving workers (failed ones excluded).

    Deterministic given (n_shards, failed set): every survivor computes the
    same assignment without coordination.
    """
    alive = [w for w in range(n_workers) if w not in failed]
    if not alive:
        raise RuntimeError("no surviving workers")
    out: dict[int, list[int]] = {w: [] for w in alive}
    for s in range(n_shards):
        out[alive[s % len(alive)]].append(s)
    return out
