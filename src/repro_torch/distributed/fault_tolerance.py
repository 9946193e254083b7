"""Fault tolerance on the host: heartbeats, stragglers, preemption.

The port's copy of the part of :mod:`repro.distributed.fault_tolerance`
that the training loop uses; it touches no device, so it is the
reference's code line for line:

* ``Heartbeat`` — per-step wall-clock monitor. A step slower than
  ``straggler_factor`` x the rolling median of the last ``window`` steps
  (once 8 are known) is a straggler event.
* ``PreemptionGuard`` — SIGTERM/SIGINT -> "checkpoint at the next step
  boundary" flag.
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
