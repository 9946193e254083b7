"""What one run measured, as the metric readers see it.

Every metric of ``BENCHMARK.json``, end to end or per layer, is a file
``bench/metrics/<name>.py`` with ``read(record) -> float | None``. A
reader returns None when the run has nothing it can read; the harness
then leaves the metric out of the line (an end-to-end metric that a cell
must report fails the run instead).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from harness import observe
from harness.devtrace import DeviceTrace


@dataclasses.dataclass
class Record:
    setup_s: float                    # process start to the window's start
    window_s: float                   # the measured window, host clock
    peak_bytes: int                   # torch.cuda.max_memory_allocated
    outcome: dict                     # what the loop counted in the window
    obs: dict                         # the program's registry, window deltas
    spans: list                       # (name, t0_ns, t1_ns): traced runs
    device: Optional[DeviceTrace]     # the profiled window: traced runs
    work: dict                        # yardstick values, computed on demand
    _work_done: dict = dataclasses.field(default_factory=dict)

    def counter(self, name: str, **match) -> float:
        """The window's increase of counter ``name``, summed over the
        series whose labels include ``match``."""
        return sum(v for lk, v in self.obs["counters"].get(name, {}).items()
                   if _matches(lk, match))

    def hist(self, name: str, **match) -> tuple:
        """``(count, sum)`` the window added to histogram ``name`` over
        the series whose labels include ``match``."""
        hs = [h for lk, h in self.obs["hists"].get(name, {}).items()
              if _matches(lk, match)]
        return sum(h["count"] for h in hs), sum(h["sum"] for h in hs)

    def work_value(self, name: str):
        """Yardstick quantity ``name`` (None if the loop gives none)."""
        if name not in self._work_done:
            fn: Optional[Callable] = self.work.get(name)
            self._work_done[name] = None if fn is None else fn()
        return self._work_done[name]


def _matches(label_key: str, match: dict) -> bool:
    have = observe.labels(label_key)
    return all(have.get(k) == str(v) for k, v in match.items())
