"""The device side of a traced window, from ``torch.profiler``'s CUDA
activity: the seconds the device was busy (the union of its kernel, copy
and set intervals), its seconds by operation, and its idle gaps named by
the host span that was open across them."""

from __future__ import annotations

import bisect
import collections
import heapq
import time

import torch

def short_name(name: str, limit: int = 96) -> str:
    """A kernel's name without its return type and parameter list."""
    if name.startswith("void "):
        name = name[5:]
    cut = name.find("(")
    if cut > 0:
        name = name[:cut]
    return name[:limit]


def _union(intervals: list) -> list:
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


class DeviceTrace:
    """``with DeviceTrace() as dt: ...`` profiles the device over the
    block; afterwards ``dt.events`` holds ``(name, start_ns, end_ns)`` of
    every device operation and ``dt.t0_ns`` / ``dt.t1_ns`` the window's
    ends, all on the host's epoch clock: a small kernel launched just
    before and just after the window ties the trace's clock to the host's
    (``clock_offset_ns``; ``clock_drift_ns`` how far the tie moved over the
    window, launch latency included)."""

    def __init__(self):
        self.events: list = []
        self.t0_ns = self.t1_ns = 0
        self._prof = None

    def __enter__(self) -> "DeviceTrace":
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._marks = [self._mark()]
        self.t0_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> None:
        torch.cuda.synchronize()
        self.t1_ns = time.time_ns()
        self._marks.append(self._mark())
        self._prof.__exit__(*exc)
        from torch.autograd import DeviceType

        events = sorted(
            (e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
            for e in self._prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA)
        self._prof = None
        # the first and last operations are the two marks: the trace's
        # clock read against the host's when each was launched
        (s0, _, _), (s1, _, _) = events[0], events[-1]
        self.clock_offset_ns = s0 - self._marks[0]
        self.clock_drift_ns = (s1 - self._marks[1]) - self.clock_offset_ns
        # on the host's clock, cut to the window (the tie is good to a
        # few tenths of a millisecond)
        self.events = []
        for s, e, name in events[1:-1]:
            s = max(s - self.clock_offset_ns, self.t0_ns)
            e = min(e - self.clock_offset_ns, self.t1_ns)
            if e > s:
                self.events.append((name, s, e))

    @staticmethod
    def _mark() -> int:
        """Launch one small kernel on an idle device; the host time of its
        launch (epoch ns)."""
        x = torch.empty(1, device="cuda")
        torch.cuda.synchronize()
        t = time.time_ns()
        x.fill_(1.0)
        torch.cuda.synchronize()
        return t

    @property
    def window_s(self) -> float:
        return (self.t1_ns - self.t0_ns) * 1e-9

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in
                   _union([(s, e) for _, s, e in self.events])) * 1e-9

    def seconds_of(self, fragment: str) -> tuple:
        """``(seconds, count)`` of the operations whose name holds
        ``fragment``."""
        hits = [e - s for name, s, e in self.events if fragment in name]
        return sum(hits) * 1e-9, len(hits)

    def top_ops(self, n: int = 10) -> list:
        total = collections.Counter()
        for name, s, e in self.events:
            total[short_name(name)] += e - s
        return [[name, ns * 1e-9] for name, ns in total.most_common(n)]

    def idle_gaps(self, host_spans: list, n: int = 10) -> list:
        """The window's idle seconds, summed by the innermost host span
        (``(name, t0_ns, t1_ns)``) open at each gap's middle: ``[[name,
        seconds], ...]``, the largest ``n``."""
        busy = _union([(s, e) for _, s, e in self.events])
        edges = [self.t0_ns] + [x for iv in busy for x in iv] + [self.t1_ns]
        starts, names = innermost_segments(host_spans)
        total = collections.Counter()
        for a, b in zip(edges[0::2], edges[1::2]):
            i = bisect.bisect_right(starts, (a + b) // 2) - 1
            total[names[i] if i >= 0 else None] += b - a
        return [[name or "host outside any span", ns * 1e-9]
                for name, ns in total.most_common(n)]


def innermost_segments(spans: list) -> tuple:
    """Cut the timeline at every span's ends: ``(starts, names)``, each
    piece from ``starts[i]`` named by the shortest span open over it (None
    where none is)."""
    marks = sorted([(s, 1, i) for i, (_, s, _) in enumerate(spans)]
                   + [(e, 0, i) for i, (_, _, e) in enumerate(spans)])
    open_, heap, starts, names = set(), [], [], []
    for t, is_start, i in marks:
        if is_start:
            open_.add(i)
            heapq.heappush(heap, (spans[i][2] - spans[i][1], i))
        else:
            open_.discard(i)
        while heap and heap[0][1] not in open_:
            heapq.heappop(heap)
        starts.append(t)
        names.append(spans[heap[0][1]][0] if heap else None)
    return starts, names
