"""Per-request tracing: spans, cross-process trace context, ring buffer.

A trace id is minted once at admission (service/scheduler submit, fabric
gateway, scatter router) and follows the request everywhere — including
across process boundaries: the gateway puts ``(trace_id, parent_span_id)``
on the IPC request frame, the worker opens child
spans under that parent, and the worker's finished spans ride back in the
obs snapshot so the gateway can stitch one tree out of many processes.

Span ids are ``"<pid hex>.<seq hex>"`` strings, so ids minted in different
processes can never collide and a stitched tree needs no renumbering.
Timing uses the monotonic clock for durations (immune to wall-clock
steps); each record also carries an epoch-anchored start (monotonic offset
re-based once at import) so spans from one host line up on a shared
timeline in the Chrome viewer.

Finished spans are plain dicts in a bounded ring (:class:`Tracer`), never
an unbounded log. Two export shapes: ``export()`` groups records by trace
id (JSON), ``export_chrome()`` emits ``trace_event`` "X" (complete)
events loadable by chrome://tracing / Perfetto.

Hot-path discipline: the batch pipeline does not build Span objects per
request mid-flight — it stamps monotonic times it mostly already takes,
and emits finished records in one pass at finalize (:meth:`Tracer.emit`).
An open :class:`Span` object is only held where someone must be able to
*close it with an error later* (gateway-side dispatch spans, so a worker
death closes them instead of leaking them).
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

# Trace context as it rides an IPC frame: (trace_id, parent_span_id).
TraceContext = Tuple[str, str]

# The one clock of the process's spans and stage timers (seconds,
# monotonic): a span and a stage that share a boundary share its stamp.
now = time.monotonic

# Re-based once: epoch seconds at monotonic zero, so monotonic stamps
# taken anywhere in this process convert to a shared wall timeline.
_EPOCH0 = time.time() - now()

# Process-wide id sequence shared by every Tracer instance.
_SEQ = itertools.count(1)


def mono_to_epoch(t_mono: float) -> float:
    return _EPOCH0 + t_mono


class Span:
    """An OPEN span. Created via :meth:`Tracer.start`; finished with
    :meth:`end` (ok) or :meth:`end` with ``status='error'``. The tracer
    tracks open spans so an owner (gateway) can error-close everything a
    dead worker left behind."""

    __slots__ = ("tracer", "name", "trace_id", "span_id", "parent_id",
                 "attrs", "t0", "_done")

    def __init__(self, tracer: "Tracer", name: str, trace_id: str,
                 span_id: str, parent_id: Optional[str],
                 attrs: Optional[dict]):
        self.tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.attrs = attrs
        self.t0 = now()
        self._done = False

    def context(self) -> TraceContext:
        """The ``(trace_id, span_id)`` pair a child — possibly in another
        process — opens under."""
        return (self.trace_id, self.span_id)

    def end(self, status: str = "ok", **attrs: object) -> None:
        if self._done:                     # idempotent: late reply after a
            return                         # death-closure must not re-emit
        self._done = True
        t1 = now()
        if attrs:
            merged = dict(self.attrs) if self.attrs else {}
            merged.update(attrs)
        else:
            merged = self.attrs
        self.tracer._finish(self, self.t0, t1 - self.t0, status, merged)

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.end("error" if exc_type is not None else "ok")


# Ring-internal record layout. The hot path appends TUPLES (one small
# allocation instead of a dict build per span); ``records()`` renders
# them as the public dict shape at export time, off the hot path.
_TRACE, _SPAN, _PARENT, _NAME, _PID, _T0, _DUR, _STATUS, _ATTRS = range(9)


def _to_dict(rec: tuple) -> dict:
    d = {"trace": rec[_TRACE], "span": rec[_SPAN], "parent": rec[_PARENT],
         "name": rec[_NAME], "pid": rec[_PID], "t0": rec[_T0],
         "dur": rec[_DUR], "status": rec[_STATUS]}
    if rec[_ATTRS]:
        d["attrs"] = dict(rec[_ATTRS])
    return d


class Tracer:
    """Bounded ring of finished span records + the open-span table.

    Records are plain dicts::

        {"trace": id, "span": id, "parent": id|None, "name": str,
         "pid": int, "t0": epoch_s, "dur": s, "status": "ok"|"error",
         "attrs": {...}}   # attrs omitted when empty

    (Internally the ring holds tuples — see ``_to_dict`` — so the
    per-span hot-path cost is one tuple literal + one deque append;
    everything exported is the dict shape above.)
    """

    def __init__(self, capacity: int = 8192):
        self.enabled = True
        self.capacity = int(capacity)
        self._ring: deque = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._open: Dict[str, Span] = {}
        # the seq counter is process-global, not per-instance: ids stay
        # unique even when tests build several private tracers in one
        # process
        self._seq = _SEQ
        self._pid = os.getpid()
        self._prefix = "%x." % self._pid    # span-id prefix, formatted once

    # -- ids -------------------------------------------------------------
    def mint_trace(self) -> str:
        """New trace id, unique across processes (pid + per-process seq)."""
        return "t" + self._prefix + "%x" % next(self._seq)

    def mint_traces(self, n: int) -> List[str]:
        """``n`` new trace ids at once (an admitted block of requests)."""
        head = "t" + self._prefix
        return [head + "%x" % i for i in itertools.islice(self._seq, n)]

    def _mint_span(self) -> str:
        return self._prefix + "%x" % next(self._seq)

    # -- open spans ------------------------------------------------------
    def start(self, name: str, trace: Optional[TraceContext] = None,
              **attrs: object) -> Span:
        """Open a span. ``trace=None`` mints a fresh trace id (admission);
        otherwise the span is a child of ``trace = (trace_id, parent)`` —
        which may have been minted in another process."""
        if trace is None:
            trace_id, parent = self.mint_trace(), None
        else:
            trace_id, parent = trace
        span = Span(self, name, trace_id, self._mint_span(), parent,
                    attrs or None)
        if self.enabled:
            with self._lock:
                self._open[span.span_id] = span
        return span

    def _finish(self, span: Span, t0_mono: float, dur: float, status: str,
                attrs: Optional[dict]) -> None:
        with self._lock:
            self._open.pop(span.span_id, None)
        if not self.enabled:
            return
        self._ring.append((span.trace_id, span.span_id, span.parent_id,
                           span.name, self._pid, _EPOCH0 + t0_mono, dur,
                           status, dict(attrs) if attrs else None))

    def close_open_spans(self, status: str = "error",
                         **attrs: object) -> int:
        """Error-close every still-open span (gateway shutdown, or a
        worker whose process died taking its in-flight work). Returns how
        many were closed."""
        with self._lock:
            orphans = list(self._open.values())
        for span in orphans:
            span.end(status, **attrs)
        return len(orphans)

    # -- finished-record fast path --------------------------------------
    def emit(self, name: str, trace_id: str, parent: Optional[str],
             t0_mono: float, t1_mono: float, status: str = "ok",
             attrs: Optional[dict] = None) -> Optional[str]:
        """Append an already-timed span in one step — the batch pipeline
        stamps monotonic times as it flows and emits the whole
        queue-wait → assemble → execute → finalize chain at finalize,
        keeping Span bookkeeping off the submit hot path. Returns the new
        span id (so siblings can parent under it), or None when tracing
        is disabled."""
        if not self.enabled:
            return None
        span_id = self._mint_span()
        self._ring.append((trace_id, span_id, parent, name, self._pid,
                           _EPOCH0 + t0_mono, t1_mono - t0_mono, status,
                           attrs or None))
        return span_id

    def emit_chain(self, trace_id: str, parent: Optional[str],
                   root_name: str, t_root0: float, t_root1: float,
                   children, status: str = "ok",
                   root_attrs: Optional[dict] = None) -> Optional[str]:
        """Emit a root span plus already-timed children in ONE call — the
        per-request chain the batch pipeline produces at finalize
        (request + queue_wait/assemble/execute/finalize). ``children`` is
        a sequence of ``(name, t0_mono, t1_mono)``. Everything is local
        variables and tuple literals: per-request tracing costs a couple
        of microseconds instead of five function-call round trips each
        building a dict. Returns the root span id, or None when
        disabled."""
        if not self.enabled:
            return None
        seq, prefix, pid = self._seq, self._prefix, self._pid
        append = self._ring.append
        root = prefix + "%x" % next(seq)
        append((trace_id, root, parent, root_name, pid,
                _EPOCH0 + t_root0, t_root1 - t_root0, status,
                root_attrs or None))
        for name, ta, tb in children:
            append((trace_id, prefix + "%x" % next(seq), root, name, pid,
                    _EPOCH0 + ta, tb - ta, status, None))
        return root

    def emit_request_chains(self, entries, q_end: float, stages,
                            t_done: float, status: str = "ok",
                            shared_attrs: Optional[dict] = None) -> None:
        """Batched :meth:`emit_chain` for one finalized batch: every entry
        gets a root ``request`` span ending at ``t_done`` with a private
        ``queue_wait`` child (admission → ``q_end``) plus the batch-shared
        ``stages`` children (``(name, t0_mono, t1_mono)`` with identical
        times for the whole batch). ``entries`` is ``[(trace_id, parent,
        t_enq_mono, rid), ...]``. The batch-invariant work — epoch
        rebasing of the shared stage times, attribute loads, the shared
        attrs template — is hoisted out of the per-request loop, and each
        request mints ONE sequence id: its children derive their span ids
        from the root (``<root>.q``, ``<root>.0``...), which is unique by
        construction and skips five format/concat rounds per request.
        This is why the batch pipeline calls this instead of per-request
        :meth:`emit_chain`."""
        if not self.enabled:
            return
        seq, prefix, pid = self._seq, self._prefix, self._pid
        append = self._ring.append
        e0 = _EPOCH0
        shared = [(name, ".%d" % j, e0 + ta, tb - ta)
                  for j, (name, ta, tb) in enumerate(stages)]
        base = tuple(shared_attrs.items()) if shared_attrs else ()
        for trace_id, parent, t_enq, rid in entries:
            root = prefix + "%x" % next(seq)
            append((trace_id, root, parent, "request", pid, e0 + t_enq,
                    t_done - t_enq, status, base + (("rid", rid),)))
            append((trace_id, root + ".q", root, "queue_wait",
                    pid, e0 + t_enq, q_end - t_enq, status, None))
            for name, sfx, ta_e, dur in shared:
                append((trace_id, root + sfx, root, name,
                        pid, ta_e, dur, status, None))

    def ingest(self, records: List[dict]) -> None:
        """Fold finished records from ANOTHER tracer (a worker's snapshot,
        shipped over IPC) into this ring — the stitching half of
        cross-process tracing. Records already carry their origin pid."""
        append = self._ring.append
        for r in records:
            append((r["trace"], r["span"], r["parent"], r["name"],
                    r["pid"], r["t0"], r["dur"], r["status"],
                    r.get("attrs")))

    # -- export ----------------------------------------------------------
    def records(self) -> List[dict]:
        """Finished records as public dicts, oldest first (a copy)."""
        return [_to_dict(rec) for rec in self._ring]

    def export(self) -> dict:
        """JSON shape: records grouped per trace id, each trace's spans
        sorted by start time."""
        traces: Dict[str, List[dict]] = {}
        for rec in self.records():
            traces.setdefault(rec["trace"], []).append(rec)
        for spans in traces.values():
            spans.sort(key=lambda r: r["t0"])
        return {"pid": self._pid, "n_spans": sum(map(len, traces.values())),
                "traces": traces}

    def export_chrome(self) -> dict:
        """Chrome ``trace_event`` JSON (load in chrome://tracing or
        Perfetto): one "X" complete event per span, ts/dur in µs, pid =
        origin process, tid = trace id (one row per request)."""
        events = []
        for rec in self.records():
            ev = {"name": rec["name"], "ph": "X", "cat": rec["status"],
                  "ts": rec["t0"] * 1e6, "dur": rec["dur"] * 1e6,
                  "pid": rec["pid"], "tid": rec["trace"],
                  "args": {"span": rec["span"],
                           "parent": rec["parent"],
                           **rec.get("attrs", {})}}
            events.append(ev)
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def clear(self) -> None:
        self._ring.clear()


# Process-local default tracer, same pattern as metrics.DEFAULT.
DEFAULT = Tracer()


def tracer() -> Tracer:
    return DEFAULT


def set_enabled(enabled: bool) -> None:
    DEFAULT.enabled = bool(enabled)
