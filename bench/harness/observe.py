"""What the benchmark reads of the program's own observability: its
metrics registry (counters and histograms, as deltas over the window)
and the spans of its request tracer."""

from __future__ import annotations

from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

# the service's per-batch stages: one span each per request, with the
# same times for every request of a batch
BATCH_STAGES = ("assemble", "execute", "finalize")


def snapshot() -> dict:
    return obs_metrics.DEFAULT.snapshot()


def delta(before: dict, after: dict) -> dict:
    """``{"counters": {name: {labels: d}}, "hists": {name: {labels:
    {"count": d, "sum": d}}}}`` over the window."""
    out = {"counters": {}, "hists": {}}
    for name, series in after["counters"].items():
        old = before["counters"].get(name, {})
        out["counters"][name] = {lk: v - old.get(lk, 0.0)
                                 for lk, v in series.items()}
    for name, series in after["hists"].items():
        old = before["hists"].get(name, {})
        out["hists"][name] = {
            lk: {"count": h["count"] - old.get(lk, {}).get("count", 0),
                 "sum": h["sum"] - old.get(lk, {}).get("sum", 0.0)}
            for lk, h in series.items()}
    return out


def labels(key: str) -> dict:
    return obs_metrics.parse_label_key(key)


def clear_spans() -> None:
    obs_trace.DEFAULT.clear()


def take_batch_spans() -> list:
    """The stage spans of the batch the service finished last, as
    ``(name, t0_ns, t1_ns)`` epoch times, and empty the tracer's ring.

    Each request of a batch ends its chain with the batch's stage spans,
    so the ring's last records are the batch's. The ring is read at its
    tail (its records are ``(trace, span, parent, name, pid, t0, dur,
    status, attrs)`` tuples): converting every record of a 256-request
    batch to a dict would cost the host more than the batch's own stages.
    If the ring is not laid out so, the public records are read instead.
    """
    trc = obs_trace.DEFAULT
    ring = getattr(trc, "_ring", None)
    tail = list(ring)[-len(BATCH_STAGES):] if ring else []
    if (len(tail) == len(BATCH_STAGES)
            and all(len(r) == 9 and r[3] == name
                    for r, name in zip(tail, BATCH_STAGES))):
        spans = [(r[3], int(r[5] * 1e9), int((r[5] + r[6]) * 1e9))
                 for r in tail]
    else:
        last = {}
        for rec in trc.records():
            if rec["name"] in BATCH_STAGES:
                last[rec["name"]] = (rec["name"], int(rec["t0"] * 1e9),
                                     int((rec["t0"] + rec["dur"]) * 1e9))
        spans = list(last.values())
    trc.clear()
    return spans
