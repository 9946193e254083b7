"""Mean host ms a batch spends in the service around the probe: its
``assemble`` plus its ``finalize`` span (the program's request spans,
one of each per batch)."""


def read(rec):
    ms = [(t1 - t0) * 1e-6 for name, t0, t1 in rec.spans
          if name in ("assemble", "finalize")]
    batches = sum(1 for name, _, _ in rec.spans if name == "assemble")
    return sum(ms) / batches if batches else None
