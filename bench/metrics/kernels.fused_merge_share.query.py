"""Share of RAMBO's merged batches in the window that took the fused
merge-and-count kernel (``index.rambo_merges{path=fused}``) and not the
per-kmer gathers (``{path=per_kmer}``), in percent. None where the program
counts no merge (no RAMBO index, or a program without the counter)."""


def read(rec):
    fused = rec.counter("index.rambo_merges", path="fused")
    total = fused + rec.counter("index.rambo_merges", path="per_kmer")
    return 100.0 * fused / total if total else None
