"""A closed loop of query batches through ``GeneSearchService.search``: a
bulk client streaming a read file, each batch sent when the last one's
answers are back.

Mix keys: ``batch_reads``, ``read_bases``, ``positive_share``,
``poison_flips``, ``theta``, ``service`` (``max_batch``, ``backend``),
``pool_reads_per_s`` (the window's reads are distinct up to this rate:
the pool holds that many reads a second of the window, sent in turn),
``warm_batches`` (further batches, sent in set-up) and
``check_per_batch`` (answers of each batch kept for the check, rows
drawn from the seed).
"""

from __future__ import annotations

import importlib
import time
import types

import numpy as np

from harness import data, observe

SAMPLE_TABLE = 1024       # distinct row samples, used in turn
CHECK_MAX = 1 << 16       # answers compared at most, drawn from the seed


class Loop:
    def __init__(self, ctx):
        from repro_torch.serving import service

        self.ctx, mix = ctx, ctx.mix
        self.rng, self.batches, self.sample = pool(ctx)
        self.n_window = len(self.batches) - mix["warm_batches"]
        self.theta = float(mix["theta"])
        self.index = ctx.built_index()
        self.svc = service.GeneSearchService(self.index, service.ServiceConfig(
            theta=self.theta, max_batch=mix["service"]["max_batch"],
            backend=mix["service"]["backend"]))
        self.kept: list = []          # (pool batch, rows, verdicts)
        self.sent: list = []          # pool batch of every batch sent
        self.program_spans: list = []
        self.host_spans: list = []

    def warm(self) -> None:
        for batch in self.batches[self.n_window:]:
            self.svc.search(batch)

    def window(self, seconds: float, trace: bool) -> dict:
        if trace:
            observe.clear_spans()
        n_pool = self.n_window
        sent = 0
        t0 = time.perf_counter()
        end = t0 + seconds
        while True:
            p = sent % n_pool
            ta = time.time_ns()
            results = self.svc.search(self.batches[p])
            tb = time.time_ns()
            rows = self.sample[sent % SAMPLE_TABLE]
            self.kept.append((p, rows, np.stack([results[r].matches
                                                 for r in rows])))
            self.sent.append(p)
            sent += 1
            if trace:
                self.host_spans.append(("service.search", ta, tb))
                self.program_spans.extend(observe.take_batch_spans())
            if time.perf_counter() >= end:
                break
        window_s = time.perf_counter() - t0
        reads = sent * self.batches.shape[1]
        return {"window_s": window_s, "reads": reads, "batches": sent,
                "attempted": reads, "failed": 0}

    def release(self) -> None:
        self.svc = self.index = None

    def check(self) -> dict:
        eng, ctx = self.ctx.engine, self.ctx
        reads = [self.batches[p][r] for p, rows, _ in self.kept
                 for r in rows]
        got = np.concatenate([v for _, _, v in self.kept])
        pick = checked_answers(len(reads), self.rng)
        reads, got = [reads[i] for i in pick], got[pick]
        words = eng.reference_words(ctx.config, ctx.genomes, ctx.device)
        want = eng.reference_verdicts(ctx.config, words, reads, self.theta)
        return {"mismatched_reads": (int((got != want).any(1).sum()), 0)}

    def work(self) -> dict:
        ctx = self.ctx

        def probe_bytes():
            used = sorted(set(self.sent))
            per = dict(zip(used, ctx.engine.probe_bytes_each(
                ctx.config, self.batches[used], ctx.device)))
            return sum(per[p] for p in self.sent)

        return {"probe_bytes": probe_bytes}


def pool(ctx) -> tuple:
    """``(rng, batches, sample)``: the seed's generator, the
    ``(n, batch_reads, read_bases)`` reads (the window's, then the
    warm-up's), and the table of rows whose answers are kept, batch after
    batch."""
    mix = ctx.mix
    rng = np.random.default_rng([ctx.seed, 2])
    b = mix["batch_reads"]
    n = max(-(-int(ctx.seconds * mix["pool_reads_per_s"]) // b), 1)
    reads, _ = data.read_pool(ctx.genomes, n + mix["warm_batches"], b,
                              mix["read_bases"], mix["positive_share"],
                              mix["poison_flips"], ctx.seed, ctx.device)
    sample = np.stack([
        np.sort(rng.choice(b, mix["check_per_batch"], replace=False))
        for _ in range(SAMPLE_TABLE)])
    return rng, reads, sample


def checked_answers(n: int, rng) -> np.ndarray:
    """Which of the ``n`` kept answers are compared: all, or
    ``CHECK_MAX`` of them drawn from the seed."""
    if n <= CHECK_MAX:
        return np.arange(n)
    return np.sort(rng.choice(n, CHECK_MAX, replace=False))


def control_patches(cell, seed: int, device) -> list:
    """The control in the program's place, as ``(owner, name, value)``
    attributes to set: the service answers with the reference's verdicts
    at every read's hit threshold one short (one kmer may miss), which
    breaks the exact θ coverage the configuration states."""
    from repro_torch.serving import service

    eng = importlib.import_module(f"engines.{cell.config['engine']}")
    words = eng.reference_words(cell.config, data.archive(cell.config, seed),
                                device)
    theta = float(cell.mix["theta"])

    def search(self, reads):
        got = eng.reference_verdicts(cell.config, words, list(reads), theta,
                                     slack=1)
        return [types.SimpleNamespace(matches=row) for row in got]

    return [(service.GeneSearchService, "search", search)]
