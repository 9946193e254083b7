"""Index builds, one after another: each pass drops the last index,
allocates a fresh one and streams the whole archive into it through the
program's archive builder (the configuration's ``build`` settings), as an
operator rebuilding an index does. The window runs whole passes until
its time is up; the last pass is the one checked.

Mix keys: none besides ``kind``.
"""

from __future__ import annotations

import importlib
import time

from harness import counts


class Loop:
    def __init__(self, ctx):
        self.ctx = ctx
        build = ctx.config["build"]
        self.window_bases, self.chunk = build["window_bases"], build["chunk_reads"]
        self.bases = sum(len(g) for g in ctx.genomes)
        self.batches_per_pass = -(-sum(
            counts.window_count(len(g), self.window_bases, ctx.config["k"])
            for g in ctx.genomes) // self.chunk)
        self.index = None
        self.passes = 0
        self.program_spans: list = []
        self.host_spans: list = []

    def _pass(self) -> None:
        ctx = self.ctx
        self.index = None                 # the old index goes first
        index = ctx.engine.new_index(ctx.config, ctx.device)
        self.index = ctx.engine.build(index, ctx.genomes, self.window_bases,
                                      self.chunk)
        ctx.sync()

    def warm(self) -> None:
        self._pass()

    def window(self, seconds: float, trace: bool) -> dict:
        t0 = time.perf_counter()
        while True:
            ta = time.time_ns()
            self._pass()
            self.passes += 1
            if trace:
                self.host_spans.append(("build pass", ta, time.time_ns()))
            if time.perf_counter() - t0 >= seconds:
                break
        window_s = time.perf_counter() - t0
        batches = self.passes * self.batches_per_pass
        return {"window_s": window_s, "bases": self.passes * self.bases,
                "batches": batches, "attempted": batches, "failed": 0}

    def release(self) -> None:
        # the last pass's words are the output judged; the rest goes
        self.words = self.ctx.engine.output_words(self.index)
        self.index = None

    def check(self) -> dict:
        ctx = self.ctx
        want = ctx.engine.reference_words(ctx.config, ctx.genomes,
                                          ctx.device)
        bad = int((self.words != want).sum())
        return {"mismatched_words": (bad, 0)}

    def work(self) -> dict:
        ctx = self.ctx

        def insert_bytes():
            batches = ctx.engine.insert_batches(
                ctx.config, ctx.genomes, self.window_bases, self.chunk)
            per_pass = sum(ctx.engine.insert_bytes(ctx.config, r, f,
                                                   ctx.device)
                           for r, f in batches)
            return self.passes * per_pass

        return {"insert_bytes": insert_bytes}


def control_patches(cell, seed: int, device) -> list:
    """The control in the program's place, as ``(owner, name, value)``
    attributes to set: the archive builder writes the reference's index
    with each file's last kmer left out, which breaks "every kmer of
    every file indexed"."""
    from repro_torch.index import ingest

    eng = importlib.import_module(f"engines.{cell.config['engine']}")

    def build_archive(index, files, read_len, chunk_reads):
        words = eng.reference_words(cell.config, [g for _, g in files],
                                    device, skip_last_kmer=True)
        eng.output_words(index).copy_(words)
        return index

    return [(ingest, "build_archive", build_archive)]
