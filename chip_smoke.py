#!/usr/bin/env python3
"""Drive the PyTorch port's paths on one CUDA card.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It imports ``repro_torch`` from ``src/`` beside this file (never JAX or the
reference package) and runs these phases, printing one line each:

1. device and build — the card, its power limit, and an ``nvcc`` build of
   every kernel source (``-Xptxas -v`` registers / shared memory / spills);
2. kernels vs their plain PyTorch versions on the card, bit for bit:
   2a-2c the bit-sliced path's ``gather_planned_rows`` and
   ``insert_planned`` at small widths (W = 1 and 32; for the gather the AND
   over η in {1, 3, 4} with ragged n_k and the last row, a misaligned view,
   an empty batch and a run plan's rows put back into probe order; for the
   insert unsorted positions with duplicates, masked ones and a full word,
   their compact plan, whose counters must equal the reference planner's,
   a run plan's flattened lanes, and an empty tensor) and at the main
   path's shapes (one 256-read serve batch, 204,800 probes into a 2^26 x
   32 matrix, on the compact probe plan, with the query ``device_plan``
   stage's host time and its counters against the reference planner's;
   one 512-read insert batch on its compact operand, with the insert
   ``device_plan`` stage's host time and its sort's device time); 2d
   ``window_min``, one launch per MinHash, at small shapes (w in {1, 2,
   16, 31}, ragged lengths; plain int64 lanes with bit 31 set,
   sign-flipped 64-bit hashes, int32, float32; unsigned int64; the DOPH
   form, lanes and unsigned 64-bit, with an empty bin; the exact form), at
   the rolling MinHash's shapes ((256, 215) and (512, 215) int64, w = 16,
   η 4: both DOPH forms, and the exact form signed beside ``unfold(-1, w,
   1).amin(-1)`` and unsigned) and over a whole genome's hashes (unsigned
   DOPH); 2e the flat filter's ``probe_planned_bits`` and
   ``insert_with_plan`` at the flat filter's shapes (one 256-read batch's
   compact probe plan into a 2^27-word filter, its counters against the
   reference planner's; a rounds plan with one block in several rounds,
   its valid lanes flattened on the device); 2f the wide rows: the
   gather's bit mode ``gather_planned_bits`` at one 256-read RAMBO serve
   batch (a (2^20, 320) matrix), at η 1/3/4, on a misaligned view and an
   empty batch, ``probe_planned_bits`` at the same shape (what the bit mode
   replaces there), both bit kernels across row widths, and
   ``gather_planned_rows`` at a COBS group's W = 16. Each main-shape kernel
   is timed with CUDA events and by CUDA-graph replay (the probe kernels
   and the gathers' library call also with the L2 flushed before each
   call) beside its plain version, its byte bound and, where one exists,
   a library call (timed both ways too);
3. the bit-sliced main path at full width (``full_config``: m = 2^26 rows,
   1024 files, k 31, t 16, L 2^17, η 4): an 8 GiB ``BitSlicedIndex`` built
   through ``build_archive(backend="idl_insert")`` (no numpy run planner
   call allowed) and served through ``GeneSearchService(backend=
   "idl_probe")`` in 256-read batches (no numpy probe planner call
   allowed; one ``gather_planned_rows`` launch per batch); recall must be
   total, the first batch must match the plain ``"torch"`` backend, and
   ``window_min`` must launch once per MinHash; then the mean host time of
   each planner stage (insert and query alike: ``locations``,
   ``device_plan``, ``launch``) and the peak device memory of ingest and
   of serving;
4. the paper's flat IDL Bloom filter at full width (m = 2^32 bits, a
   512 MiB filter; L 2^15, η 4, k 31, t 16) over one E. coli-sized genome:
   ingest through ``build_archive(backend="idl_insert")`` (no numpy run
   planner call), the same genome's locations through
   ``plan_insert_rounds`` and ``insert_with_plan`` into a second filter
   (equal word for word), then 8 batches of 256 genome reads served
   through ``msmt`` (all true; no numpy probe planner call, one
   ``probe_planned_bits`` launch per query and no ``gather_planned_rows``
   launch), ``probe_membership`` on the reference's run plan and on the
   compact plan (both equal to ``query_batch``) and one batch through
   ``GeneSearchService``, plus poisoned reads counted; ``window_min`` once
   per MinHash;
5. COBS over an archive of 1024 genomes with lengths log-uniform in
   [4,096, 262,144] bases (``CobsIndex.build(kmer counts, full_config's
   IDLConfig, "idl", bits_per_kmer=10, n_groups=2)``: two size groups at W
   = 16): ingest through ``build_archive(backend="idl_insert")`` in
   512-read batches, then 8 batches of 256 reads through
   ``GeneSearchService`` (recall total, the first batch equal to the
   ``"torch"`` backend, one ``gather_planned_rows`` launch per group and
   query), 256 random reads, and 256 overlapping reads through ``msmt``
   with and without dedup (equal); 5b minimizer ingest (``window_min=16``)
   of 64 files into a fresh COBS index (equal to the plain backend, a
   subset of a full build, three ``window_min`` launches per insert);
6. RAMBO over the same archive (``RamboIndex.build(1024, m = 2^25 bits a
   bucket)``: B 32, R 10, (320, 2^20) int32 words), its last file held out
   of the build and inserted after a query that must miss it (a query
   after the insert must find it), then served and checked as in phase 5,
   one ``gather_planned_bits`` launch per query;
7. the serving tier over phase 3's configuration: 7a a base of files
   0-1015 through the membership cache and ``ReplicaRouter`` (1 and 2
   replicas, a hot swap to phase 3's index), 7b ``LiveReplicaRouter``
   writes of the 8 held-out files and a compaction under traffic, 7c the
   cache over phase 6's RAMBO index;
8. the process fabric, from a gateway process of its own (``chip_smoke.py
   --fabric-gateway DIR``) that must never initialise CUDA: 7a's base saved
   as an 8 GiB snapshot, 2 worker processes each loading it onto the card
   (answers == the base's direct service), the held-out files written
   through ``insert`` (0/8 -> 8/8), a kill -9 of a worker and a
   compaction with its rolling restart under traffic (every future
   resolved, answers == phase 3's index), requests a second on 2 workers
   and then on 1, and each worker's ``query.locations`` time, peak device
   memory and kernel launches from its ``stats`` reply;
9. sharded archives: 9a ``build_sharded_archive`` of phase 3's archive into
   4 file shards, equal to phase 3's index word for word, saved as a shard
   set and served through ``ScatterGatherRouter`` in this process and with
   a process per shard (== the unsharded service), a killed shard process
   named in ``missing_files``, and the ``"sharded"`` service backend on
   the one-card mesh == ``"idl_probe"``; 9b phase 6's RAMBO index in 2
   word shards (``sharded_msmt`` and both routers == the unsharded index; a
   killed shard process fails every affected future with
   ``ShardDeadError``).

The phases run in the order 1, 2a-2f, 3, 7a, 7b, 9a (it needs phase 3's
index), 8 (it needs the card clear of this process's indexes), 4, 5, 5b,
6, 7c, 9b. Phases 8 and 9 print their temp root's free
bytes before they save (8 and 9a write 8 GiB snapshots; too little room
fails the run) and remove their snapshots, and print their wall seconds.

Every path phase zeroes the launch counters just before it and reads them
just after; each kernel the path runs must have launched (phases 8 and 9
add the launch counters of their worker and shard processes, read from
each one's ``stats`` reply). Then it prints
the kernels' JSON line (launches summed over the path phases), the
``nvidia-smi`` name and power limit, and last ``{"ok": true, "device":
{...}}``. It exits non-zero, printing no result, without a CUDA device,
without the port beside it, or when any build, launch or check fails.
"""

from __future__ import annotations

import contextlib
import functools
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

SRC = Path(__file__).resolve().parent / "src"

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
SECTOR = 32                    # bytes: the unit device memory moves
SERVE_BATCH = 256              # configs/idl_genesearch.py serve_p99 cell
SERVE_BATCHES = 8
INSERT_BATCH = 512             # build_archive chunk_reads
GENOME_LEN = 16_384
ARCHIVE_SEED = 11
FLAT_GENOME_LEN = 4_600_000    # one E. coli-sized genome
FLAT_READ_LEN = 230


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls (CUDA
    events), after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# device ms per kernel call from CUDA-graph replay (no host time between
# launches), printed beside the JSON line's CUDA-event times
GRAPH_MS: dict = {}


def graph_ms(fn, calls: int = 20, replays: int = 10) -> float:
    """Device time of one ``fn`` call: ``calls`` calls captured in one CUDA
    graph, replayed ``replays`` times and timed with CUDA events, so the
    wrapper's host work between launches is not in it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                     # warm-up off the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / (calls * replays)


L2_FLUSH_BYTES = 256 << 20    # five times the H100's 50 MB L2


def graph_ms_cold(fn, flush) -> float:
    """Device time of one ``fn`` call with the L2 cold: the CUDA-graph time
    of ``flush`` then ``fn``, less that of ``flush`` alone (``flush``
    writes ``L2_FLUSH_BYTES``, evicting what the last call left in L2)."""
    return graph_ms(lambda: (flush(), fn())) - graph_ms(flush)


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest |a - b| over the elements (0 when equal; NaN equals NaN)."""
    diff = ((a != b) & ~(torch.isnan(a) & torch.isnan(b))
            if a.is_floating_point() else a != b).nonzero(as_tuple=True)
    if diff[0].numel() == 0:
        return 0
    return float((a[diff].double() - b[diff].double()).abs().max())


def sector_bytes(first_word, n_words: int) -> int:
    """Bytes of the distinct 32-byte sectors covered by the ``n_words``-word
    spans (int32 words) that start at the word indices ``first_word``: the
    least device memory moves to read, or to write, each of them once."""
    first = np.asarray(first_word, dtype=np.int64).reshape(-1)
    if n_words % 8 == 0 and not (first % 8).any():
        return SECTOR * np.unique(first).size * (n_words // 8)
    spans = first[:, None] + np.arange(n_words)
    return SECTOR * np.unique(spans // 8).size


def valid_lanes(offsets: np.ndarray) -> np.ndarray:
    """Flat element indices of a plan's valid (non-pad) lanes."""
    return np.flatnonzero(offsets.reshape(-1) >= 0)


def genome_windows(archive, cfg, n: int):
    """The archive's first ``n`` read windows and their file ids, as
    ``build_archive`` batches them."""
    from repro_torch.data import genome

    windows, fids = [], []
    for f in archive:
        win = genome.window_reads(f.genome, cfg.read_len, cfg.k)
        windows.extend(win)
        fids.extend([f.file_id] * len(win))
        if len(windows) >= n:
            break
    return windows[:n], fids[:n]


def build_phase() -> tuple[str, int]:
    """Phase 1: the card, its power limit, and the kernels' nvcc build."""
    from repro_torch.kernels import build

    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = nvidia_smi()
    t0 = time.perf_counter()
    logs = build.build_all()
    build_s = time.perf_counter() - t0
    for name, log in logs.items():
        for line in log.splitlines():
            if any(s in line for s in ("registers", "spill", "smem", "stack")):
                print(f"  ptxas {name}: {line.split(':', 1)[-1].strip()}")
    print(f"phase 1 device+build: ok — {kind} x{count} ({smi}); "
          f"{len(logs)} kernels built in {build_s:.3f} s")
    return kind, count


def rand_matrix(n_rows: int, w: int, dev) -> torch.Tensor:
    return torch.empty((n_rows, w), dtype=torch.int32,
                       device=dev).random_(-2 ** 31, 2 ** 31)


def as_dev(dev, *arrays) -> list:
    return [torch.as_tensor(a, device=dev) for a in arrays]


def small_shapes_phase(dev) -> None:
    """Phase 2a: both kernels against their plain versions at W = 1 and 32.
    The gather: the AND over η in {1, 3, 4} with ragged n_k and the last
    row on its compact plan, a misaligned view (the 4-byte word path), an
    empty batch, and a run plan's rows put back into probe order. The
    insert: raw positions unsorted, with duplicates, masked ones and a word
    with all 32 bits set; the compact plan of the same positions (its
    counters equal the reference planner's); a run plan through its
    flattened lanes; an empty tensor."""
    from repro_torch.kernels.idl_insert import kernel as ins_kernel
    from repro_torch.kernels.idl_insert import ops as ins_ops
    from repro_torch.kernels.idl_insert import ref as ins_ref
    from repro_torch.kernels.idl_probe import kernel as probe_kernel
    from repro_torch.kernels.idl_probe import ops as probe_ops
    from repro_torch.kernels.idl_probe import ref as probe_ref

    rng = np.random.default_rng(0)
    small = []
    for w in (1, 32):
        matrix = rand_matrix(4096, w, dev)
        for eta in (1, 3, 4):
            rows = rng.integers(0, 4096, size=(3, eta, 97))
            rows[1] = np.sort(rng.integers(0, 128, size=(eta, 97)), axis=1)
            rows[2, :, 0] = 4095                        # the last row
            qplan = probe_ops.compact_probe_plan(torch.as_tensor(
                rows, device=dev), 64)
            got = probe_kernel.gather_planned_rows(matrix, qplan)
            want = probe_ref.gather_and_ref(matrix, qplan.rows)
            torch.cuda.synchronize()
            check(torch.equal(got, want),
                  f"gather W={w} η={eta} kernel == plain")
        view = rand_matrix(4096 * w + 1, 1, dev).reshape(-1)[1:].view(4096, w)
        check(view.data_ptr() % 16 == 4, "a misaligned view")
        got = probe_kernel.gather_planned_rows(view, qplan)
        empty = probe_kernel.gather_planned_rows(
            matrix, torch.empty((0, 4, 97), dtype=torch.int64, device=dev))
        rows = rng.integers(0, 4096, size=(3, 97))
        rows[1].sort()
        plan = probe_ops.plan_probe_runs(rows, block_bits=64,
                                         probes_per_run=128)
        check((plan.offsets < 0).any(), "gather plan has pad lanes")
        in_order = probe_ops.gather_planned_rows(matrix, plan)
        torch.cuda.synchronize()
        check(torch.equal(got, probe_ref.gather_and_ref(view, qplan.rows))
              and empty.shape == (0, 97, w) and torch.equal(
                  in_order, matrix[torch.as_tensor(rows.reshape(-1),
                                                   device=dev)]),
              f"gather W={w}: misaligned view, empty batch and run plan "
              f"== plain")
        flat = rng.integers(0, 4096 * w * 32, size=5000)
        flat[:100] = -1                                 # masked
        flat = np.concatenate([flat, np.arange(320, 352),   # one full word
                               np.repeat(flat[100:140], 3)])  # duplicates
        rng.shuffle(flat)
        positions = torch.as_tensor(flat, device=dev)
        want = ins_ref.insert_planned_ref(matrix.clone(), positions)
        ins_kernel.insert_planned(matrix, positions)
        torch.cuda.synchronize()
        check(torch.equal(matrix, want),
              f"insert W={w} kernel == plain (unsorted, duplicates)")
        block_bits = 64 * w * 32
        cplan = ins_ops.compact_insert_plan(positions, block_bits, 128)
        rplan = ins_ops.plan_insert_runs(flat, block_bits=block_bits,
                                         inserts_per_run=128)
        check((cplan.n_locs, cplan.n_runs, cplan.n_tiles, cplan.dma_bytes)
              == (rplan.n_locs, rplan.n_runs, rplan.n_tiles, rplan.dma_bytes)
              and np.array_equal(cplan.run_lengths(), rplan.run_lengths),
              f"compact plan W={w} == the reference planner's counters")
        for name, p in (("compact", cplan), ("run", rplan)):
            fresh = rand_matrix(4096, w, dev)
            want = ins_ref.insert_planned_ref(fresh.clone(), positions)
            ins_ops.insert_planned(fresh, p)
            torch.cuda.synchronize()
            check(torch.equal(fresh, want),
                  f"insert W={w} {name} plan kernel == plain")
        small.append(f"W={w}: gathers at η 1/3/4 and a {plan.n_runs}-run "
                     f"plan, {flat.size} insert positions ({cplan.n_locs} "
                     f"unique in {cplan.n_tiles} blocks, {cplan.n_runs} "
                     f"runs)")
    matrix = rand_matrix(64, 4, dev)
    before, launched = matrix.clone(), ins_kernel.launches
    ins_ops.insert_planned(matrix, None)
    ins_kernel.insert_planned(matrix, torch.empty(0, dtype=torch.int64,
                                                  device=dev))
    torch.cuda.synchronize()
    check(torch.equal(matrix, before) and ins_kernel.launches == launched,
          "an empty insert leaves the matrix and launches nothing")
    print(f"phase 2a small shapes: ok (kernel == plain, tolerance 0: "
          f"bit-exact) — {'; '.join(small)}; empty tensor ok")


def main_shapes_phase(cfg, archive, dev) -> list:
    """Phases 2b-2c: both kernels at the main path's shapes, against their
    plain versions and timed beside their byte bounds. Returns the kernels'
    JSON records."""
    from repro_torch.kernels.idl_insert import kernel as ins_kernel
    from repro_torch.kernels.idl_insert import ref as ins_ref
    from repro_torch.kernels.idl_probe import kernel as probe_kernel
    from repro_torch.kernels.idl_probe import ops as probe_ops
    from repro_torch.kernels.idl_probe import ref as probe_ref
    from repro_torch.serving import genesearch as gs

    rng = np.random.default_rng(0)
    shape = (cfg.m, cfg.file_words)
    w = shape[1]
    matrix = rand_matrix(*shape, dev)

    # gather at one serve batch: 256 reads x 200 kmers x η 4 probes, on the
    # compact plan the serve path builds
    qplan = gs.query_plan(cfg, SERVE_BATCH, shape, device=dev)
    reads = torch.as_tensor(
        rng.integers(0, 4, size=(SERVE_BATCH, cfg.read_len), dtype=np.uint8),
        device=dev)
    rows = qplan.locations(reads)                   # (B, η, n_k) int64
    torch.cuda.synchronize()
    plan_s = []
    for _ in range(6):                     # host wall, the first one warms
        t0 = time.perf_counter()
        gplan = probe_ops.compact_probe_plan(rows, qplan.rows_per_block,
                                             qplan.probes_per_run)
        plan_s.append(time.perf_counter() - t0)
    # the reference planner over the same rows, copied to the host once
    host_rows = rows.cpu().numpy()
    b, eta, n_k = host_rows.shape
    rplan = probe_ops.plan_probe_runs(host_rows.reshape(b * eta, n_k),
                                      block_bits=qplan.rows_per_block,
                                      probes_per_run=qplan.probes_per_run)
    check((gplan.n_runs, gplan.n_probes) == (rplan.n_runs, rplan.n_probes)
          and qplan.run_dma_bytes(gplan) == qplan.run_dma_bytes(rplan)
          and np.array_equal(gplan.run_lengths(), rplan.run_lengths),
          "compact probe plan == the reference planner's counters at the "
          "serve shape")

    def gather_kernel():
        return probe_kernel.gather_planned_rows(matrix, gplan)

    def gather_plain():
        return probe_ref.gather_and_ref(matrix, rows)

    probe_rows = rows.reshape(-1)

    def gather_library():
        return torch.index_select(matrix, 0, probe_rows)

    got, want = gather_kernel(), gather_plain()
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    check(err == 0, "gather kernel == plain at the main path's shapes")
    del got, want
    # the bound charges what the work needs: the row indices (8 B each,
    # read once), the distinct rows read and the answers written
    rows_read = torch.unique(probe_rows).cpu().numpy()
    g_bytes = (8 * probe_rows.numel() + sector_bytes(rows_read * w, w)
               + 4 * b * n_k * w)
    gather = {
        "name": probe_kernel.NAME, "route": "cuda",
        "source": probe_kernel.SOURCE, "replaces": probe_kernel.REPLACES,
        "max_abs_err": err,
        "ms": cuda_ms(gather_kernel, 50),
        "plain_ms": cuda_ms(gather_plain, 10),
        "bound_ms": 1e3 * g_bytes / HBM_BYTES_PER_S, "bound_by": "bytes",
        "library_ms": cuda_ms(gather_library, 50),
    }
    GRAPH_MS[probe_kernel.NAME] = graph_ms(gather_kernel)
    GRAPH_MS["torch.index_select"] = graph_ms(gather_library)
    # graph replay reads the same 26 MB of rows each call, which the 50 MB
    # L2 holds; the serve path meets them cold
    scratch = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32, device=dev)
    flush = functools.partial(scratch.fill_, 0)
    GRAPH_MS[probe_kernel.NAME + " (L2 cold)"] = graph_ms_cold(gather_kernel,
                                                               flush)
    GRAPH_MS["torch.index_select (L2 cold)"] = graph_ms_cold(gather_library,
                                                             flush)
    print(f"phase 2b gather at serve shapes: ok (max_abs_err {err}, "
          f"tolerance 0) — {gplan.n_probes} probes, {b * n_k} keys of η "
          f"{eta}, {rows_read.size} distinct rows; compact plan == the "
          f"reference planner's counters ({gplan.n_runs} runs of <= "
          f"{gplan.probes_per_run}, mean "
          f"{gplan.n_probes / gplan.n_runs:.4f} probes/run, rpb "
          f"{qplan.rows_per_block}); device_plan host wall ms "
          f"{[round(1e3 * t, 3) for t in plan_s]}; kernel (gather and AND "
          f"over η) {gather['ms']:.6f} ms (graph replay "
          f"{GRAPH_MS[probe_kernel.NAME]:.6f} ms, L2 cold "
          f"{GRAPH_MS[probe_kernel.NAME + ' (L2 cold)']:.6f} ms), plain "
          f"{gather['plain_ms']:.6f} ms, bound {gather['bound_ms']:.6f} ms "
          f"({g_bytes} B = 8 B x {probe_rows.numel()} row indices + rows "
          f"read + answers); yardstick index_select of the "
          f"{probe_rows.numel()} rows alone (the gather half, no AND) "
          f"{gather['library_ms']:.6f} ms (graph replay "
          f"{GRAPH_MS['torch.index_select']:.6f} ms, L2 cold "
          f"{GRAPH_MS['torch.index_select (L2 cold)']:.6f} ms)")
    del scratch, flush

    # insert at one build_archive chunk: the archive's first 512 windows,
    # on the compact operand the ingest path builds
    from repro_torch.kernels.idl_insert import ops as ins_ops

    windows, fids = genome_windows(archive, cfg, INSERT_BATCH)
    windows = torch.as_tensor(np.stack(windows), device=dev)
    fids = torch.as_tensor(np.asarray(fids), device=dev)
    iplan_q = gs.insert_plan(cfg, INSERT_BATCH, shape, device=dev)
    flat = iplan_q.flat_positions(windows, fids)
    torch.cuda.synchronize()
    plan_s = []
    for _ in range(6):                     # host wall, the first one warms
        t0 = time.perf_counter()
        cplan = ins_ops.compact_insert_plan(flat, iplan_q.block_bits,
                                            iplan_q.inserts_per_run)
        plan_s.append(time.perf_counter() - t0)
    positions = cplan.positions
    copy = matrix.clone()

    def insert_kernel():
        return ins_kernel.insert_planned(matrix, cplan)

    def insert_plain():
        return ins_ref.insert_planned_ref(copy, positions)

    insert_kernel()
    insert_plain()
    torch.cuda.synchronize()
    err = max_abs_err(matrix, copy)
    check(err == 0, "insert kernel == plain at the main path's shapes")
    # the bound charges the positions (8 B each, read once) and the touched
    # words' sectors, read and written
    pos = positions.cpu().numpy()
    words = np.unique(pos >> 5)
    sectors = sector_bytes(words, 1)
    i_bytes = 8 * pos.size + 2 * sectors
    insert = {
        "name": ins_kernel.NAME, "route": "cuda",
        "source": ins_kernel.SOURCE, "replaces": ins_kernel.REPLACES,
        "max_abs_err": err,
        "ms": cuda_ms(insert_kernel, 50),
        "plain_ms": cuda_ms(insert_plain, 10),
        "bound_ms": 1e3 * i_bytes / HBM_BYTES_PER_S, "bound_by": "bytes",
        "library_ms": None,
    }
    GRAPH_MS[ins_kernel.NAME] = graph_ms(insert_kernel)
    # a control for the bound's share: as many positions, one per 32-byte
    # sector as here, but the sectors consecutive instead of scattered
    step = min(256, matrix.numel() // pos.size * 32)    # bits per sector
    ordered = ins_ops.compact_insert_plan(
        torch.arange(pos.size, dtype=torch.int64, device=dev) * step,
        iplan_q.block_bits, iplan_q.inserts_per_run)
    ordered_ms = graph_ms(lambda: ins_kernel.insert_planned(matrix, ordered))
    sort_ms = cuda_ms(lambda: torch.sort(flat.reshape(-1)), 20)
    del copy
    print(f"phase 2c insert at build shapes: ok (max_abs_err {err}, "
          f"tolerance 0) — {flat.numel()} targets, {cplan.n_locs} unique "
          f"positions in {cplan.n_tiles} blocks ({cplan.n_runs} runs of <= "
          f"{cplan.inserts_per_run}), {words.size} words; kernel "
          f"{insert['ms']:.6f} ms (graph replay "
          f"{GRAPH_MS[ins_kernel.NAME]:.6f} ms), plain "
          f"{insert['plain_ms']:.6f} ms, bound {insert['bound_ms']:.6f} ms "
          f"({i_bytes} B = 8 B x {pos.size} positions + 2 x {sectors} B "
          f"of touched sectors); control, {pos.size} positions in "
          f"consecutive sectors: graph replay {ordered_ms:.6f} ms; "
          f"device_plan host wall ms "
          f"{[round(1e3 * t, 3) for t in plan_s]}; torch.sort of the "
          f"{flat.numel()} int64 targets {sort_ms:.6f} ms (CUDA events); "
          f"library: no single PyTorch call")
    return [gather, insert]


def _counters():
    """(name, module, attribute) of every kernel's launch counter."""
    from repro_torch.kernels.idl_insert import kernel as ins_kernel
    from repro_torch.kernels.idl_probe import kernel as probe_kernel
    from repro_torch.kernels.window_min import kernel as wm_kernel

    return [(probe_kernel.NAME, probe_kernel, "launches"),
            (ins_kernel.NAME, ins_kernel, "launches"),
            (wm_kernel.NAME, wm_kernel, "launches"),
            (probe_kernel.BITS_NAME, probe_kernel, "bits_launches"),
            (ins_kernel.ROUNDS_NAME, ins_kernel, "round_launches"),
            (probe_kernel.BIT_MODE_NAME, probe_kernel, "bit_mode_launches")]


def reset_launches() -> None:
    for _, mod, attr in _counters():
        setattr(mod, attr, 0)


def read_launches() -> dict:
    from repro_torch import kernels

    return kernels.launch_counts()


@contextlib.contextmanager
def counting_calls(module, name: str):
    """Count the calls of ``module.name`` while the block runs: yields a
    one-element list holding the count."""
    fn, calls = getattr(module, name), [0]

    def wrapper(*args, **kwargs):
        calls[0] += 1
        return fn(*args, **kwargs)

    setattr(module, name, wrapper)
    try:
        yield calls
    finally:
        setattr(module, name, fn)


def check_window_min_launches(launches: dict, stages: dict, extra: int,
                              path: str) -> int:
    """``window_min`` must launch once per MinHash: once for each timed
    ``locations`` stage (insert and query batches) and each of the path's
    ``extra`` direct location calls. Returns that count."""
    want = (stages["insert.locations"]["batches"]
            + stages["query.locations"]["batches"] + extra)
    check(launches["window_min"] == want,
          f"window_min launched {launches['window_min']} times on the "
          f"{path}, once per MinHash ({want})")
    return want


def stage_means(snap, ingest_s: float, batch_ms: list) -> dict:
    """Mean host ms per batch of each planner stage (the package's
    ``planner.stage_ms`` timers) and of whole batches."""
    from repro_torch.obs import metrics as obs_metrics

    stages = {}
    for key, hist in snap["hists"].get("planner.stage_ms", {}).items():
        labels = obs_metrics.parse_label_key(key)
        stages[f"{labels['op']}.{labels['stage']}"] = {
            "mean_ms": hist["sum"] / hist["count"], "batches": hist["count"]}
    n_ingest = stages["insert.launch"]["batches"]
    stages["insert.whole_batch"] = {
        "mean_ms": 1e3 * ingest_s / n_ingest, "batches": n_ingest}
    stages["query.whole_batch"] = {
        "mean_ms": sum(batch_ms) / len(batch_ms), "batches": len(batch_ms)}
    return stages


def main_path_phase(cfg, archive, dev) -> tuple:
    """Phase 3: ingest the archive and serve batches through the entry
    points a user calls, with the launch counters zeroed just before and
    read just after; then the mean host time of each planner stage over
    that run. Returns the launch counts and the index."""
    from repro_torch.index import BitSlicedIndex, build_archive
    from repro_torch.kernels.idl_insert import ops as ins_ops
    from repro_torch.kernels.idl_probe import ops as probe_ops
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.serving import GeneSearchService, ServiceConfig

    eng = BitSlicedIndex.build(cfg.idl_config(), cfg.scheme, cfg.n_files,
                               device=dev)
    obs_metrics.reset()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    with counting_calls(ins_ops, "plan_insert_runs") as planner:
        eng = build_archive(eng, archive, read_len=cfg.read_len,
                            chunk_reads=INSERT_BATCH, backend="idl_insert")
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    check(read_launches()["insert_planned"] > 0,
          "insert_planned launched during ingest")
    check(planner[0] == 0, "no numpy run planner on the CUDA ingest path")
    ingest_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()

    svc = GeneSearchService(eng, ServiceConfig(
        theta=1.0, max_batch=SERVE_BATCH, backend="idl_probe"))
    plain_svc = GeneSearchService(eng, ServiceConfig(
        theta=1.0, max_batch=SERVE_BATCH, backend="torch"))
    qrng = np.random.default_rng(0)
    correct = total = extra = 0
    batch_ms = []
    for r in range(SERVE_BATCHES):
        fids = qrng.integers(0, cfg.n_files, size=SERVE_BATCH)
        reads = [archive[int(f)].reads(cfg.read_len, 1)[0] for f in fids]
        t0 = time.perf_counter()
        with counting_calls(probe_ops, "plan_probe_runs") as qplanner:
            results = svc.search(reads)
        batch_ms.append(1e3 * (time.perf_counter() - t0))
        check(qplanner[0] == 0, f"no numpy probe planner on serve batch {r}")
        for fid, res in zip(fids, results):
            check(res.matches.shape == (cfg.n_files,), "verdict shape")
            hit = int(fid) in res.file_ids
            correct += hit
            extra += len(res.file_ids) - hit
            total += 1
        if r == 0:
            counts = read_launches()
            plain = plain_svc.search(reads)
            for name, mod, attr in _counters():
                # the plain backend's comparison run is not counted
                setattr(mod, attr, counts[name])
            check(all(np.array_equal(a.matches, b.matches)
                      for a, b in zip(results, plain)),
                  "idl_probe verdicts == torch verdicts on the first batch")
    serve_peak = torch.cuda.max_memory_allocated()
    launches = read_launches()
    for name in ("gather_planned_rows", "insert_planned", "window_min"):
        check(launches[name] > 0, f"{name} launched on the bit-sliced path")
    check(launches["gather_planned_rows"] == SERVE_BATCHES
          and launches["probe_planned_bits"] == 0
          and launches["gather_planned_bits"] == 0,
          "gather_planned_rows launched once per serve batch, "
          "probe_planned_bits and gather_planned_bits never")
    check(correct == total, f"recall {correct}/{total} is total")
    snap = obs_metrics.DEFAULT.snapshot()
    stages = stage_means(snap, ingest_s, batch_ms)
    minhashes = check_window_min_launches(launches, stages, 0,
                                          "bit-sliced path")
    tile_q = obs_metrics.counter_total(
        snap, "locality.planned_tile_bytes", {"op": "query"})
    tile_i = obs_metrics.counter_total(
        snap, "locality.planned_tile_bytes", {"op": "insert"})
    runs_i = obs_metrics.counter_total(
        snap, "locality.probe_runs", {"op": "insert"})
    print(f"phase 3 main path: ok — {cfg.m}x{cfg.file_words} int32 index "
          f"({eng.state.nbytes} B) over {cfg.n_files} files x {GENOME_LEN} "
          f"bases; ingest {ingest_s:.3f} s (numpy run planner calls "
          f"{planner[0]}; {runs_i:.0f} planner runs counted from the compact "
          f"plans); window_min once per MinHash ({minhashes}); serve "
          f"{SERVE_BATCHES} x "
          f"{SERVE_BATCH} reads, batch ms {[round(b, 3) for b in batch_ms]} "
          f"(numpy probe planner calls 0, one gather launch per batch); "
          f"launches {json.dumps(launches)}; recall {correct}/{total}; mean "
          f"extra matched files {extra / total:.4f}; first batch == torch "
          f"backend; max_memory_allocated ingest {ingest_peak} B, serve "
          f"{serve_peak} B; "
          f"locality.planned_tile_bytes query {tile_q:.0f} insert "
          f"{tile_i:.0f}")
    print("phase 3 where the time goes (host ms per batch, means over the "
          "main path's run): " + json.dumps(stages, sort_keys=True))
    return launches, eng


def window_min_phase(dev) -> dict:
    """Phase 2d: ``window_min`` against its plain version, bit for bit, at
    small shapes in its plain, DOPH, exact (η rows) and unsigned forms, and
    at the rolling MinHash's shapes, (256 | 512, 215) × η 4, in both forms
    the paths launch: the 32-bit path's DOPH lanes (timed beside its byte
    bound) and the 64-bit path's unsigned DOPH hashes, with the exact form
    signed beside ``unfold(-1, w, 1).amin(-1)`` on the same input (the same
    function) and unsigned; then the unsigned DOPH form over a whole
    genome's sub-kmers. Returns its JSON record (32-bit DOPH form at the
    serve shape, (256, 215))."""
    from repro_torch.kernels.window_min import kernel as wm_kernel
    from repro_torch.kernels.window_min import ref as wm_ref

    rng = np.random.default_rng(1)
    eta = 4
    cases = 0

    def same(a, w, what, **kw):
        got = wm_kernel.window_min(a, w, **kw)
        check(torch.equal(got, wm_ref.window_min_binned_ref(a, w=w, **kw)),
              f"window_min {what} {a.dtype} {tuple(a.shape)} w={w} == plain")
        return 1

    def bin3_empty(h, shift):
        """``h`` with every hash of DOPH bin 3 of 4 moved to bin 2."""
        top2 = 2 * shift - 2                     # bins of 4: the top bits
        return torch.where(wm_ref.doph_bins(h, eta, shift) == 3,
                           h ^ (1 << top2), h)

    lanes_doph = dict(n_bins=eta, bin_shift=16, fill=0xFFFFFFFF)
    u64_doph = dict(n_bins=eta, bin_shift=32, fill=-1, unsigned=True)
    for w in (1, 2, 16, 31):
        for n in (w, 200, 255, 1000, 1283):        # < and not a multiple of
            lanes = rng.integers(0, 1 << 32, size=(3, n))   # the 256 tile
            lanes[:, ::3] |= 1 << 31                         # bit 31 set
            h64 = rng.integers(-2 ** 63, 2 ** 63 - 1, size=(3, n),
                               dtype=np.int64)
            h64[:, ::4] = -1                                 # UINT64_MAX
            i32 = rng.integers(-2 ** 31, 2 ** 31, size=(2, n)).astype(np.int32)
            f32 = rng.normal(size=(2, n)).astype(np.float32)
            lanes, h64, i32, f32 = as_dev(dev, lanes, h64, i32, f32)
            for a in (lanes, h64, i32, f32):
                cases += same(a, w, "plain")
            cases += same(h64, w, "unsigned", unsigned=True)
            cases += same(bin3_empty(lanes, 16), w, "doph", **lanes_doph)
            cases += same(bin3_empty(h64, 32), w, "doph unsigned", **u64_doph)
            cases += same(torch.stack([h64, h64.flip(-1)], -2), w,
                          "exact unsigned", unsigned=True)
    torch.cuda.synchronize()
    timed = {}
    w = 16
    for rows in (SERVE_BATCH, INSERT_BATCH):
        n = 215
        h = torch.as_tensor(rng.integers(0, 1 << 32, size=(rows, n)),
                            device=dev)
        got = wm_kernel.window_min(h, w, **lanes_doph)
        err = max_abs_err(got, wm_ref.window_min_binned_ref(h, w=w,
                                                            **lanes_doph))
        h64 = torch.as_tensor(rng.integers(-2 ** 63, 2 ** 63 - 1, size=(
            rows, n), dtype=np.int64), device=dev)
        got64 = wm_kernel.window_min(h64, w, **u64_doph)
        err64 = max_abs_err(got64, wm_ref.window_min_binned_ref(
            h64, w=w, **u64_doph))
        stacked = torch.as_tensor(rng.integers(0, 1 << 32, size=(rows, eta, n)),
                                  device=dev)
        exact = wm_kernel.window_min(stacked, w)
        stacked64 = torch.as_tensor(rng.integers(
            -2 ** 63, 2 ** 63 - 1, size=(rows, eta, n), dtype=np.int64),
            device=dev)
        exact64 = wm_kernel.window_min(stacked64, w, unsigned=True)
        check(err == 0 and err64 == 0 and torch.equal(
            exact, stacked.unfold(-1, w, 1).amin(-1)) and torch.equal(
            exact64, wm_ref.window_min_binned_ref(stacked64, w=w,
                                                  unsigned=True)),
              f"window_min at ({rows}, 215) x η {eta} == plain (DOPH lanes, "
              f"DOPH unsigned 64-bit, exact, exact unsigned)")
        # the bound charges the hashes read once and the η minima written
        # once: the bins are a function of the hashes, derived in the kernel
        nbytes = h.numel() * 8 + got.numel() * 8
        timed[rows] = {
            "max_abs_err": err,
            "ms": cuda_ms(lambda: wm_kernel.window_min(h, w, **lanes_doph),
                          200),
            "plain_ms": cuda_ms(lambda: wm_ref.window_min_binned_ref(
                h, w=w, **lanes_doph), 50),
            "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S, "bound_by": "bytes",
            "library_ms": None,
            "graph_ms": graph_ms(
                lambda: wm_kernel.window_min(h, w, **lanes_doph)),
            "doph_u64_form": {
                "max_abs_err": err64,
                "graph_ms": graph_ms(
                    lambda: wm_kernel.window_min(h64, w, **u64_doph))},
            "exact_form": {
                "ms": cuda_ms(lambda: wm_kernel.window_min(stacked, w), 200),
                "graph_ms": graph_ms(
                    lambda: wm_kernel.window_min(stacked, w)),
                "unfold_amin_ms": cuda_ms(
                    lambda: stacked.unfold(-1, w, 1).amin(-1), 200),
                "unfold_amin_graph_ms": graph_ms(
                    lambda: stacked.unfold(-1, w, 1).amin(-1)),
                "bound_ms": 1e3 * 8 * (stacked.numel() + exact.numel())
                / HBM_BYTES_PER_S},
        }
    # one genome's sub-kmers, as phase 4's whole-genome locations see them
    genome_h = bin3_empty(torch.as_tensor(rng.integers(
        -2 ** 63, 2 ** 63 - 1, size=FLAT_GENOME_LEN, dtype=np.int64),
        device=dev), 32)
    cases += same(genome_h, w, "doph unsigned, a whole genome", **u64_doph)
    print(f"phase 2d window_min: ok (kernel == plain, tolerance 0: "
          f"bit-exact) — {cases} small and whole-genome cases (w 1/2/16/31; "
          f"plain int64 lanes with bit 31 set, sign-flipped 64-bit, int32, "
          f"float32; unsigned int64; DOPH lanes and unsigned 64-bit with an "
          f"empty bin; exact unsigned; unsigned 64-bit DOPH over "
          f"{FLAT_GENOME_LEN} hashes); one launch per MinHash at (rows, 215) "
          f"int64, w 16, η {eta} (DOPH lanes, timed, and unsigned 64-bit "
          f"hashes; exact form beside unfold(-1, w, 1).amin(-1) on the same "
          f"(rows, η, 215) input, and unsigned): "
          + json.dumps({f"({r}, 215)": t for r, t in timed.items()}))
    GRAPH_MS[wm_kernel.NAME] = timed[SERVE_BATCH].pop("graph_ms")
    GRAPH_MS["unfold.amin"] = timed[SERVE_BATCH]["exact_form"][
        "unfold_amin_graph_ms"]
    timed[SERVE_BATCH].pop("exact_form")
    timed[SERVE_BATCH].pop("doph_u64_form")
    return {"name": wm_kernel.NAME, "route": "cuda",
            "source": wm_kernel.SOURCE, "replaces": wm_kernel.REPLACES,
            **timed[SERVE_BATCH]}


def flat_config():
    """The flat filter's configuration: the reference's default widths
    (k 31, t 16, L 2^15 bits, η 4, doph, align) at m = 2^32 bits, the
    largest filter uint32 locations address."""
    from repro_torch.core import idl

    return idl.IDLConfig(k=31, t=16, L=1 << 15, eta=4, m=1 << 32)


def flat_kernels_phase(cfg, g, dev) -> list:
    """Phase 2e: ``probe_planned_bits`` and ``insert_with_plan`` against
    their plain versions at the flat filter's shapes, timed beside their
    byte bounds (charged by the 32-byte sectors the work needs). Returns
    their JSON records."""
    from repro_torch.data import genome
    from repro_torch.index import packed
    from repro_torch.kernels.idl_insert import kernel as ins_kernel
    from repro_torch.kernels.idl_insert import ops as ins_ops
    from repro_torch.kernels.idl_insert import ref as ins_ref
    from repro_torch.kernels.idl_probe import kernel as probe_kernel
    from repro_torch.kernels.idl_probe import ops as probe_ops
    from repro_torch.kernels.idl_probe import ref as probe_ref

    bw = cfg.L // 32
    words = torch.empty(cfg.m // 32, dtype=torch.int32,
                        device=dev).random_(-2 ** 31, 2 ** 31)
    reads = torch.as_tensor(genome.extract_reads(g, FLAT_READ_LEN,
                                                 SERVE_BATCH, seed=7),
                            device=dev)
    locs = packed.batch_locations(cfg, reads, "idl")      # (B, η, n_k)
    torch.cuda.synchronize()
    plan_s = []
    for _ in range(6):                     # host wall, the first one warms
        t0 = time.perf_counter()
        plan = probe_ops.compact_probe_plan(locs, cfg.L)
        plan_s.append(time.perf_counter() - t0)
    # the reference planner over the same locations, copied to the host once
    host_locs = locs.cpu().numpy()
    b, eta, n_k = host_locs.shape
    rplan = probe_ops.plan_probe_runs(host_locs.reshape(b * eta, n_k), cfg.L)
    check((plan.n_runs, plan.n_probes) == (rplan.n_runs, rplan.n_probes)
          and np.array_equal(plan.run_lengths(), rplan.run_lengths),
          "compact probe plan == the reference planner's counters at the "
          "flat filter's shapes")

    def probe_kernel_call():
        return probe_kernel.probe_planned_bits(words, plan)

    def probe_plain():
        return probe_ref.probe_bits_and_ref(words, locs)

    got, want = probe_kernel_call(), probe_plain()
    direct = torch.stack([probe_ref.query_membership_ref(words, locs[i])
                          for i in range(b)])
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    check(err == 0 and torch.equal(got == 1, direct),
          "probe_planned_bits == plain at the flat filter's shapes")
    # the bound charges the locations (8 B each, read once), the distinct
    # sectors of the words they read and the answers written
    read_words = np.unique(host_locs >> 5)
    p_bytes = (8 * host_locs.size + sector_bytes(read_words, 1)
               + 4 * b * n_k)
    probe = {
        "name": probe_kernel.BITS_NAME, "route": "cuda",
        "source": probe_kernel.BITS_SOURCE,
        "replaces": probe_kernel.BITS_REPLACES, "max_abs_err": err,
        "ms": cuda_ms(probe_kernel_call, 100),
        "plain_ms": cuda_ms(probe_plain, 20),
        "bound_ms": 1e3 * p_bytes / HBM_BYTES_PER_S, "bound_by": "bytes",
        "library_ms": None,
    }
    GRAPH_MS[probe_kernel.BITS_NAME] = graph_ms(probe_kernel_call)
    scratch = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32, device=dev)
    GRAPH_MS[probe_kernel.BITS_NAME + " (L2 cold)"] = graph_ms_cold(
        probe_kernel_call, functools.partial(scratch.fill_, 0))
    del scratch
    print(f"phase 2e probe_planned_bits at serve shapes: ok (max_abs_err "
          f"{err}, tolerance 0) — {plan.n_probes} probes, {b * n_k} keys of "
          f"η {eta}, {read_words.size} distinct words in "
          f"{sector_bytes(read_words, 1) // SECTOR} sectors; compact plan == "
          f"the reference planner's counters ({plan.n_runs} runs, mean "
          f"{plan.n_probes / plan.n_runs:.4f} probes/run); device_plan host "
          f"wall ms {[round(1e3 * t, 3) for t in plan_s]}; kernel (bits and "
          f"AND over η) {probe['ms']:.6f} ms (graph replay "
          f"{GRAPH_MS[probe_kernel.BITS_NAME]:.6f} ms, L2 cold "
          f"{GRAPH_MS[probe_kernel.BITS_NAME + ' (L2 cold)']:.6f} ms), plain "
          f"{probe['plain_ms']:.6f} ms, bound {probe['bound_ms']:.6f} ms "
          f"({p_bytes} B); library: no single PyTorch call")

    # a rounds plan: one insert batch's locations plus one block that
    # appears in several rounds
    batch = torch.as_tensor(genome.window_reads(g, FLAT_READ_LEN, cfg.k)
                            [:INSERT_BATCH], device=dev)
    ilocs = packed.batch_locations(cfg, batch, "idl").cpu().numpy()
    hot = np.random.default_rng(2).integers(0, cfg.L, size=(1, 500))
    ilocs = np.concatenate([ilocs.reshape(cfg.eta, -1),
                            np.repeat(hot + 5 * cfg.L, cfg.eta, 0)], axis=1)
    iplan = ins_ops.plan_insert_rounds(ilocs, cfg.L)
    rounds_of_hot = sum(int((b == 5).any()) for b, _ in iplan.rounds)
    check(rounds_of_hot > 1, "one block appears in several insert rounds")
    rbids = np.concatenate([b for b, _ in iplan.rounds])
    roffs = np.concatenate([o for _, o in iplan.rounds])
    starts = tuple(int(x) for x in np.cumsum(
        [0] + [b.shape[0] for b, _ in iplan.rounds[:-1]]))
    ibids, ioffs = as_dev(dev, rbids, roffs)
    copy = words.clone()

    def rounds_kernel():
        return ins_kernel.insert_rounds(words, ibids, ioffs, block_words=bw,
                                        round_starts=starts)

    def rounds_plain():
        bounds = list(starts) + [len(rbids)]
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            tiles = ins_ref.insert_round_ref(
                copy, ibids[lo:hi], ioffs[lo:hi], block_words=bw,
                inserts_per_round=iplan.inserts_per_round)
            ins_ref.apply_insert_to_words(copy, ibids[lo:hi], tiles, bw)
        return copy

    rounds_kernel()
    rounds_plain()
    torch.cuda.synchronize()
    err = max_abs_err(words, copy)
    check(err == 0, "insert_with_plan == plain at the flat filter's shapes")
    valid = roffs >= 0
    touched = np.unique((rbids.astype(np.int64)[:, None] * bw
                         + (roffs >> 5))[valid])
    i_bytes = (sector_bytes(np.arange(len(rbids)), 1)
               + sector_bytes(valid_lanes(roffs), 1)
               + 2 * sector_bytes(touched, 1))
    rounds = {
        "name": ins_kernel.ROUNDS_NAME, "route": "cuda",
        "source": ins_kernel.SOURCE, "replaces": ins_kernel.ROUNDS_REPLACES,
        "max_abs_err": err,
        "ms": cuda_ms(rounds_kernel, 100),
        "plain_ms": cuda_ms(rounds_plain, 5),
        "bound_ms": 1e3 * i_bytes / HBM_BYTES_PER_S, "bound_by": "bytes",
        "library_ms": None,
    }
    # the wrapper flattens the lanes (the mask's count) and reads their
    # largest position from the device, so the host waits twice and a CUDA
    # graph cannot hold it: the graph replays the kernel's launch alone over
    # the flattened lanes, and the flattening is timed apart
    lanes_pos = ins_kernel.lane_positions(ibids, ioffs, cfg.L)
    GRAPH_MS[ins_kernel.ROUNDS_NAME] = graph_ms(
        lambda: ins_kernel._launch(ins_kernel.ROUNDS_NAME, words, lanes_pos))
    flatten_ms = cuda_ms(
        lambda: ins_kernel.lane_positions(ibids, ioffs, cfg.L), 20)
    print(f"phase 2e insert_with_plan at build shapes: ok (max_abs_err "
          f"{err}, tolerance 0) — {iplan.n_locs} locations in "
          f"{len(iplan.rounds)} rounds of {len(rbids)} runs (block 5 in "
          f"{rounds_of_hot} rounds), {lanes_pos.numel()} valid lanes, "
          f"{touched.size} words; kernel (shared insert_planned.cu, one "
          f"launch for all rounds over their valid lanes, flattened on the "
          f"device) {rounds['ms']:.6f} ms with the wrapper (graph replay of "
          f"the launch alone {GRAPH_MS[ins_kernel.ROUNDS_NAME]:.6f} ms; the "
          f"flattening {flatten_ms:.6f} ms, CUDA events), plain (round by "
          f"round) {rounds['plain_ms']:.6f} ms, bound "
          f"{rounds['bound_ms']:.6f} ms ({i_bytes} B; the padded offsets hold "
          f"{roffs.nbytes} B, not charged); library: no single PyTorch call")
    return [probe, rounds]


def flat_path_phase(cfg, g, dev) -> dict:
    """Phase 4: the flat IDL Bloom filter at full width, driven through the
    entry points a user calls, with the launch counters zeroed just before
    and read just after. Returns the launch counts."""
    from repro_torch.core import idl
    from repro_torch.data import genome
    from repro_torch.index import PackedBloomIndex, build_archive, packed
    from repro_torch.kernels.idl_insert import ops as ins_ops
    from repro_torch.kernels.idl_probe import ops as probe_ops
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.serving import GeneSearchService, ServiceConfig

    obs_metrics.reset()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    eng = PackedBloomIndex.build(cfg, "idl", device=dev)
    t0 = time.perf_counter()
    with counting_calls(ins_ops, "plan_insert_runs") as planner:
        eng = build_archive(eng, [(0, g)], read_len=FLAT_READ_LEN,
                            chunk_reads=INSERT_BATCH, backend="idl_insert")
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    check(planner[0] == 0, "no numpy run planner on the CUDA ingest path")

    # the legacy path: the whole genome's locations, planned in rounds
    t0 = time.perf_counter()
    locs = idl.idl_locations_rolling(cfg, torch.as_tensor(g, device=dev))
    locs = locs.cpu().numpy()
    t1 = time.perf_counter()
    plan = ins_ops.plan_insert_rounds(locs, cfg.L)
    t2 = time.perf_counter()
    legacy = torch.zeros_like(eng.words)
    ins_ops.insert_with_plan(legacy, plan)
    torch.cuda.synchronize()
    legacy_s = (t1 - t0, t2 - t1, time.perf_counter() - t2)
    check(torch.equal(legacy, eng.words),
          "insert_with_plan filter == build_archive filter, word for word")
    del legacy, locs

    reads = genome.extract_reads(g, FLAT_READ_LEN,
                                 SERVE_BATCHES * SERVE_BATCH, seed=1)
    ingest_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    batch_ms, n_runs, n_probes, queries = [], 0, 0, 0
    with counting_calls(probe_ops, "plan_probe_runs") as qplanner:
        for r in range(SERVE_BATCHES):
            batch = reads[r * SERVE_BATCH:(r + 1) * SERVE_BATCH]
            t0 = time.perf_counter()
            verdict = eng.msmt(batch, backend="idl_probe")
            check(bool(verdict.all()),
                  f"every genuine read of batch {r} matches")
            batch_ms.append(1e3 * (time.perf_counter() - t0))
            per_kmer = eng.query_batch(batch, backend="idl_probe")
            blocs = packed.batch_locations(
                cfg, torch.as_tensor(batch, device=dev), "idl")
            blocs = blocs.transpose(0, 1).reshape(cfg.eta, -1)
            cplan = probe_ops.compact_probe_plan(blocs, cfg.L)
            member = probe_ops.probe_membership(eng.words, cplan)
            n_runs += cplan.n_runs
            n_probes += cplan.n_probes
            queries += 3
            check(torch.equal(member.view(per_kmer.shape), per_kmer),
                  f"probe_membership of the compact plan == query_batch on "
                  f"batch {r}")
        poisoned = genome.poison_queries(reads[:SERVE_BATCH], seed=2)
        n_false = int((~eng.msmt(poisoned, backend="idl_probe")).sum())
        svc = GeneSearchService(eng, ServiceConfig(
            theta=1.0, max_batch=SERVE_BATCH, backend="idl_probe"))
        results = svc.search(list(reads[:SERVE_BATCH]))
        queries += 2
    torch.cuda.synchronize()
    serve_peak = torch.cuda.max_memory_allocated()
    launches = read_launches()
    check(qplanner[0] == 0, "no numpy probe planner on the flat serve path")
    check(all(r.file_ids == (0,) for r in results),
          "the service finds every genuine read of one batch")
    # the reference's run plan of the last batch, through probe_membership
    bplan = probe_ops.plan_probe_runs(blocs.cpu().numpy(), cfg.L)
    check((bplan.n_runs, bplan.n_probes) == (cplan.n_runs, cplan.n_probes)
          and torch.equal(probe_ops.probe_membership(eng.words, bplan)
                          .view(per_kmer.shape), per_kmer),
          "probe_membership of the reference's run plan == query_batch")
    for name, count in launches.items():
        if name not in ("gather_planned_rows", "gather_planned_bits"):
            check(count > 0, f"{name} launched on the flat-filter path")
    check(launches["probe_planned_bits"] == queries
          and launches["gather_planned_rows"] == 0
          and launches["gather_planned_bits"] == 0,
          f"probe_planned_bits launched once per flat query ({queries}), "
          f"gather_planned_rows and gather_planned_bits never")
    snap = obs_metrics.DEFAULT.snapshot()
    stages = stage_means(snap, ingest_s, batch_ms)
    # direct location calls: the legacy path's and each batch's probe plan
    minhashes = check_window_min_launches(launches, stages,
                                          1 + SERVE_BATCHES, "flat path")
    runs = {op: (obs_metrics.counter_total(snap, "locality.probe_runs",
                                           {"op": op}),
                 obs_metrics.counter_total(snap, "locality.probes",
                                           {"op": op}))
            for op in ("insert", "query")}
    print(f"phase 4 flat IDL Bloom filter: ok — m {cfg.m} bits "
          f"({eng.state.nbytes} B), L {cfg.L}, η {cfg.eta}, k {cfg.k}, t "
          f"{cfg.t}; genome {len(g)} bases (uncut); ingest {ingest_s:.3f} s "
          f"in batches of {INSERT_BATCH} reads (numpy run planner calls "
          f"{planner[0]}); window_min once per MinHash ({minhashes}); legacy "
          f"path: locations {legacy_s[0]:.3f} s, plan_insert_rounds "
          f"{legacy_s[1]:.3f} s ({len(plan.rounds)} rounds, {plan.n_tiles} "
          f"runs, {plan.n_locs} locations), insert_with_plan "
          f"{legacy_s[2]:.3f} s; "
          f"filters equal word for word; fill "
          f"{float(eng.fill_fraction):.6f}; serve {SERVE_BATCHES} x "
          f"{SERVE_BATCH} reads, msmt batch ms "
          f"{[round(b, 3) for b in batch_ms]}, all true (numpy probe "
          f"planner calls 0; probe_planned_bits once per query, {queries}); "
          f"probe_membership of the compact plan == query_batch on every "
          f"batch, and of the reference's run plan on the last; IDL probe "
          f"plans {n_runs} runs for {n_probes} probes (mean "
          f"{n_probes / n_runs:.4f} probes/run); "
          f"poisoned reads false {n_false}/{SERVE_BATCH}; service batch "
          f"all matched; planner runs/probes insert "
          f"{runs['insert'][0]:.0f}/{runs['insert'][1]:.0f} query "
          f"{runs['query'][0]:.0f}/{runs['query'][1]:.0f}; launches "
          f"{json.dumps(launches)}; max_memory_allocated ingest and legacy "
          f"{ingest_peak} B, serve {serve_peak} B")
    print("phase 4 where the time goes (host ms per batch, means over the "
          "flat path's run; the query stages also time the query_batch "
          "checks): " + json.dumps(stages, sort_keys=True))
    return launches


# -- phases 2f, 5 and 6: COBS and RAMBO at full width ------------------------

ARCHIVE_MIN, ARCHIVE_MAX = 4_096, 262_144   # genome lengths, log-uniform
RAMBO_M = 1 << 25                           # bits per RAMBO bucket filter
OVERLAP_STARTS = 16                         # the dedup batch's start points


def engine_config(cfg, m: int):
    """``full_config``'s IDLConfig (k 31, t 16, L 2^17, η 4) at ``m``."""
    import dataclasses

    return dataclasses.replace(cfg.idl_config(), m=m)


def log_uniform_archive(n_files: int, seed: int) -> list:
    """``(file_id, codes)`` genomes whose lengths are log-uniform in
    [ARCHIVE_MIN, ARCHIVE_MAX] bases, made from ``seed``."""
    from repro_torch.data import genome

    rng = np.random.default_rng(seed)
    lens = np.exp(rng.uniform(np.log(ARCHIVE_MIN), np.log(ARCHIVE_MAX),
                              size=n_files)).astype(np.int64)
    return [(fid, genome.synthesize_genome(int(n), seed=seed * 10_000 + fid))
            for fid, n in enumerate(lens)]


def cobs_sizes(archive, k: int) -> list:
    """Each file's kmer count, what ``CobsIndex.build`` groups by."""
    return [len(codes) - k + 1 for _, codes in archive]


def timed(fn, flush) -> dict:
    """CUDA events, CUDA-graph replay and graph replay with the L2 cold of
    one ``fn`` call."""
    return {"ms": cuda_ms(fn, 20), "graph_ms": graph_ms(fn, 10, 5),
            "cold_ms": graph_ms_cold(fn, flush)}


def wide_kernels_phase(cfg, archive, dev) -> list:
    """Phase 2f: the gather's bit mode at the RAMBO serve shape (kernel ==
    plain, tolerance 0; also at η 1/3/4, on a misaligned view and on an
    empty batch), the ``probe_planned_bits`` it replaces there ("before"),
    both across row widths (where the route switches), and
    ``gather_planned_rows`` at a COBS group's W = 16; each timed by events,
    graph replay and with the L2 cold, beside its byte bound and
    ``index_select`` of the same rows. Returns the bit mode's JSON
    record."""
    from repro_torch.data import genome
    from repro_torch.index import query
    from repro_torch.kernels.idl_probe import kernel as probe_kernel
    from repro_torch.kernels.idl_probe import ops as probe_ops
    from repro_torch.kernels.idl_probe import ref as probe_ref

    rng = np.random.default_rng(5)
    scratch = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32, device=dev)
    flush = functools.partial(scratch.fill_, 0)
    reads = torch.as_tensor(np.stack([
        genome.extract_reads(archive[int(f)][1], cfg.read_len, 1,
                             seed=int(f))[0]
        for f in rng.integers(0, len(archive), size=SERVE_BATCH)]),
        device=dev)

    # the bit mode at RAMBO's serve shape: (m/32, R·B) = (2^20, 320)
    rcfg = engine_config(cfg, RAMBO_M)
    shape = (RAMBO_M // 32, 320)
    matrix = rand_matrix(*shape, dev)
    qplan = query.plan_query(rcfg, "idl", tuple(reads.shape), shape,
                             bit_probe=True, device=dev)
    locs = qplan.locations(reads)                      # (B, η, n_k) int64
    plan = probe_ops.compact_probe_plan(locs, 32 * qplan.rows_per_block,
                                        qplan.probes_per_run)

    def bits_kernel():
        return probe_kernel.gather_planned_bits(matrix, plan)

    def bits_plain():
        return probe_ref.gather_bits_and_ref(matrix, locs)

    def bits_before():
        return probe_kernel.probe_planned_bits(matrix, plan)

    rows_flat = (locs >> 5).reshape(-1)

    def bits_library():
        return torch.index_select(matrix, 0, rows_flat)

    got, want, before = bits_kernel(), bits_plain(), bits_before()
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    check(err == 0 and torch.equal(before, want),
          "gather_planned_bits == plain == probe_planned_bits at the RAMBO "
          "serve shape")
    del got, want, before
    b, eta, n_k = locs.shape
    rows_read = torch.unique(rows_flat).cpu().numpy()
    w = shape[1]
    b_bytes = (8 * locs.numel() + sector_bytes(rows_read * w, w)
               + 4 * b * n_k * w)
    t_kernel, t_before = timed(bits_kernel, flush), timed(bits_before, flush)
    t_library = timed(bits_library, flush)
    record = {
        "name": probe_kernel.BIT_MODE_NAME, "route": "cuda",
        "source": probe_kernel.SOURCE, "replaces": probe_kernel.REPLACES,
        "max_abs_err": err, "ms": t_kernel["ms"],
        "plain_ms": cuda_ms(bits_plain, 5),
        "bound_ms": 1e3 * b_bytes / HBM_BYTES_PER_S, "bound_by": "bytes",
        "library_ms": t_library["ms"],
    }
    GRAPH_MS[probe_kernel.BIT_MODE_NAME] = t_kernel["graph_ms"]
    GRAPH_MS[probe_kernel.BIT_MODE_NAME + " (L2 cold)"] = t_kernel["cold_ms"]

    # η 1/3/4, a misaligned view (4-byte words), an empty batch
    small = rand_matrix(4096, w, dev)
    for e in (1, 3, 4):
        sl = torch.as_tensor(rng.integers(0, 32 * 4096, size=(3, e, 97)),
                             device=dev)
        sl[2, :, 0] = 32 * 4096 - 1                   # the last bit
        check(torch.equal(probe_kernel.gather_planned_bits(small, sl),
                          probe_ref.gather_bits_and_ref(small, sl)),
              f"gather_planned_bits η={e} == plain")
    view = rand_matrix(4096 * w + 1, 1, dev).reshape(-1)[1:].view(4096, w)
    check(view.data_ptr() % 16 == 4, "a misaligned view")
    check(torch.equal(probe_kernel.gather_planned_bits(view, sl),
                      probe_ref.gather_bits_and_ref(view, sl)),
          "gather_planned_bits on a misaligned view == plain")
    empty = probe_kernel.gather_planned_bits(
        small, torch.empty((0, 4, 97), dtype=torch.int64, device=dev))
    check(empty.shape == (0, 97, w), "an empty batch")
    del small, view

    # where the route switches: both bit kernels on (2^20, W) matrices
    widths = {}
    for wd in (1, 2, 4, 8, 16, 32, 64):
        mat = rand_matrix(shape[0], wd, dev)
        a = probe_kernel.gather_planned_bits(mat, plan)
        check(torch.equal(a, probe_kernel.probe_planned_bits(mat, plan)),
              f"both bit kernels agree at W={wd}")
        widths[wd] = {
            "gather_planned_bits": graph_ms(
                lambda: probe_kernel.gather_planned_bits(mat, plan)),
            "probe_planned_bits": graph_ms(
                lambda: probe_kernel.probe_planned_bits(mat, plan))}
    del mat, matrix
    torch.cuda.empty_cache()

    # gather_planned_rows at a COBS group's shape: the larger group of the
    # archive's two, W = 16
    from repro_torch.index import CobsIndex

    groups = CobsIndex.build(cobs_sizes(archive, cfg.k), cfg.idl_config(),
                             "idl", 10.0, 2, device="meta").groups
    gcfg = max(groups, key=lambda g: g.cfg.m).cfg
    cshape = (gcfg.m, 16)
    cmat = rand_matrix(*cshape, dev)
    cplan_q = query.plan_query(gcfg, "idl", tuple(reads.shape), cshape,
                               bit_probe=False, device=dev)
    crows = cplan_q.locations(reads)
    cplan = probe_ops.compact_probe_plan(crows, cplan_q.rows_per_block,
                                         cplan_q.probes_per_run)
    got = probe_kernel.gather_planned_rows(cmat, cplan)
    check(max_abs_err(got, probe_ref.gather_and_ref(cmat, crows)) == 0,
          "gather_planned_rows == plain at a COBS group's shape")
    crows_flat = crows.reshape(-1)
    c_read = torch.unique(crows_flat).cpu().numpy()
    c_bytes = (8 * crows.numel() + sector_bytes(c_read * 16, 16)
               + 4 * b * n_k * 16)
    t_cobs = timed(lambda: probe_kernel.gather_planned_rows(cmat, cplan),
                   flush)
    t_cobs_lib = timed(lambda: torch.index_select(cmat, 0, crows_flat),
                       flush)
    GRAPH_MS["gather_planned_rows (COBS W=16)"] = t_cobs["graph_ms"]
    del cmat, scratch, flush
    torch.cuda.empty_cache()
    print(f"phase 2f wide rows: ok (kernel == plain, tolerance 0: bit-exact)"
          f" — bit mode at the RAMBO serve shape ({shape[0]} x {w} int32, "
          f"{plan.n_probes} probes, {b * n_k} keys of η {eta}, "
          f"{rows_read.size} distinct rows of {4 * w} B; max_abs_err {err}): "
          f"kernel {json.dumps(t_kernel)}, bound {record['bound_ms']:.6f} ms "
          f"({b_bytes} B = 8 B x {locs.numel()} locations + distinct rows + "
          f"answers), plain {record['plain_ms']:.6f} ms; before, "
          f"probe_planned_bits at this shape {json.dumps(t_before)}; "
          f"yardstick index_select of the {rows_flat.numel()} rows alone (no "
          f"shift or AND) {json.dumps(t_library)}; η 1/3/4, misaligned view "
          f"and empty batch == plain; graph ms by row width W (same "
          f"locations, (2^20, W) matrices): {json.dumps(widths)}; "
          f"gather_planned_rows at a COBS group ({cshape[0]} x 16, "
          f"{c_read.size} distinct rows): {json.dumps(t_cobs)}, bound "
          f"{1e3 * c_bytes / HBM_BYTES_PER_S:.6f} ms ({c_bytes} B), "
          f"index_select {json.dumps(t_cobs_lib)}")
    return [record]


def serve_checks(eng, archive, cfg, per_query: int) -> dict:
    """Serve ``SERVE_BATCHES`` batches of 256 genuine reads through
    ``GeneSearchService(backend="idl_probe")`` at θ = 1 (recall total, the
    first batch == the ``"torch"`` backend, whose run is not counted), 256
    random reads (their extra matches), and one batch of overlapping reads
    from ``OVERLAP_STARTS`` start points of one file through ``msmt`` with
    and without dedup (equal). Returns the counts the caller checks."""
    from repro_torch.data import genome
    from repro_torch.index import query
    from repro_torch.kernels.idl_probe import ops as probe_ops
    from repro_torch.serving import GeneSearchService, ServiceConfig

    svc = GeneSearchService(eng, ServiceConfig(
        theta=1.0, max_batch=SERVE_BATCH, backend="idl_probe"))
    plain_svc = GeneSearchService(eng, ServiceConfig(
        theta=1.0, max_batch=SERVE_BATCH, backend="torch"))
    qrng = np.random.default_rng(0)
    correct = total = extra = queries = 0
    batch_ms = []
    with counting_calls(probe_ops, "plan_probe_runs") as qplanner:
        for r in range(SERVE_BATCHES):
            fids = qrng.integers(0, len(archive), size=SERVE_BATCH)
            reads = [genome.extract_reads(archive[int(f)][1], cfg.read_len,
                                          1, seed=1000 * r + i)[0]
                     for i, f in enumerate(fids)]
            t0 = time.perf_counter()
            results = svc.search(reads)
            batch_ms.append(1e3 * (time.perf_counter() - t0))
            queries += 1
            for fid, res in zip(fids, results):
                check(res.matches.shape == (len(archive),), "verdict shape")
                hit = int(fid) in res.file_ids
                correct += hit
                extra += len(res.file_ids) - hit
                total += 1
            if r == 0:
                counts = read_launches()
                plain = plain_svc.search(reads)
                for name, mod, attr in _counters():
                    setattr(mod, attr, counts[name])
                check(all(np.array_equal(a.matches, b.matches)
                          for a, b in zip(results, plain)),
                      "idl_probe verdicts == torch verdicts on the first "
                      "batch")
        random_reads = list(qrng.integers(0, 4, size=(SERVE_BATCH,
                                                      cfg.read_len),
                                          dtype=np.uint8))
        random_extra = sum(len(res.file_ids)
                           for res in svc.search(random_reads))
        queries += 1
        codes = archive[int(qrng.integers(0, len(archive)))][1]
        starts = qrng.integers(0, len(codes) - cfg.read_len,
                               size=OVERLAP_STARTS)
        overlap = np.stack([codes[s:s + cfg.read_len] for s in
                            qrng.choice(starts, size=SERVE_BATCH)])
        naive = eng.msmt(overlap, backend="idl_probe")
        dedup = eng.msmt(overlap, backend="idl_probe", dedup=True)
        queries += 2
        check(torch.equal(naive, dedup) and bool(naive.any(dim=1).all()),
              "msmt with dedup == without, every overlapping read matched")
    check(qplanner[0] == 0, "no numpy probe planner while serving")
    check(correct == total, f"recall {correct}/{total} is total")
    uniq, _, (b, n_k) = query.factor_unique_kmers(overlap, cfg.k)
    return {"correct": correct, "total": total, "extra": extra,
            "random_extra": random_extra, "batch_ms": batch_ms,
            "probe_launches": per_query * queries,
            "dedup_kmers": (len(uniq), b * n_k),
            # dedup's locality sort hashes the distinct kmers once more
            "extra_minhashes": per_query}


def engine_path_phase(label: str, eng, archive, cfg, *, probe: str,
                      per_query: int, held_out: bool) -> tuple:
    """Phases 5 and 6: ingest the archive through ``build_archive(backend=
    "idl_insert")`` in 512-read batches (no numpy run planner), then
    :func:`serve_checks`; with ``held_out`` the archive's last file is left
    out of the build, a query of its reads must miss it, and after its
    insert a query must find it. Launch counters are zeroed just before and
    read just after; ``probe`` must launch ``per_query`` times per query
    and the other probe kernels never. Returns the launch counts and the
    index."""
    from repro_torch.data import genome
    from repro_torch.index import build_archive
    from repro_torch.kernels.idl_insert import ops as ins_ops
    from repro_torch.obs import metrics as obs_metrics

    obs_metrics.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    build_files = archive[:-1] if held_out else archive
    t0 = time.perf_counter()
    with counting_calls(ins_ops, "plan_insert_runs") as planner:
        eng = build_archive(eng, build_files, read_len=cfg.read_len,
                            chunk_reads=INSERT_BATCH, backend="idl_insert")
        torch.cuda.synchronize()
        ingest_s = time.perf_counter() - t0
        held_queries, held_line = 0, ""
        if held_out:
            fid, codes = archive[-1]
            reads = genome.extract_reads(codes, cfg.read_len, 8, seed=3)
            before = eng.msmt(reads)
            eng = build_archive(eng, archive[-1:], read_len=cfg.read_len,
                                chunk_reads=INSERT_BATCH,
                                backend="idl_insert")
            after = eng.msmt(reads)
            held_queries = 2
            check(not bool(before[:, fid].any()) and bool(after[:, fid].all()),
                  f"file {fid}: missed before its insert, found after")
            held_line = (f"file {fid} held out of the build: its 8 reads "
                         f"matched it 0/8 before its insert, 8/8 after; ")
    check(planner[0] == 0, "no numpy run planner on the CUDA ingest path")
    check(read_launches()["insert_planned"] > 0, "insert_planned launched")
    torch.cuda.synchronize()
    ingest_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    served = serve_checks(eng, archive, cfg, per_query)
    torch.cuda.synchronize()
    serve_peak = torch.cuda.max_memory_allocated()
    launches = read_launches()
    want = served["probe_launches"] + per_query * held_queries
    others = [n for n in ("gather_planned_rows", "gather_planned_bits",
                          "probe_planned_bits") if n != probe]
    check(launches[probe] == want and all(launches[n] == 0 for n in others),
          f"{probe} launched {launches[probe]} times, {per_query} per query "
          f"({want}); {', '.join(others)} never")
    for name in (probe, "insert_planned", "window_min"):
        check(launches[name] > 0, f"{name} launched on the {label} path")
    snap = obs_metrics.DEFAULT.snapshot()
    stages = stage_means(snap, ingest_s, served["batch_ms"])
    minhashes = check_window_min_launches(launches, stages,
                                          served["extra_minhashes"],
                                          f"{label} path")
    tile_q = obs_metrics.counter_total(
        snap, "locality.planned_tile_bytes", {"op": "query"})
    runs = {op: (obs_metrics.counter_total(snap, "locality.probe_runs",
                                           {"op": op}),
                 obs_metrics.counter_total(snap, "locality.probes",
                                           {"op": op}))
            for op in ("insert", "query")}
    distinct, kmers = served["dedup_kmers"]
    print(f"phase {label}: ok — {eng.state.nbytes} B of words "
          f"{[tuple(w.shape) for w in eng.state.words]} over "
          f"{len(archive)} files ({sum(len(c) for _, c in archive)} bases); "
          f"ingest {ingest_s:.3f} s in batches of {INSERT_BATCH} reads "
          f"({stages['insert.launch']['batches']} planned inserts; numpy "
          f"run planner calls 0); {held_line}window_min once per MinHash "
          f"({minhashes}); serve {SERVE_BATCHES} x {SERVE_BATCH} reads, "
          f"batch ms {[round(x, 3) for x in served['batch_ms']]} (numpy "
          f"probe planner calls 0); recall {served['correct']}/"
          f"{served['total']}; mean extra matched files "
          f"{served['extra'] / served['total']:.4f}; {SERVE_BATCH} random "
          f"reads matched {served['random_extra']} files in all; first batch "
          f"== torch backend; dedup batch ({OVERLAP_STARTS} start points, "
          f"{distinct} distinct of {kmers} kmers) == no dedup; planner "
          f"runs/probes insert {runs['insert'][0]:.0f}/{runs['insert'][1]:.0f}"
          f" query {runs['query'][0]:.0f}/{runs['query'][1]:.0f}, "
          f"locality.planned_tile_bytes query {tile_q:.0f}; launches "
          f"{json.dumps(launches)}; max_memory_allocated ingest "
          f"{ingest_peak} B, serve {serve_peak} B")
    print(f"phase {label} where the time goes (host ms per batch, means over "
          f"the path's run; the query stages also time the random and dedup "
          f"queries, and any held-out file's): "
          + json.dumps(stages, sort_keys=True))
    return launches, eng


def cobs_path_phase(cfg, archive, dev) -> dict:
    """Phase 5: COBS over the archive (``CobsIndex.build(kmer counts,
    full_config's IDLConfig, "idl", bits_per_kmer=10, n_groups=2)``), one
    ``gather_planned_rows`` launch per size group and query."""
    from repro_torch.index import CobsIndex

    eng = CobsIndex.build(cobs_sizes(archive, cfg.k), cfg.idl_config(),
                          "idl", 10.0, 2, device=dev)
    return engine_path_phase("5 COBS", eng, archive, cfg,
                             probe="gather_planned_rows",
                             per_query=len(eng.groups), held_out=False)[0]


def minimizer_phase(cfg, archive, dev) -> dict:
    """Phase 5b: minimizer ingest (``window_min=16``) of the archive's first
    64 files into a fresh COBS index: its words equal the plain
    ``"torch"`` backend's (not counted) and are a subset of a full build's,
    with fewer bits; ``window_min`` launches three times per planned insert
    (the MinHash and the mask's two sliding minima). Returns the launch
    counts."""
    from repro_torch.index import CobsIndex, build_archive
    from repro_torch.index.engines import popcount32
    from repro_torch.obs import metrics as obs_metrics

    files = archive[:64]
    sizes = cobs_sizes(archive, cfg.k)

    def fresh():
        return CobsIndex.build(sizes, cfg.idl_config(), "idl", 10.0, 2,
                               device=dev)

    def build(backend, window_min):
        return build_archive(fresh(), files, read_len=cfg.read_len,
                             chunk_reads=INSERT_BATCH, backend=backend,
                             window_min=window_min)

    obs_metrics.reset()
    reset_launches()
    mini = build("idl_insert", 16)
    torch.cuda.synchronize()
    launches = read_launches()
    n_inserts = sum(
        h["count"] for key, h in obs_metrics.DEFAULT.snapshot()["hists"][
            "planner.stage_ms"].items()
        if obs_metrics.parse_label_key(key) == {
            "tier": "planner", "op": "insert", "stage": "launch"})
    plain = build("torch", 16)
    full = build("idl_insert", None)
    for name, mod, attr in _counters():     # the comparisons are not counted
        setattr(mod, attr, launches[name])
    set_bits = [sum(int(popcount32(w).sum()) for w in e.state.words)
                for e in (mini, full)]
    check(all(torch.equal(a, b) for a, b in zip(mini.state.words,
                                                plain.state.words)),
          "minimizer build: idl_insert words == torch backend words")
    check(all(bool(((a & ~b) == 0).all()) for a, b in
              zip(mini.state.words, full.state.words))
          and 0 < set_bits[0] < set_bits[1],
          "minimizer build is a strict subset of the full build")
    check(launches["window_min"] == 3 * n_inserts
          and launches["insert_planned"] == n_inserts,
          f"window_min launched three times per minimizer insert "
          f"({launches['window_min']} for {n_inserts})")
    print(f"phase 5b minimizer ingest: ok — {len(files)} files into a fresh "
          f"COBS index with window_min=16 ({n_inserts} planned inserts, "
          f"window_min {launches['window_min']} launches, three per insert); "
          f"words == the torch backend's; set bits {set_bits[0]} of a full "
          f"build's {set_bits[1]} ({set_bits[0] / set_bits[1]:.4f}), a "
          f"subset")
    return launches


def rambo_path_phase(cfg, archive, dev) -> tuple:
    """Phase 6: RAMBO over the archive (``RamboIndex.build(1024, cfg at m =
    2^25 bits a bucket, "idl")``: B 32, R 10, (320, 2^20) int32 words),
    ``"rows"`` inserts of 10 targets per kmer and repetition, one bit-mode
    launch per query; the archive's last file goes in after the build and a
    query after its insert must see it. Returns the launch counts and the
    index."""
    from repro_torch.index import RamboIndex

    eng = RamboIndex.build(len(archive), engine_config(cfg, RAMBO_M), "idl",
                           device=dev)
    check((eng.n_buckets, eng.n_rep) == (32, 10), "RAMBO shape B 32, R 10")
    return engine_path_phase("6 RAMBO", eng, archive, cfg,
                             probe="gather_planned_bits", per_query=1,
                             held_out=True)


# -- phases 7a-7c: the serving tier (cache, scheduler, router, live index) ----

HELD_OUT = 8                    # archive files kept out of the tier's base
CACHE_CAPACITY = 1 << 19        # kmers: one pass of phase 3's traffic fits
TIER_DELAY_MS = 20.0            # scheduler deadline: batches fill to 256
WAIT_S = 600                    # every future's own timeout


def serve_traffic(archive, cfg) -> list:
    """Phase 3's serve batches: ``SERVE_BATCHES`` x 256 ``(file id, read)``
    pairs from the same seed."""
    qrng = np.random.default_rng(0)
    batches = []
    for _ in range(SERVE_BATCHES):
        fids = qrng.integers(0, cfg.n_files, size=SERVE_BATCH)
        batches.append([(int(f), archive[int(f)].reads(cfg.read_len, 1)[0])
                        for f in fids])
    return batches


def shifted_reads(archive, batch) -> list:
    """Each read of ``batch`` moved one base along its genome."""
    out = []
    for fid, read in batch:
        g = archive[fid].genome
        pos = g.tobytes().find(read.tobytes())
        pos += 1 if pos + len(read) < len(g) else -1
        out.append((fid, g[pos:pos + len(read)]))
    return out


def resolve(futures) -> list:
    return [f.result(timeout=WAIT_S) for f in futures]


def uncounted(fn):
    """Run ``fn`` (an oracle's comparison run) with the launch counters
    restored after it: its launches do not count for the path."""
    counts = read_launches()
    try:
        return fn()
    finally:
        for name, mod, attr in _counters():
            setattr(mod, attr, counts[name])


def direct_answers(svc, reads, batch_ms=None) -> list:
    """``svc.search`` in batches of ``SERVE_BATCH``: the (n_files,) verdict
    rows; the wall ms of each batch go to ``batch_ms``."""
    rows = []
    for i in range(0, len(reads), SERVE_BATCH):
        t0 = time.perf_counter()
        rows += [r.matches for r in svc.search(reads[i:i + SERVE_BATCH])]
        if batch_ms is not None:
            batch_ms.append(1e3 * (time.perf_counter() - t0))
    return rows


def same_rows(got, want) -> bool:
    return len(got) == len(want) and all(
        np.array_equal(g, w) for g, w in zip(got, want))


def pipelined_rate(rt, reads, want) -> float:
    """Requests a second when every read is submitted at once (batches
    overlap in the pipeline and across replicas); answers checked."""
    t0 = time.perf_counter()
    got = resolve([rt.submit(read) for read in reads])
    rate = len(reads) / (time.perf_counter() - t0)
    check(same_rows([r.matches for r in got], want),
          "pipelined pass == direct service")
    return rate


def routed_pass(rt, batches) -> tuple:
    """Submit each 256-read batch and wait for its futures before the next
    (so a batch is the router's batch); returns the results, and the
    router's per-batch records of the pass."""
    n0 = len(rt.cluster_stats())
    results = []
    for batch in batches:
        results += resolve([rt.submit(read) for _, read in batch])
    return results, rt.cluster_stats()[n0:]


def cache_copies(services) -> tuple:
    """(bytes up, bytes down) the services' cached paths copied so far."""
    sums = [0, 0]
    for svc in services:
        for i, n in enumerate(svc.cache_copy_bytes()):
            sums[i] += n
    return tuple(sums)


def stage_hists() -> dict:
    """``{"op.stage": (calls, total ms)}`` of the planner's stage timers
    and of the cached path's (``cache.<stage>``), read now."""
    from repro_torch.obs import metrics as obs_metrics

    hists = obs_metrics.DEFAULT.snapshot()["hists"]
    out = {}
    for name in ("planner.stage_ms", "serving.cache_stage_ms"):
        for key, h in hists.get(name, {}).items():
            labels = obs_metrics.parse_label_key(key)
            out[f"{labels.get('op', 'cache')}.{labels['stage']}"] = \
                (h["count"], h["sum"])
    return out


def stage_delta(before: dict, after: dict, n_batches=None) -> dict:
    """Host ms of each stage between two :func:`stage_hists` readings: per
    batch (the stage's total over ``n_batches``; a stage may run zero or
    several times in a batch) or, without ``n_batches``, per call with the
    call count."""
    out = {}
    for tag, (calls, total) in after.items():
        c0, t0 = before.get(tag, (0, 0.0))
        if calls > c0:
            out[tag] = (round((total - t0) / n_batches, 3) if n_batches
                        else {"mean_ms": round((total - t0) / (calls - c0),
                                               3), "calls": calls - c0})
    return out


def stats_line(stats) -> dict:
    walls = [s.wall_ms for s in stats]
    hits = sum(s.cache_hits for s in stats)
    lookups = sum(s.cache_lookups for s in stats)
    return {"batches": len(stats), "mean_wall_ms": sum(walls) / len(walls),
            "wall_ms": [round(w, 3) for w in walls],
            "hit_rate": hits / lookups if lookups else None}


def tier_phase(cfg, archive, full_eng, dev) -> tuple:
    """Phase 7a: a base of the archive less its last ``HELD_OUT`` files,
    served with the membership cache through ``ReplicaRouter`` (2 replicas
    on the card, one shared base), checked against an uncached direct
    service; then a hot swap to phase 3's full index (the union) under
    traffic. Returns the launch counts and the base."""
    from repro_torch.index import BitSlicedIndex, build_archive
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.serving import (GeneSearchService, KmerCacheConfig,
                                     ReplicaRouter, RouterConfig,
                                     SchedulerConfig, ServiceConfig)

    obs_metrics.reset()
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    base = build_archive(
        BitSlicedIndex.build(cfg.idl_config(), cfg.scheme, cfg.n_files,
                             device=dev),
        archive[:-HELD_OUT], read_len=cfg.read_len,
        chunk_reads=INSERT_BATCH, backend="idl_insert")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    traffic = serve_traffic(archive, cfg)
    flat = [read for batch in traffic for _, read in batch]
    shifted = shifted_reads(archive, traffic[0])
    held = [(f.file_id, f.reads(cfg.read_len, 1)[0])
            for f in archive[-HELD_OUT:]]
    extra = [read for _, read in shifted] + [read for _, read in held]
    svc_cfg = dict(theta=1.0, max_batch=SERVE_BATCH, backend="idl_probe")
    direct = GeneSearchService(base, ServiceConfig(**svc_cfg))
    union = GeneSearchService(full_eng, ServiceConfig(**svc_cfg))
    uncached_ms = []
    want = uncounted(lambda: direct_answers(direct, flat, uncached_ms))
    want_extra = uncounted(lambda: direct_answers(direct, extra))
    want_union = uncounted(lambda: direct_answers(union, flat + extra))
    check(not any(row[f] for (f, _), row in
                  zip(held, want_extra[-HELD_OUT:])),
          "the base misses every held-out file")
    check(all(row[f] for (f, _), row in zip(held, want_union[-HELD_OUT:])),
          "the union index finds every held-out file")
    cache = KmerCacheConfig(capacity=CACHE_CAPACITY)
    sched = SchedulerConfig(max_delay_ms=TIER_DELAY_MS)

    # one replica: the uncached and cached batch times, the hit rate
    walls, rates = {}, {}
    with ReplicaRouter(base, ServiceConfig(**svc_cfg), RouterConfig(
            n_replicas=1, scheduler=sched)) as rt:
        rates["uncached, 1 replica"] = pipelined_rate(rt, flat, want)
        h0 = stage_hists()
        got, stats = routed_pass(rt, traffic)
        check(same_rows([r.matches for r in got], want),
              "uncached router == direct service")
        walls["uncached_router"] = stats_line(stats)
        walls["uncached_router"]["stages_ms_per_batch"] = stage_delta(
            h0, stage_hists(), len(stats))
    with ReplicaRouter(base, ServiceConfig(**svc_cfg, kmer_cache=cache),
                       RouterConfig(n_replicas=1, scheduler=sched)) as rt:
        svcs = [rt._replicas[0].service]
        for name, batches, oracle in (("cold", traffic, want),
                                      ("warm", traffic, want),
                                      ("shifted", [shifted],
                                       want_extra[:SERVE_BATCH])):
            before, h0 = cache_copies(svcs), stage_hists()
            got, stats = routed_pass(rt, batches)
            after = cache_copies(svcs)
            check(same_rows([r.matches for r in got], oracle),
                  f"{name} cached router == direct service")
            walls[name] = stats_line(stats)
            walls[name]["stages_ms_per_batch"] = stage_delta(
                h0, stage_hists(), len(stats))
            walls[name]["bytes_up_per_batch"] = \
                (after[0] - before[0]) / len(stats)
            walls[name]["bytes_down_per_batch"] = \
                (after[1] - before[1]) / len(stats)
        check(walls["warm"]["hit_rate"] == 1.0,
              f"pass two's hit rate on one replica is 1.0 "
              f"({walls['warm']['hit_rate']})")
        rates["warm cache, 1 replica"] = pipelined_rate(rt, flat, want)
    with ReplicaRouter(base, ServiceConfig(**svc_cfg), RouterConfig(
            n_replicas=2, scheduler=sched)) as rt:
        rates["uncached, 2 replicas"] = pipelined_rate(rt, flat, want)

    # two replicas sharing the base: both passes, shifted and held-out reads
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    rt = ReplicaRouter(base, ServiceConfig(**svc_cfg, kmer_cache=cache),
                       RouterConfig(n_replicas=2, scheduler=sched))
    try:
        states = [r.service.state for r in rt._replicas]
        check(states[0].words[0].data_ptr() == states[1].words[0].data_ptr()
              == base.words.data_ptr(), "the 2 replicas share one base")
        futures = [rt.submit(read) for read in flat + extra]
        got = [r.matches for r in resolve(futures)]
        check(same_rows(got, want + want_extra),
              "2-replica cached router == direct service (traffic, "
              "shifted and held-out reads)")
        first = rt.cache_stats()
        rates["cached second pass, 2 replicas"] = pipelined_rate(
            rt, flat, want)
        second = rt.cache_stats()
        rates["hit rate of that pass"] = (second["hits"] - first["hits"]) \
            / (second["lookups"] - first["lookups"])
        found_before = sum(bool(row[f]) for (f, _), row in
                           zip(held, got[-HELD_OUT:]))
        check(found_before == 0, "held-out files found 0 of 8 on the base")
        two_rep = rt.cache_stats()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - resident
        check(peak < base.state.nbytes,
              f"serving 2 replicas added {peak} B, less than a second base")
        # hot swap to the union index while traffic flows
        counts0 = rt.compile_counts()
        inv0 = two_rep["invalidations"]
        first = [rt.submit(read) for read in flat + extra]
        t_swap = time.perf_counter()
        version = rt.swap_state(full_eng)
        swap_ms = 1e3 * (time.perf_counter() - t_swap)
        second = [rt.submit(read) for read in flat + extra]
        res_first, res_second = resolve(first), resolve(second)
        check(version == 1 and {r.version for r in res_second} == {1},
              "every request after the swap served by version 1")
        oracle = {0: want + want_extra, 1: want_union}
        check(all(np.array_equal(r.matches, oracle[r.version][i])
                  for i, r in enumerate(res_first))
              and same_rows([r.matches for r in res_second], want_union),
              "answers across the swap == the direct service of the "
              "version that served them")
        for rid in (0, 1):
            vs = [s.version for s in rt.cluster_stats() if s.replica == rid]
            check(vs == sorted(vs), f"replica {rid}: versions monotone")
        found_after = sum(bool(r.matches[f]) for (f, _), r in
                          zip(held, res_second[-HELD_OUT:]))
        check(found_after == HELD_OUT, "held-out files found 8 of 8 after "
              "the swap")
        swapped = rt.cache_stats()
        check(swapped["invalidations"] > inv0,
              "the swap invalidated the caches")
        check(rt.compile_counts() == counts0, "runners unchanged by the swap")
        check(all(r.service.state.words[0].data_ptr()
                  == full_eng.words.data_ptr() for r in rt._replicas),
              "both replicas share the swapped-in index")
    finally:
        rt.close()
    launches = read_launches()
    for name in ("gather_planned_rows", "insert_planned", "window_min"):
        check(launches[name] > 0, f"{name} launched on the tier path")
    check(launches["probe_planned_bits"] == launches["gather_planned_bits"]
          == 0, "no bit probe on the bit-sliced tier")
    n_base = cfg.n_files - HELD_OUT
    print(f"phase 7a cached routed serving: ok — base of {n_base} files "
          f"built in {build_s:.3f} s; traffic phase 3's "
          f"{SERVE_BATCHES} x {SERVE_BATCH} reads; every answer == the "
          f"uncached direct service; one replica, pass two hit rate "
          f"{walls['warm']['hit_rate']}; batch wall ms (mean) direct "
          f"uncached {sum(uncached_ms) / len(uncached_ms):.3f}, router "
          f"uncached {walls['uncached_router']['mean_wall_ms']:.3f}, cold "
          f"{walls['cold']['mean_wall_ms']:.3f}, warm "
          f"{walls['warm']['mean_wall_ms']:.3f}; bytes per batch up/down "
          f"cold {walls['cold']['bytes_up_per_batch']:.0f}/"
          f"{walls['cold']['bytes_down_per_batch']:.0f} warm "
          f"{walls['warm']['bytes_up_per_batch']:.0f}/"
          f"{walls['warm']['bytes_down_per_batch']:.0f}; shifted reads "
          f"hit rate {walls['shifted']['hit_rate']:.4f}; 2 replicas (one "
          f"base, {peak} B above the resident indexes at peak), merged "
          f"cache {json.dumps(two_rep)}; held-out files "
          f"found {found_before}/{HELD_OUT} before the swap, {found_after}/"
          f"{HELD_OUT} after (swap {swap_ms:.3f} ms under traffic, "
          f"invalidations {swapped['invalidations']}, versions monotone, "
          f"runners unchanged); launches {json.dumps(launches)}")
    print("phase 7a batch walls: " + json.dumps(walls, sort_keys=True))
    print("phase 7a requests a second, all 2048 reads submitted at once: "
          + json.dumps({k: round(v, 4) for k, v in rates.items()}))
    return launches, base


def held_out_writes(archive, cfg) -> list:
    """The held-out files' windows, as ``build_archive`` cuts them, in
    ``INSERT_BATCH``-read write batches of (reads, file ids)."""
    from repro_torch.data import genome

    reads, fids = [], []
    for f in archive[-HELD_OUT:]:
        win = genome.window_reads(f.genome, cfg.read_len, cfg.k)
        reads.extend(win)
        fids.extend([f.file_id] * len(win))
    return [(np.stack(reads[i:i + INSERT_BATCH]),
             np.asarray(fids[i:i + INSERT_BATCH], dtype=np.int32))
            for i in range(0, len(reads), INSERT_BATCH)]


def live_phase(cfg, archive, base, full_eng, dev) -> dict:
    """Phase 7b: ``LiveReplicaRouter`` (2 replicas) over phase 7a's base;
    the held-out files written through ``router.insert`` while queries
    flow, a ``Compactor`` compaction under traffic; every answer between
    the base's and the union's, equal to the union's once its watermark
    holds every write, and after the compaction. Returns the launch
    counts."""
    from repro_torch.serving import (Compactor, GeneSearchService,
                                     LiveReplicaRouter, RouterConfig,
                                     SchedulerConfig, ServiceConfig)

    svc_cfg = ServiceConfig(theta=1.0, max_batch=SERVE_BATCH,
                            backend="idl_probe")
    traffic = serve_traffic(archive, cfg)[:2]
    held = [(f.file_id, f.reads(cfg.read_len, 1)[0])
            for f in archive[-HELD_OUT:]]
    queries = [read for batch in traffic for _, read in batch] + \
        [read for _, read in held]
    lower = uncounted(lambda: direct_answers(
        GeneSearchService(base, svc_cfg), queries))
    upper = uncounted(lambda: direct_answers(
        GeneSearchService(full_eng, svc_cfg), queries))
    writes = held_out_writes(archive, cfg)
    torch.cuda.synchronize()
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    h0 = stage_hists()
    rt = LiveReplicaRouter(base, svc_cfg, RouterConfig(
        n_replicas=2, scheduler=SchedulerConfig(max_delay_ms=TIER_DELAY_MS)))
    compact_s = []
    orig_compact = rt.compact

    def timed_compact(**kw):
        t0 = time.perf_counter()
        out = orig_compact(**kw)
        compact_s.append(time.perf_counter() - t0)
        return out

    rt.compact = timed_compact
    n_writes = len(writes)
    rounds = []                     # (results, label)
    ack_ms = []
    try:
        lives = [r.service.live for r in rt._replicas]
        check(lives[0].base.words[0].data_ptr() ==
              lives[1].base.words[0].data_ptr() == base.words.data_ptr(),
              "the live replicas share the base")
        rounds.append(("before", resolve([rt.submit(q) for q in queries])))
        pending = []
        for reads, fids in writes:
            t0 = time.perf_counter()
            acks = rt.insert(reads, fids)
            done = []
            for f in acks:
                f.add_done_callback(
                    lambda _, t0=t0, done=done: done.append(
                        time.perf_counter() - t0))
            pending.append((acks, done))
            rounds.append(("writing", [rt.submit(q) for q in queries]))
        for acks, done in pending:
            resolve(acks)
            ack_ms.append(1e3 * max(done))
        rounds = [(label, res if label == "before" else resolve(res))
                  for label, res in rounds]
        rounds.append(("acked", resolve([rt.submit(q) for q in queries])))
        compactor = Compactor(rt, interval_s=0.05, min_delta_batches=n_writes)
        during = 0
        deadline = time.perf_counter() + WAIT_S
        while compactor.compactions == 0 and time.perf_counter() < deadline:
            rounds.append(("compacting",
                           resolve([rt.submit(q) for q in queries])))
            during += 1
        compactions = compactor.close()
        check(compactions == 1, "the Compactor compacted once mid-traffic")
        rounds.append(("compacted", resolve([rt.submit(q) for q in queries])))
        check(all(r.service.live.base.words[0].data_ptr() ==
                  rt._replicas[0].service.live.base.words[0].data_ptr()
                  for r in rt._replicas), "one merged base for 2 replicas")
        live_walls = [s.wall_ms for s in rt.cluster_stats()]
    finally:
        rt.close()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    stages = stage_delta(h0, stage_hists())
    exact = 0
    for label, results in rounds:
        for res, lo, hi in zip(results, lower, upper):
            if label == "before":
                ok = np.array_equal(res.matches, lo) and res.delta_seq == 0
            elif res.delta_seq == n_writes or res.version >= 1:
                ok = np.array_equal(res.matches, hi)
                exact += 1
            else:      # mid-write: the base's bits and at most the union's
                ok = (not (lo & ~res.matches).any()
                      and not (res.matches & ~hi).any())
            check(ok, f"{label} answer within its watermark's union "
                  f"(version {res.version}, delta_seq {res.delta_seq})")
    after = rounds[-1][1]
    check({(r.version, r.delta_seq) for r in after} == {(1, n_writes)},
          "after the compaction: version 1, every write folded")
    recall = [sum(bool(r.matches[f]) for (f, _), r in
                  zip(held, results[-HELD_OUT:])) for _, results in rounds]
    check(recall[0] == 0 and recall[-1] == HELD_OUT and all(
        n == HELD_OUT for (label, _), n in zip(rounds, recall)
        if label in ("acked", "compacting", "compacted")),
        f"held-out recall 0 before the writes, total after ({recall})")
    launches = read_launches()
    check(launches["insert_planned"] == 2 * n_writes,
          "insert_planned launched once per write batch and replica")
    for name in ("gather_planned_rows", "window_min"):
        check(launches[name] > 0, f"{name} launched on the live path")
    n_answers = sum(len(res) for _, res in rounds)
    print(f"phase 7b live index: ok — LiveReplicaRouter, 2 replicas over "
          f"7a's base; {sum(len(r) for r, _ in writes)} reads of "
          f"{HELD_OUT} held-out files in {n_writes} write batches under "
          f"traffic, insert-ack ms {[round(x, 3) for x in ack_ms]}; "
          f"{n_answers} answers, all futures resolved, each within its "
          f"watermark ({exact} equal to the union index); a Compactor "
          f"compaction mid-traffic ({during} query rounds while it ran) "
          f"took {compact_s[0]:.3f} s; after it every answer == the union "
          f"index at version 1; held-out recall per round {recall}; "
          f"max_memory_allocated {peak} B; launches {json.dumps(launches)}")
    print(f"phase 7b where the time goes: {len(live_walls)} query batches "
          f"of the 2 replicas, wall ms mean "
          f"{sum(live_walls) / len(live_walls):.3f}; host ms per call of "
          f"each stage (a live query batch probes base and delta): "
          + json.dumps(stages, sort_keys=True))
    return launches


def rambo_cache_phase(cfg, archive, eng) -> dict:
    """Phase 7c: the membership cache over phase 6's RAMBO index (rows of
    1,024 bools a kmer): two passes of ``SERVE_BATCHES`` x 256 reads, the
    cached service equal to the uncached one; batch walls both ways and
    the bytes copied each way. Returns the launch counts."""
    from repro_torch.data import genome
    from repro_torch.serving import (GeneSearchService, KmerCacheConfig,
                                     ServiceConfig)

    qrng = np.random.default_rng(7)
    reads = []
    for r in range(SERVE_BATCHES):
        fids = qrng.integers(0, len(archive), size=SERVE_BATCH)
        reads += [genome.extract_reads(archive[int(f)][1], cfg.read_len, 1,
                                       seed=1000 * r + i)[0]
                  for i, f in enumerate(fids)]
    svc_cfg = dict(theta=1.0, max_batch=SERVE_BATCH, backend="idl_probe")
    plain = GeneSearchService(eng, ServiceConfig(**svc_cfg))
    cached = GeneSearchService(eng, ServiceConfig(
        **svc_cfg, kmer_cache=KmerCacheConfig(capacity=CACHE_CAPACITY)))
    torch.cuda.synchronize()
    reset_launches()
    walls = {}
    for p in ("pass 1", "pass 2"):
        plain_ms, cached_ms = [], []
        want = uncounted(lambda: direct_answers(plain, reads, plain_ms))
        before, h0 = cache_copies([cached]), stage_hists()
        st0 = cached.cache_stats()
        got = direct_answers(cached, reads, cached_ms)
        after = cache_copies([cached])
        stages = stage_delta(h0, stage_hists(), SERVE_BATCHES)
        st1 = cached.cache_stats()
        check(same_rows(got, want), f"RAMBO {p}: cached == uncached")
        walls[p] = {
            "uncached_mean_ms": sum(plain_ms) / len(plain_ms),
            "cached_mean_ms": sum(cached_ms) / len(cached_ms),
            "uncached_ms": [round(x, 3) for x in plain_ms],
            "cached_ms": [round(x, 3) for x in cached_ms],
            "bytes_up_per_batch": (after[0] - before[0]) / SERVE_BATCHES,
            "bytes_down_per_batch": (after[1] - before[1]) / SERVE_BATCHES,
            "hit_rate": (st1["hits"] - st0["hits"])
            / (st1["lookups"] - st0["lookups"]),
            "stages_ms_per_batch": stages}
    launches = read_launches()
    check(launches["gather_planned_bits"] > 0 and launches["window_min"] > 0,
          "gather_planned_bits and window_min launched for the misses")
    check(launches["gather_planned_rows"] == launches["probe_planned_bits"]
          == 0, "RAMBO misses probe through the bit mode only")
    print(f"phase 7c RAMBO with the cache: ok — two passes of "
          f"{SERVE_BATCHES} x {SERVE_BATCH} reads, cached == uncached; "
          + "; ".join(f"{p}: batch ms uncached {w['uncached_mean_ms']:.3f} "
                      f"cached {w['cached_mean_ms']:.3f}, hit rate "
                      f"{w['hit_rate']:.4f}, bytes per batch up "
                      f"{w['bytes_up_per_batch']:.0f} down "
                      f"{w['bytes_down_per_batch']:.0f}"
                      for p, w in walls.items())
          + f"; launches {json.dumps(launches)}")
    print("phase 7c batch walls: " + json.dumps(walls, sort_keys=True))
    return launches


# -- phases 8, 9a and 9b: the process fabric and sharded archives -------------

SNAPSHOT_ROOM = 9 << 30         # bytes of disk one full-width snapshot needs
FABRIC_WORKERS = 2
SHARDS = 4                      # phase 9a's file shards (256 files each)
RAMBO_SHARDS = 2                # phase 9b's word shards
GATEWAY_TIMEOUT_S = 900         # the phase-8 gateway process's time limit


def scratch_dir(tag: str, need: int) -> str:
    """A fresh directory under the temp root for a phase's snapshots,
    after printing the root's free bytes; fails the run when fewer than
    ``need`` bytes are free."""
    import shutil
    import tempfile

    root = tempfile.gettempdir()
    free = shutil.disk_usage(root).free
    print(f"phase {tag} temp root {root}: {free} bytes free, {need} needed "
          f"for its snapshots")
    check(free >= need, f"room for phase {tag}'s snapshots in {root} "
          f"({free} bytes free, {need} needed)")
    return tempfile.mkdtemp(prefix=f"chip_smoke_{tag}_", dir=root)


def remove_dir(path: str) -> None:
    import shutil

    shutil.rmtree(path, ignore_errors=True)


def add_launches(total: dict, more: dict) -> dict:
    for name, n in more.items():
        total[name] = total.get(name, 0) + n
    return total


def query_locations_ms(stats: dict) -> dict:
    """Mean host ms per call of a worker's ``query.locations`` stage and
    its call count, from the obs snapshot of its ``stats`` reply."""
    from repro_torch.obs import metrics as obs_metrics

    hists = stats["obs"]["metrics"]["hists"].get("planner.stage_ms", {})
    for key, h in hists.items():
        labels = obs_metrics.parse_label_key(key)
        if (labels["op"], labels["stage"]) == ("query", "locations"):
            return {"mean_ms": h["sum"] / h["count"], "calls": h["count"]}
    return {"mean_ms": None, "calls": 0}


def shards_phase(cfg, archive, full_eng, dev) -> dict:
    """Phase 9a: ``build_sharded_archive`` of phase 3's archive into
    ``SHARDS`` file shards (one thread each) equal to phase 3's index word
    for word (``join_states``); the shard set saved and served through
    ``ScatterGatherRouter`` in this process and with ``procs=True`` (a
    process per shard), both equal to the unsharded service; a killed
    shard process named in ``missing_files``; the ``"sharded"`` service
    backend on the one-card mesh equal to ``"idl_probe"``. Returns the
    launch counts (this process's and the shard processes')."""
    from repro_torch.index import BitSlicedIndex, build_sharded_archive, \
        shards
    from repro_torch.index import query
    from repro_torch.serving import (GeneSearchService, ScatterConfig,
                                     ScatterGatherRouter, SchedulerConfig,
                                     ServiceConfig)

    t_phase = time.perf_counter()
    svc_cfg = ServiceConfig(theta=1.0, max_batch=SERVE_BATCH,
                            backend="idl_probe")
    traffic = serve_traffic(archive, cfg)
    flat = [read for batch in traffic for _, read in batch]
    want = uncounted(lambda: direct_answers(
        GeneSearchService(full_eng, svc_cfg), flat))
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    spec, states = build_sharded_archive(
        BitSlicedIndex.build(cfg.idl_config(), cfg.scheme, cfg.n_files,
                             device=dev),
        archive, n_shards=SHARDS, read_len=cfg.read_len,
        chunk_reads=INSERT_BATCH, backend="idl_insert")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    check(spec.axis == "files" and spec.n_shards == SHARDS,
          f"{SHARDS} file shards")
    joined = shards.join_states(spec, states)
    check(torch.equal(joined.words[0], full_eng.words),
          "the sharded build == phase 3's index word for word")
    del joined
    torch.cuda.empty_cache()
    work = scratch_dir("9a", SNAPSHOT_ROOM)
    try:
        t0 = time.perf_counter()
        set_dir = shards.save_shard_set(spec, states, f"{work}/set")
        save_s = time.perf_counter() - t0
        del states
        torch.cuda.empty_cache()
        sched = SchedulerConfig(max_delay_ms=TIER_DELAY_MS)
        rates, boot_s = {}, {}
        t0 = time.perf_counter()
        with ScatterGatherRouter(set_dir, ScatterConfig(
                service=svc_cfg, scheduler=sched, device="cuda")) as rt:
            boot_s["in-process"] = time.perf_counter() - t0
            rates["in-process"] = pipelined_rate(rt, flat, want)
        torch.cuda.empty_cache()
        lost = shards.shard_files(spec, 1)
        kept = np.asarray(sorted(set(range(cfg.n_files)) - set(lost)))
        t0 = time.perf_counter()
        rt = ScatterGatherRouter(set_dir, ScatterConfig(
            procs=True, service=svc_cfg, scheduler=sched, device="cuda"))
        try:
            boot_s["procs"] = time.perf_counter() - t0
            rates["procs"] = pipelined_rate(rt, flat, want)
            stats = rt.stats()
            check(len(stats) == SHARDS, "every shard process answered stats")
            shard_launches = {}
            for s in stats.values():
                add_launches(shard_launches, s["device"]["launches"])
            mems = {sid: s["device"]["max_memory_allocated"]
                    for sid, s in sorted(stats.items())}
            futures = [rt.submit(read) for read in flat]
            rt.kill_shard(1)
            results = resolve(futures)
            named = 0
            for res, row in zip(results, want):
                if res.missing_files:
                    check(res.missing_files == lost
                          and not res.matches[list(lost)].any(),
                          "a dead shard's files named missing and False")
                    named += 1
                check(np.array_equal(res.matches[kept], row[kept]),
                      "the live shards' files == the unsharded service")
            deadline = time.perf_counter() + 60
            while len(rt.live_shards()) == SHARDS and \
                    time.perf_counter() < deadline:
                time.sleep(0.05)
            late = resolve([rt.submit(read) for read in flat[:SERVE_BATCH]])
            check(all(r.missing_files == lost for r in late),
                  "after the kill every answer names the dead shard's "
                  f"{len(lost)} files")
            check(all(np.array_equal(r.matches[kept], row[kept])
                      for r, row in zip(late, want)),
                  "after the kill the live shards still answer exactly")
        finally:
            rt.close()
    finally:
        remove_dir(work)
    sharded = GeneSearchService(full_eng, ServiceConfig(
        theta=1.0, max_batch=SERVE_BATCH, backend="sharded"))
    check(query.default_mesh(dev) == (torch.device("cuda", 0),)
          and same_rows(direct_answers(sharded, flat[:SERVE_BATCH]),
                        want[:SERVE_BATCH]),
          "the sharded backend on the one-card mesh == idl_probe")
    launches = add_launches(read_launches(), shard_launches)
    for name in ("gather_planned_rows", "insert_planned", "window_min"):
        check(launches[name] > 0, f"{name} launched on the sharded path")
    check(shard_launches["gather_planned_rows"] > 0
          and shard_launches["window_min"] > 0,
          "every shard process launched the gather and window_min")
    print(f"phase 9a sharded archives: ok — build_sharded_archive into "
          f"{SHARDS} file shards ((m, {spec.bounds[1]}) int32 each, one "
          f"thread a shard) in "
          f"{build_s:.3f} s, joined == phase 3's index word for word; shard "
          f"set saved in {save_s:.3f} s; {len(flat)} reads through the "
          f"scatter router in process and with a process per shard, both "
          f"== the unsharded service; boot s "
          f"{json.dumps(boot_s)}; requests a second, all reads in flight, "
          f"{json.dumps(rates)}; shard processes' peak device memory "
          f"{json.dumps(mems)} B; kill -9 of shard 1 mid-stream: every "
          f"future resolved, {named} of {len(flat)} in flight named its "
          f"{len(lost)} files missing, every later answer names them; "
          f"sharded backend on the one-card mesh == idl_probe; shard "
          f"processes' launches {json.dumps(shard_launches)}; launches "
          f"{json.dumps(launches)}; wall {time.perf_counter() - t_phase:.3f}"
          f" s")
    return launches


def fabric_inputs(cfg, archive, base, full_eng) -> str:
    """Phase 8's set-up in this process, while the indexes live: the base
    (7a's, files 0-1015) saved as the fleet's snapshot, and the oracle
    answers of the base and of the union (phase 3's index), kept as numpy
    beside the traffic, the held-out reads and the write batches in
    ``inputs.pkl`` of a scratch directory. Returns the directory."""
    import pickle

    from repro_torch.index import store
    from repro_torch.serving import (GeneSearchService, LiveReplicaRouter,
                                     RouterConfig, SchedulerConfig,
                                     ServiceConfig)

    svc_cfg = ServiceConfig(theta=1.0, max_batch=SERVE_BATCH,
                            backend="idl_probe")
    traffic = serve_traffic(archive, cfg)
    held = [(f.file_id, f.reads(cfg.read_len, 1)[0])
            for f in archive[-HELD_OUT:]]
    flat = [read for batch in traffic for _, read in batch]
    queries = flat + [read for _, read in held]
    lower = uncounted(lambda: direct_answers(
        GeneSearchService(base, svc_cfg), queries))
    upper = uncounted(lambda: direct_answers(
        GeneSearchService(full_eng, svc_cfg), queries))

    # the fabric's in-process counterpart: one live replica over the same
    # base (two hashings a batch, as in a worker), on this interpreter
    def live_baseline():
        with LiveReplicaRouter(base, svc_cfg, RouterConfig(
                n_replicas=1, scheduler=SchedulerConfig(
                    max_delay_ms=TIER_DELAY_MS))) as rt:
            h0 = stage_hists()
            rates = [pipelined_rate(rt, flat, lower[:-HELD_OUT])
                     for _ in range(2)]
            return rates, stage_delta(h0, stage_hists())["query.locations"]

    rates, locations = uncounted(live_baseline)
    torch.cuda.empty_cache()
    print(f"phase 8 in-process counterpart: one LiveReplicaRouter replica "
          f"over the base, requests a second with all {len(flat)} reads in "
          f"flight {json.dumps(rates)}, query.locations host ms per call "
          f"{json.dumps(locations)}")
    work = scratch_dir("8", 2 * SNAPSHOT_ROOM)
    try:
        t0 = time.perf_counter()
        store.save(base, f"{work}/base")
        save_s = time.perf_counter() - t0
        with open(f"{work}/inputs.pkl", "wb") as f:
            pickle.dump({"queries": queries,
                         "held": [fid for fid, _ in held],
                         "writes": held_out_writes(archive, cfg),
                         "lower": np.stack(lower), "upper": np.stack(upper),
                         "save_s": save_s,
                         "device": str(base.words.device)},
                        f, protocol=pickle.HIGHEST_PROTOCOL)
    except BaseException:
        remove_dir(work)
        raise
    return work


def fabric_phase(work: str) -> dict:
    """Phase 8: the process fabric, driven from a gateway process of its
    own (``chip_smoke.py --fabric-gateway DIR``, which never touches
    CUDA), in its own session so that nothing it starts outlives it.
    Prints its lines and returns the launch counts summed over its
    workers."""
    import os
    import signal

    proc = subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--fabric-gateway",
         work], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)
    try:
        out, err = proc.communicate(timeout=GATEWAY_TIMEOUT_S)
    finally:
        if proc.poll() is None or proc.returncode:
            with contextlib.suppress(ProcessLookupError):
                os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
        remove_dir(work)
    sys.stdout.write(out)
    check(proc.returncode == 0, f"the phase-8 gateway exited "
          f"{proc.returncode}: {err[-3000:]}")
    return json.loads(out.strip().splitlines()[-1])["launches"]


def fabric_gateway(work: str) -> None:
    """The phase-8 gateway process: a ``ProcessFabric`` of
    ``FABRIC_WORKERS`` workers over the saved base, each loading it onto
    the card. Serves the traffic (== the base's direct service), writes
    the held-out files (0/8 -> 8/8, every answer within its watermark),
    survives a kill -9 of a worker mid-stream and a compaction with a
    rolling restart under traffic (every answer == the union index), and
    times requests a second with every read in flight on 2 workers, then
    on 1. Its CUDA state must stay uninitialised. Prints its lines and,
    last, a JSON line with the launch counts summed over its workers."""
    import os
    import pickle
    import shutil
    import signal
    import threading

    sys.path.insert(0, str(SRC))
    from repro_torch.serving import (FabricConfig, ProcessFabric,
                                     SchedulerConfig, ServiceConfig)

    t_phase = time.perf_counter()
    with open(f"{work}/inputs.pkl", "rb") as f:
        inp = pickle.load(f)
    queries, lower, upper = inp["queries"], inp["lower"], inp["upper"]
    flat = queries[:-HELD_OUT]
    held = inp["held"]
    writes = inp["writes"]
    n_writes = len(writes)
    svc_cfg = ServiceConfig(theta=1.0, max_batch=SERVE_BATCH,
                            backend="idl_probe")
    # eager: each snapshot's checksum pass ends before its worker serves,
    # so no background pass overlaps the timed passes
    fab_cfg = FabricConfig(
        n_workers=FABRIC_WORKERS, service=svc_cfg,
        scheduler=SchedulerConfig(max_delay_ms=TIER_DELAY_MS),
        verify="eager", device=inp["device"])
    seen: dict = {}                 # worker id -> its last stats reply

    def gather_stats() -> None:
        seen.update(fab.stats())

    def recall(results) -> int:
        return sum(bool(r.matches[f]) for f, r in
                   zip(held, results[-HELD_OUT:]))

    def rate(reads, want) -> float:
        t0 = time.perf_counter()
        got = resolve([fab.submit(read) for read in reads])
        r = len(reads) / (time.perf_counter() - t0)
        check(same_rows([g.matches for g in got], list(want)),
              "pipelined fabric pass == its oracle")
        return r

    t0 = time.perf_counter()
    fab = ProcessFabric(f"{work}/base", fab_cfg,
                        journal_path=f"{work}/wal.idlj")
    rates = {}
    try:
        boot_s = time.perf_counter() - t0
        got = resolve([fab.submit(q) for q in queries])
        check(same_rows([r.matches for r in got], list(lower)),
              "2-worker fabric == the base's direct service")
        before = recall(got)
        check(before == 0, "held-out files found 0 of 8 on the base")
        rates["2 workers"] = [rate(flat, lower[:-HELD_OUT])
                              for _ in range(2)]
        acks, ack_ms, during = [], [], []
        for reads, fids in writes:
            t0 = time.perf_counter()
            fut = fab.insert(reads, fids)
            fut.add_done_callback(lambda _, t0=t0: ack_ms.append(
                1e3 * (time.perf_counter() - t0)))
            acks.append(fut)
            during.append([fab.submit(q) for q in queries])
        check({a.delta_seq for a in resolve(acks)} ==
              set(range(1, n_writes + 1)), "every write acked in order")
        exact = 0
        for batch in during:
            for res, lo, hi in zip(resolve(batch), lower, upper):
                if res.delta_seq == n_writes:
                    ok = np.array_equal(res.matches, hi)
                    exact += 1
                else:
                    ok = (not (lo & ~res.matches).any()
                          and not (res.matches & ~hi).any())
                check(ok, f"mid-write answer within its watermark "
                      f"(delta_seq {res.delta_seq})")
        got = resolve([fab.submit(q) for q in queries])
        check(same_rows([r.matches for r in got], list(upper)),
              "after every ack: fabric == the union index")
        after = recall(got)
        check(after == HELD_OUT, "held-out files found 8 of 8 after the "
              "writes")
        gather_stats()
        # kill -9 one worker with every read in flight
        futures = [fab.submit(q) for q in queries]
        victim = min(fab.worker_pids())
        os.kill(fab.worker_pids()[victim], signal.SIGKILL)
        got = resolve(futures)
        check(same_rows([r.matches for r in got], list(upper)),
              "across the kill -9 every future resolved == the union")
        deadline = time.perf_counter() + 60
        while fab.n_workers > FABRIC_WORKERS - 1 and \
                time.perf_counter() < deadline:
            time.sleep(0.05)
        check(fab.n_workers == FABRIC_WORKERS - 1, "the fleet lost one")
        gather_stats()
        # compaction with a rolling restart while traffic flows
        free = shutil.disk_usage(work).free
        print(f"phase 8 temp root {work}: {free} bytes free before the "
              f"compaction's save")
        check(free >= SNAPSHOT_ROOM, "room for the merged snapshot")
        stop, rounds = threading.Event(), []

        def traffic() -> None:
            # each round's stats keep the lead worker's last reply before
            # it retires: its peak includes the compaction's
            while not stop.is_set():
                rounds.append([fab.submit(q) for q in queries])
                resolve(rounds[-1])
                gather_stats()

        feeder = threading.Thread(target=traffic, daemon=True)
        feeder.start()
        t0 = time.perf_counter()
        version = fab.compact(f"{work}/merged")
        compact_s = time.perf_counter() - t0
        stop.set()
        feeder.join(timeout=WAIT_S)
        check(version == 1 and fab.version == 1, "compaction -> version 1")
        for batch in rounds:
            check(same_rows([r.matches for r in resolve(batch)],
                            list(upper)),
                  "every answer during the compaction == the union")
        got = resolve([fab.submit(q) for q in queries])
        check(same_rows([r.matches for r in got], list(upper))
              and {r.version for r in got} == {1},
              "after the compaction: version 1 == the union index")
        gather_stats()
        rates["1 worker"] = [rate(flat, upper[:-HELD_OUT]) for _ in range(2)]
        gather_stats()
    finally:
        fab.close()
    check(not torch.cuda.is_initialized(),
          "the gateway never initialised CUDA")
    launches: dict = {}
    for s in seen.values():
        add_launches(launches, s["device"]["launches"])
    check(launches["window_min"] > 0 and launches["gather_planned_rows"] > 0,
          "the workers launched window_min and gather_planned_rows")
    check(launches["insert_planned"] == FABRIC_WORKERS * n_writes,
          "insert_planned launched once per write batch and worker")
    workers = {wid: {
        "pid": s["pid"],
        "query_locations": query_locations_ms(s),
        "max_memory_allocated": s["device"]["max_memory_allocated"],
        "requests_served": s["requests_served"],
        "launches": s["device"]["launches"]} for wid, s in sorted(
            seen.items())}
    print(f"phase 8 process fabric: ok — {FABRIC_WORKERS} worker processes "
          f"over 7a's base snapshot (saved in {inp['save_s']:.3f} s), fleet "
          f"boot {boot_s:.3f} s; {len(queries)} reads == the direct "
          f"service; {n_writes} write batches of the {HELD_OUT} held-out "
          f"files through fabric.insert, ack ms "
          f"{[round(x, 3) for x in sorted(ack_ms)]}, held-out recall "
          f"{before}/{HELD_OUT} -> {after}/{HELD_OUT}, {exact} mid-write "
          f"answers == the union; kill -9 of worker {victim} with "
          f"{len(queries)} reads in flight: all resolved == the union; "
          f"compaction + rolling restart under traffic ({len(rounds)} "
          f"rounds) in {compact_s:.3f} s, version 1 == the union; gateway "
          f"CUDA initialised: {torch.cuda.is_initialized()}; wall "
          f"{time.perf_counter() - t_phase:.3f} s")
    print(f"phase 8 requests a second, all {len(flat)} reads in flight (2 "
          f"workers on the base, 1 worker after the compaction): "
          + json.dumps(rates))
    print("phase 8 workers (query.locations host ms per call, peak device "
          "memory, launches): " + json.dumps(workers, sort_keys=True))
    print(json.dumps({"launches": launches}))


def rambo_traffic(archive, cfg, n_batches: int) -> list:
    """``n_batches`` x 256 reads of phase 7c's traffic (seed 7)."""
    from repro_torch.data import genome

    qrng = np.random.default_rng(7)
    reads = []
    for r in range(n_batches):
        fids = qrng.integers(0, len(archive), size=SERVE_BATCH)
        reads += [genome.extract_reads(archive[int(f)][1], cfg.read_len, 1,
                                       seed=1000 * r + i)[0]
                  for i, f in enumerate(fids)]
    return reads


def rambo_shards_phase(cfg, archive, eng) -> dict:
    """Phase 9b: phase 6's RAMBO index cut into ``RAMBO_SHARDS`` word
    shards ((320, 2^19) int32 each); ``sharded_msmt`` and the scatter
    router (in process, then a process per shard) equal to the unsharded
    ``RamboIndex``; a kill -9 of a shard gives ``ShardDeadError`` on every
    affected future and every later one. Returns the launch counts."""
    from repro_torch.index import shards
    from repro_torch.serving import (GeneSearchService, ScatterConfig,
                                     ScatterGatherRouter, ServiceConfig,
                                     ShardDeadError)

    t_phase = time.perf_counter()
    svc_cfg = ServiceConfig(theta=1.0, max_batch=SERVE_BATCH,
                            backend="idl_probe")
    reads = rambo_traffic(archive, cfg, 2)
    want = uncounted(lambda: direct_answers(
        GeneSearchService(eng, svc_cfg), reads))
    torch.cuda.synchronize()
    reset_launches()
    spec, parts = shards.partition_state(eng, RAMBO_SHARDS)
    check(spec.axis == "words" and all(
        p.words[0].shape == (320, (1 << 20) // RAMBO_SHARDS) for p in parts),
        "RAMBO word shards of (320, 2^19) int32")
    direct = shards.sharded_msmt(spec, parts, np.stack(reads[:SERVE_BATCH]))
    check(same_rows(list(direct.cpu().numpy()), want[:SERVE_BATCH]),
          "sharded_msmt == the unsharded RamboIndex")
    work = scratch_dir("9b", 2 << 30)
    try:
        set_dir = shards.save_shard_set(spec, parts, f"{work}/set")
        del parts
        torch.cuda.empty_cache()
        rates = {}
        with ScatterGatherRouter(set_dir, ScatterConfig(
                service=svc_cfg, device="cuda")) as rt:
            rates["in-process"] = pipelined_rate(rt, reads, want)
        rt = ScatterGatherRouter(set_dir, ScatterConfig(
            procs=True, service=svc_cfg, device="cuda"))
        try:
            rates["procs"] = pipelined_rate(rt, reads, want)
            shard_launches = {}
            for s in rt.stats().values():
                add_launches(shard_launches, s["device"]["launches"])
            futures = [rt.submit(read) for read in reads]
            rt.kill_shard(0)
            ok = dead = 0
            for f, row in zip(futures, want):
                try:
                    res = f.result(timeout=WAIT_S)
                    check(np.array_equal(res.matches, row),
                          "an answer before the kill == the unsharded index")
                    ok += 1
                except ShardDeadError:
                    dead += 1
            check(ok + dead == len(futures), "zero dropped futures")
            late = [rt.submit(read) for read in reads[:SERVE_BATCH]]
            for f in late:
                try:
                    f.result(timeout=WAIT_S)
                    check(False, "an answer after the kill failed loud")
                except ShardDeadError:
                    pass
        finally:
            rt.close()
    finally:
        remove_dir(work)
    launches = add_launches(read_launches(), shard_launches)
    check(launches["window_min"] > 0 and shard_launches["window_min"] > 0,
          "window_min launched by the word shards' hashing")
    check(launches["gather_planned_bits"] == launches["gather_planned_rows"]
          == 0, "the word shards' partials are plain gathers")
    print(f"phase 9b sharded RAMBO: ok — {RAMBO_SHARDS} word shards of "
          f"(320, 2^19) int32; sharded_msmt and the scatter router (in "
          f"process and a process per shard) == the unsharded RamboIndex on "
          f"{len(reads)} reads; requests a second {json.dumps(rates)}; kill "
          f"-9 of shard 0 with {len(futures)} in flight: {ok} answered "
          f"before it, {dead} ShardDeadError, every later future "
          f"ShardDeadError; shard processes' launches "
          f"{json.dumps(shard_launches)}; launches {json.dumps(launches)}; "
          f"wall {time.perf_counter() - t_phase:.3f} s")
    return launches


def main() -> None:
    if sys.argv[1:2] == ["--fabric-gateway"]:
        fabric_gateway(sys.argv[2])     # phase 8's gateway process
        return
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available()"
                         " is False); this script runs only on a GPU")
    if not (SRC / "repro_torch").is_dir():
        raise SystemExit(f"chip_smoke: the port is missing ({SRC / 'repro_torch'})")
    sys.path.insert(0, str(SRC))
    from repro_torch.configs import idl_genesearch
    from repro_torch.data import genome

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    kind, count = build_phase()
    small_shapes_phase(dev)
    cfg = idl_genesearch.full_config()
    archive = genome.synth_archive(cfg.n_files, genome_len=GENOME_LEN,
                                   seed=ARCHIVE_SEED)
    kernels = main_shapes_phase(cfg, archive, dev)
    kernels.append(window_min_phase(dev))
    fcfg = flat_config()
    g = genome.synthesize_genome(FLAT_GENOME_LEN, seed=0)
    kernels += flat_kernels_phase(fcfg, g, dev)
    engine_archive = log_uniform_archive(cfg.n_files, ARCHIVE_SEED)
    kernels += wide_kernels_phase(cfg, engine_archive, dev)
    torch.cuda.empty_cache()
    launches, full_eng = main_path_phase(cfg, archive, dev)
    paths = [launches]
    launches, base = tier_phase(cfg, archive, full_eng, dev)
    paths.append(launches)
    paths.append(live_phase(cfg, archive, base, full_eng, dev))
    # 9a needs phase 3's index; 8 needs the card clear of this process's
    # indexes (each worker holds its own base and delta), so 9a goes first
    paths.append(shards_phase(cfg, archive, full_eng, dev))
    work = fabric_inputs(cfg, archive, base, full_eng)
    del full_eng, base
    torch.cuda.empty_cache()        # the 8 GiB indexes of 3, 7a, 7b freed
    paths.append(fabric_phase(work))
    paths.append(flat_path_phase(fcfg, g, dev))
    torch.cuda.empty_cache()
    paths.append(cobs_path_phase(cfg, engine_archive, dev))
    paths.append(minimizer_phase(cfg, engine_archive, dev))
    torch.cuda.empty_cache()
    launches, rambo = rambo_path_phase(cfg, engine_archive, dev)
    paths.append(launches)
    paths.append(rambo_cache_phase(cfg, engine_archive, rambo))
    paths.append(rambo_shards_phase(cfg, engine_archive, rambo))
    del rambo
    for rec in kernels:
        rec["launches"] = sum(p[rec["name"]] for p in paths)
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print("device ms per kernel call, CUDA-graph replay of 20 calls x 10 "
          "(the JSON line's ms are CUDA events over back-to-back calls, "
          "host wrapper included): " + json.dumps(GRAPH_MS))

    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}))


if __name__ == "__main__":
    main()
