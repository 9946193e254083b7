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
   ``gather_planned_rows`` at a COBS group's W = 16; 2g the fused location
   kernels ``idl_locations32`` (at the bit-sliced path's configuration) and
   ``idl_locations64`` (at the flat filter's) at (256, 230) and (512, 230)
   read batches, ``idl`` DOPH and exact with align on and off and ``rh``,
   and over one 4.6 Mbase genome row (64-bit), the plain version's kernel
   count under ``torch.profiler`` beside the fused kernel's one. Each
   main-shape kernel is timed with CUDA events and by CUDA-graph replay
   (the probe kernels and the gathers' library call also with the L2
   flushed before each call) beside its plain version, its bound (bytes,
   or for the location kernels the larger of bytes and integer
   operations) and, where one exists, a library call (timed both ways
   too);
3. the bit-sliced main path at full width (``full_config``: m = 2^26 rows,
   1024 files, k 31, t 16, L 2^17, η 4): an 8 GiB ``BitSlicedIndex`` built
   through ``build_archive(backend="idl_insert")`` (no numpy run planner
   call allowed) and served through ``GeneSearchService(backend=
   "idl_probe")`` in 256-read batches (no numpy probe planner call
   allowed; one ``gather_planned_rows`` launch per batch); recall must be
   total, the first batch must match the plain ``"torch"`` backend, and
   ``idl_locations32`` must launch once per ``locations`` stage and
   ``window_min`` never (the same holds for ``idl_locations64`` on the
   64-bit paths of phases 4-6 and 7c, 9b, and for the fused kernel of
   each tier); then the mean host time of
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
   ``GeneSearchService``, plus poisoned reads counted; ``idl_locations64``
   once per locations stage and direct call;
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
   subset of a full build; per insert one ``idl_locations64`` and two
   ``window_min`` launches, the mask's sliding minima);
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
   ``ShardDeadError``);
10. the LM family's serving path, plain PyTorch (no kernel of ``csrc/``;
   the path must launch none): 10a ``granite-moe-1b-a400m`` at full
   width cut to 2 layers, f32 with TF32 off, the same seeded weights on
   the card and on the CPU, a 1 x 64 prefill and 4 greedy decode steps
   (logits within rtol/atol 1e-3, every routing index and greedy token
   equal); 10b the same arch at full depth in bf16 (``param_dtype``): an
   8 x 512 prefill through the registry's ``step_fn`` (the grouped MoE
   dispatch) and 32 decode steps at batch 8 (the global dispatch), every
   logit finite, then prefill + one decode step against ``lm_forward`` on
   the extended sequence within rtol/atol 0.05 with capacity 16 (in f32
   of the same weights: in bf16 the two paths flip near-tied routings of
   the last token, on the CPU as on the card; the bf16 gap is printed);
   10c ``granite-20b`` at full width, 4 of its 52 layers, bf16, the same
   work and check (in bf16); prefill and decode times, decode tokens a
   second, the prefill's model-FLOP share of 989 TFLOP/s and the peak
   device memory;
11. the LM family's training path, plain PyTorch (autograd, remat through
   the port's ``remat.checkpoint``, chunked loss, AdamW; no kernel of
   ``csrc/``: the path must launch none): 11a ``granite-moe-1b-a400m`` at
   full width cut to 2 layers, f32 with TF32 off, remat on, a 2 x 128
   batch of the ``idl`` dedup pipeline: ``lm_loss`` and its gradients on
   the card against the CPU (loss rtol 1e-3, each gradient leaf within
   1e-3 of its max |g|, every routing index equal), 3 AdamW steps through
   ``make_train_step`` on both (losses rtol 1e-3, parameters within the
   bound two AdamW runs whose gradients differ by rounding may reach:
   ``adamw_bound``), and ``loop.run`` for 8 steps with a checkpoint every
   4, stopped at 4 and resumed to 8, against an uninterrupted run (losses
   rtol 1e-3, parameters within ``adamw_bound``: the MoE combine's
   ``scatter_add_`` adds in no fixed order on the card); 11b the same arch
   at full depth with bf16 parameters and f32 AdamW moments, remat on,
   ``train_4k`` cut to 4 x 4096 (8 loss chunks), batches from the dedup
   pipeline at vocab 49155: 6 steps through ``loop.run`` (every loss
   finite), the median warm step, tokens a second, the model-FLOP share
   of 989 TFLOP/s, the peak device memory, the device's busy share and top
   operators from ``torch.profiler`` over the last step, then the final
   train state saved as one checkpoint (13.35 GB) and restored, both
   timed, equal bit for bit; 11c ``granite-20b`` at full width, 4 of 52
   layers, 2 x 4096, the same numbers without a checkpoint;
12. the recsys family, plain PyTorch (row gathers, autograd, AdamW; the
   path must launch none of the kernels): 12a ``hash_rows`` under
   ``none``, ``rh`` and ``idl`` on the card equal to the CPU's (negative
   ids, FM's 39 x 2^20 rows), then FM, SASRec, two-tower and MIND at
   their smoke configs and FM at full width (vocab 2^12 a field), f32
   with TF32 off, the same seeded weights on both: the registry's score
   and retrieval steps and the loss within rtol 1e-3, atol 1e-4, each
   gradient leaf within 1e-3 of its max |g|; 12b each arch's
   ``full_config`` (FM 39 x 2^20 x 10, SASRec d 50 / 2 blocks / S 50 /
   2^20 items, two-tower d 256 / towers 1024-512-256 / 2^23 users and
   items, MIND d 64 / 4 interests / 3 iterations / 2^20 items) served
   through the registry's ``step_fn`` on ``serve_p99`` (512),
   ``serve_bulk`` (262,144) and ``retrieval_cand`` (1 x 1,000,000), and
   FM's and SASRec's ``serve_bulk`` again under ``rh`` and ``idl`` row
   hashing: the median warm ms, rows a second, the peak device memory;
   12c one cold and two timed AdamW steps at ``train_batch`` 65,536 for
   each arch (two-tower's tables cut to 2^22 rows): step ms, the
   model-FLOP share of 989 TFLOP/s, the peak memory;
13. the EquiformerV2 GNN, plain PyTorch (the Wigner recursion, segment
   ops, autograd with a checkpoint a layer, AdamW; no kernel): 13a the
   full widths (d_hidden 128, l_max 6, m_max 2, 8 heads) cut to 2 layers
   on a 64-node graph, f32, TF32 off, card against CPU (loss rtol 1e-3,
   each gradient leaf within 1e-3 of its max |g|) and the outputs on the
   card invariant under a rotation of the positions (2e-3); 13b
   ``full_graph_sm`` (2,708 nodes, 10,556 edges, 1,433 features, 7
   classes, all 12 layers), 13c ``molecule`` (128 graphs of 30 nodes / 64
   edges, 12 layers), 13d ``minibatch_lg`` (one 15-10 fanout batch from
   1,024 seeds of a 232,965-node graph, padded to 169,984 nodes and
   168,960 edges, cut to 2 layers): 4 AdamW steps through the registry's
   ``step_fn`` each, the median warm step, the edge-rotation stage
   alone (ms and kernels), the peak memory and the device's busy share
   over the last step under ``torch.profiler``. ``ogb_products`` does not
   run (one edge tensor at its 61.9M edges is 1.55 TB);
14. the last modules, plain PyTorch (the phase must launch none of the
   kernels): 14a ``quantize_int8`` on a seeded (4096, 4096) f32 tensor,
   card against CPU (``q`` equal, ``scale`` bit for bit), one
   ``compress_with_feedback`` round (residual within 1e-6 of its max),
   and ``granite-moe-1b-a400m`` at full width, 2 layers, f32, TF32 off,
   3 AdamW steps through ``make_train_step`` with
   ``make_compression("int8")``, card against CPU within 11a's bounds;
   14b those card steps run with the cyclic collector off, and once their
   state and outputs are dropped ``memory_allocated`` must be back within
   64 MiB of its value before them (and after 11c, with ``free_card``
   collecting nothing, within 64 MiB of the level before 11b); 14c a
   one-process NCCL group, ``make_host_mesh()``, and SASRec's full serve
   state distributed by ``tree_shardings`` (every local shard equal to
   its leaf), the group destroyed after; 14d the dry run's counters at one
   device for FM's and SASRec's ``serve_p99`` (12b) and the Equiformer's
   ``full_graph_sm`` step (13b): ``t_compute``, ``t_memory`` and
   ``t_bound`` beside the measured medians, failing a median more than 5%
   under ``t_compute``.

The phases run in the order 1, 2a-2g, 3, 7a, 7b, 9a (it needs phase 3's
index), 8 (it needs the card clear of this process's indexes), 4, 5, 5b,
6, 7c, 9b, 10 (after 9b has freed the card), 11, 12, 13, 14. Before
phase 2 it profiles one tiny operation, so ``torch.profiler``'s lazy
imports, which would keep the stack they run under in a reference cycle,
happen outside every phase. Phases 8, 9, 11a and
11b print their temp root's free bytes before they save (8 and 9a write
8 GiB snapshots, 11b a 13.35 GB checkpoint; too little room fails the
run) and remove them, and print their wall seconds.

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
import gc
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
    from repro_torch.kernels.idl_locations import kernel as loc_kernel
    from repro_torch.kernels.idl_probe import kernel as probe_kernel
    from repro_torch.kernels.window_min import kernel as wm_kernel

    return [(probe_kernel.NAME, probe_kernel, "launches"),
            (ins_kernel.NAME, ins_kernel, "launches"),
            (wm_kernel.NAME, wm_kernel, "launches"),
            (loc_kernel.NAME32, loc_kernel, "launches32"),
            (loc_kernel.NAME64, loc_kernel, "launches64"),
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


def check_location_launches(launches: dict, stages: dict, extra: int,
                            path: str, kernel: str) -> int:
    """The fused location kernel ``kernel`` (``idl_locations32`` or
    ``idl_locations64``) must launch once for each timed ``locations``
    stage (insert and query batches) and each of the path's ``extra``
    direct location calls, and ``window_min`` never: the rolling MinHash
    runs inside the fused kernel. Returns that count."""
    want = (stages["insert.locations"]["batches"]
            + stages["query.locations"]["batches"] + extra)
    check(launches[kernel] == want and launches["window_min"] == 0,
          f"{kernel} launched {launches[kernel]} times on the {path}, once "
          f"per locations stage ({want}); window_min "
          f"{launches['window_min']} times (0)")
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
    for name in ("gather_planned_rows", "insert_planned", "idl_locations32"):
        check(launches[name] > 0, f"{name} launched on the bit-sliced path")
    check(launches["gather_planned_rows"] == SERVE_BATCHES
          and launches["probe_planned_bits"] == 0
          and launches["gather_planned_bits"] == 0,
          "gather_planned_rows launched once per serve batch, "
          "probe_planned_bits and gather_planned_bits never")
    check(correct == total, f"recall {correct}/{total} is total")
    snap = obs_metrics.DEFAULT.snapshot()
    stages = stage_means(snap, ingest_s, batch_ms)
    fused = check_location_launches(launches, stages, 0, "bit-sliced path",
                                    "idl_locations32")
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
          f"plans); idl_locations32 once per locations stage ({fused}), "
          f"window_min never; serve "
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


# The H100's peak rate of 32-bit integer instructions: its non-tensor
# float32 peak, 67 TFLOP/s counting an FMA as two operations, is 132 SMs x
# 128 lanes x 1.98 GHz of issue, which integer instructions share (IMAD on
# the FMA pipe, the rest on the integer pipe)
INT32_OPS_PER_S = 132 * 128 * 1.98e9
LOC_VARIANTS = {"idl doph align": ("idl", "doph", True),
                "idl doph": ("idl", "doph", False),
                "idl exact align": ("idl", "exact", True),
                "idl exact": ("idl", "exact", False),
                "rh": ("rh", "doph", True)}


def location_ops(cfg, scheme: str, lane32: bool, rows: int, n: int) -> int:
    """The integer operations the location function needs for ``(rows, n)``
    codes, counted by need and not from the kernel's code, in 32-bit
    instruction units (a 64-bit multiply 4; a 64-bit add, shift, xor or
    compare 2): each sub-kmer packed once from the last (a shift and an or)
    and hashed once (η hashes in exact mode, with its DOPH bin otherwise);
    in each kmer's window one compare-and-select a sub-kmer, into its own
    bin (DOPH; three operations with the bin's test) or into each of the η
    minima (exact); the kmer built from its sub-kmers (a shift and an or);
    DOPH's η - 1 densifying rotations over η bins; the η location hashes.
    The count does not depend on the codes: every DOPH kmer densifies."""
    eta, w = cfg.eta, cfg.w
    n_sub, n_k = rows * (n - cfg.t + 1), rows * (n - cfg.k + 1)
    if lane32:
        pack, hash_sub, bin_ops, cmp_sel = 2, 10, 3, 2
        # hash_pair32 26 + range 7 + sums 3; anchor mix 9 + range 7 + scale 1
        loc_j, anchor_j = 36, 17
    else:
        pack, hash_sub, bin_ops, cmp_sel = 4, 28, 8, 4
        # range64: hash64 28 + shift, multiply, shift 8; sums and mask 6
        loc_j, anchor_j = 42, 40
    per_kmer = pack + eta * loc_j
    per_sub = 0
    if scheme == "idl":
        per_kmer += eta * anchor_j
        if cfg.minhash_mode == "exact":
            per_sub = pack + eta * (hash_sub + 2)
            per_kmer += (w - 1) * eta * cmp_sel
        else:
            per_sub = pack + hash_sub + bin_ops
            per_kmer += w * (cmp_sel + 1) + (eta - 1) * eta * 2 * cmp_sel
    return n_sub * per_sub + n_k * per_kmer


def plain_kernel_launches(fn) -> int:
    """Kernels the device ran for one call of ``fn`` under
    ``torch.profiler`` (after a warm-up call)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA)


def time_locations(cfg, codes, scheme: str, lane32: bool, got,
                   graph_calls: int = 20) -> dict:
    """One fused location kernel at ``codes``: CUDA-event and CUDA-graph ms,
    the plain version's ms and kernel count, and the bound (the larger of
    the bytes, codes read once and the locations ``got`` written once, over
    3.35 TB/s, and :func:`location_ops`, the operations the function
    needs, over the card's int32 rate)."""
    from repro_torch.kernels.idl_locations import kernel as loc_kernel

    plain = loc_kernel._PLAIN[(scheme, lane32)]

    def fused():
        return loc_kernel.locations(cfg, codes, scheme, lane32=lane32)

    def eager():
        return plain(cfg, codes)

    t_bytes = 1e3 * (codes.numel() + got.numel() * 8) / HBM_BYTES_PER_S
    ops = location_ops(cfg, scheme, lane32, codes.numel() // codes.shape[-1],
                       codes.shape[-1])
    t_ops = 1e3 * ops / INT32_OPS_PER_S
    return {"ms": cuda_ms(fused, 200 if codes.dim() > 1 else 20),
            "graph_ms": graph_ms(fused, calls=graph_calls),
            "plain_ms": cuda_ms(eager, 20 if codes.dim() > 1 else 3),
            "plain_launches": plain_kernel_launches(eager),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes_ms": t_bytes, "ops_ms": t_ops, "int_ops": ops,
            "library_ms": None}


def locations_phase(cfg32, cfg64, dev) -> list:
    """Phase 2g: the fused location kernels against their plain versions
    (the eager composition, with ``window_min``'s plain version), bit for
    bit: ``idl_locations32`` at ``cfg32`` (the bit-sliced path's) and
    ``idl_locations64`` at ``cfg64`` (the flat filter's), at (256, 230) and
    (512, 230) read batches, ``idl`` DOPH and exact with align on and off
    and ``rh``, and one 4.6 Mbase genome row on the 64-bit kernel; each
    shape timed in the main variant (``idl`` DOPH, aligned) by
    :func:`time_locations`, whose plain-version kernel count stands against
    the fused kernel's one launch. Returns the two kernels' JSON records at
    (256, 230)."""
    import dataclasses

    from repro_torch.kernels.idl_locations import kernel as loc_kernel

    rng = np.random.default_rng(23)
    cases, timed = 0, {}
    for lane32, base in ((True, cfg32), (False, cfg64)):
        name = loc_kernel.NAME32 if lane32 else loc_kernel.NAME64
        for rows in (SERVE_BATCH, INSERT_BATCH):
            codes = torch.as_tensor(rng.integers(0, 4, size=(
                rows, FLAT_READ_LEN), dtype=np.uint8), device=dev)
            for variant, (scheme, mode, align) in LOC_VARIANTS.items():
                cfg = dataclasses.replace(base, minhash_mode=mode, align=align)
                got = loc_kernel.locations(cfg, codes, scheme, lane32=lane32)
                err = max_abs_err(got, loc_kernel._PLAIN[(scheme, lane32)](
                    cfg, codes))
                check(err == 0, f"{name} {variant} at ({rows}, "
                      f"{FLAT_READ_LEN}) == plain (max abs err {err})")
                cases += 1
                if variant == "idl doph align":
                    timed[f"{name} ({rows}, {FLAT_READ_LEN})"] = {
                        "max_abs_err": err,
                        **time_locations(cfg, codes, scheme, lane32, got)}
    # one genome row, as phase 4's legacy path hashes it
    g = torch.as_tensor(rng.integers(0, 4, size=FLAT_GENOME_LEN,
                                     dtype=np.uint8), device=dev)
    got = loc_kernel.locations(cfg64, g, "idl", lane32=False)
    err = max_abs_err(got, loc_kernel._PLAIN[("idl", False)](cfg64, g))
    check(err == 0, f"idl_locations64 over a {FLAT_GENOME_LEN}-base row == "
          f"plain (max abs err {err})")
    timed[f"{loc_kernel.NAME64} ({FLAT_GENOME_LEN},)"] = {
        "max_abs_err": err,
        **time_locations(cfg64, g, "idl", False, got, graph_calls=4)}
    cases += 1
    del g, got
    print(f"phase 2g idl_locations: ok (kernel == plain, tolerance 0: "
          f"bit-exact) — {cases} cases: both widths at ({SERVE_BATCH}, "
          f"{FLAT_READ_LEN}) and ({INSERT_BATCH}, {FLAT_READ_LEN}) x "
          f"{list(LOC_VARIANTS)} (32-bit at m {cfg32.m}, L {cfg32.L}; 64-bit "
          f"at m {cfg64.m}, L {cfg64.L}; k {cfg32.k}, t {cfg32.t}, η "
          f"{cfg32.eta}) and a {FLAT_GENOME_LEN}-base row on the 64-bit "
          f"kernel; one launch each against the plain version's kernels "
          f"under torch.profiler; timed, idl doph align: "
          + json.dumps(timed))
    records = []
    for name in (loc_kernel.NAME32, loc_kernel.NAME64):
        rec = dict(timed[f"{name} ({SERVE_BATCH}, {FLAT_READ_LEN})"])
        GRAPH_MS[name] = rec.pop("graph_ms")
        for key in ("plain_launches", "bytes_ms", "ops_ms", "int_ops"):
            rec.pop(key)
        records.append({"name": name, "route": "cuda",
                        "source": loc_kernel.SOURCE,
                        "replaces": loc_kernel.REPLACES, **rec})
    return records


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
        if name not in ("gather_planned_rows", "gather_planned_bits",
                        "window_min", "idl_locations32"):
            check(count > 0, f"{name} launched on the flat-filter path")
    check(launches["probe_planned_bits"] == queries
          and launches["gather_planned_rows"] == 0
          and launches["gather_planned_bits"] == 0,
          f"probe_planned_bits launched once per flat query ({queries}), "
          f"gather_planned_rows and gather_planned_bits never")
    snap = obs_metrics.DEFAULT.snapshot()
    stages = stage_means(snap, ingest_s, batch_ms)
    # direct location calls: the legacy path's and each batch's probe plan
    fused = check_location_launches(launches, stages, 1 + SERVE_BATCHES,
                                    "flat path", "idl_locations64")
    runs = {op: (obs_metrics.counter_total(snap, "locality.probe_runs",
                                           {"op": op}),
                 obs_metrics.counter_total(snap, "locality.probes",
                                           {"op": op}))
            for op in ("insert", "query")}
    print(f"phase 4 flat IDL Bloom filter: ok — m {cfg.m} bits "
          f"({eng.state.nbytes} B), L {cfg.L}, η {cfg.eta}, k {cfg.k}, t "
          f"{cfg.t}; genome {len(g)} bases (uncut); ingest {ingest_s:.3f} s "
          f"in batches of {INSERT_BATCH} reads (numpy run planner calls "
          f"{planner[0]}); idl_locations64 once per locations stage and "
          f"direct call ({fused}), window_min never; legacy "
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
            "extra_locations": per_query}


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
    for name in (probe, "insert_planned", "idl_locations64"):
        check(launches[name] > 0, f"{name} launched on the {label} path")
    snap = obs_metrics.DEFAULT.snapshot()
    stages = stage_means(snap, ingest_s, served["batch_ms"])
    fused = check_location_launches(launches, stages,
                                    served["extra_locations"],
                                    f"{label} path", "idl_locations64")
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
          f"run planner calls 0); {held_line}idl_locations64 once per "
          f"locations stage ({fused}), window_min never; serve "
          f"{SERVE_BATCHES} x {SERVE_BATCH} reads, "
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
    with fewer bits; per planned insert ``idl_locations64`` launches once
    (the locations, MinHash included) and ``window_min`` twice (the mask's
    two sliding minima). Returns the launch counts."""
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
    check(launches["window_min"] == 2 * n_inserts
          and launches["idl_locations64"] == n_inserts
          and launches["insert_planned"] == n_inserts,
          f"window_min launched twice and idl_locations64 once per minimizer "
          f"insert ({launches['window_min']} and "
          f"{launches['idl_locations64']} for {n_inserts})")
    print(f"phase 5b minimizer ingest: ok — {len(files)} files into a fresh "
          f"COBS index with window_min=16 ({n_inserts} planned inserts, "
          f"window_min {launches['window_min']} launches, two per insert, "
          f"idl_locations64 {launches['idl_locations64']}, one per insert); "
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
    for name in ("gather_planned_rows", "insert_planned", "idl_locations32"):
        check(launches[name] > 0, f"{name} launched on the tier path")
    check(launches["window_min"] == 0, "no window_min on the tier path")
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
    for name in ("gather_planned_rows", "idl_locations32"):
        check(launches[name] > 0, f"{name} launched on the live path")
    check(launches["window_min"] == 0, "no window_min on the live path")
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
    check(launches["gather_planned_bits"] > 0
          and launches["idl_locations64"] > 0 and launches["window_min"] == 0,
          "gather_planned_bits and idl_locations64 launched for the misses, "
          "window_min never")
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
    for name in ("gather_planned_rows", "insert_planned", "idl_locations32"):
        check(launches[name] > 0, f"{name} launched on the sharded path")
    check(shard_launches["gather_planned_rows"] > 0
          and shard_launches["idl_locations32"] > 0
          and launches["window_min"] == 0,
          "every shard process launched the gather and idl_locations32, "
          "window_min never")
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
    check(launches["idl_locations32"] > 0
          and launches["gather_planned_rows"] > 0
          and launches["window_min"] == 0,
          "the workers launched idl_locations32 and gather_planned_rows, "
          "window_min never")
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
    check(launches["idl_locations64"] > 0
          and shard_launches["idl_locations64"] > 0
          and launches["window_min"] == 0,
          "idl_locations64 launched by the word shards' hashing, window_min "
          "never")
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


# -- phase 10: the LM family's serving path (prefill + KV-cache decode) ------

LM_MOE = "granite-moe-1b-a400m"      # 10a, 10b: the MoE arch
LM_DENSE = "granite-20b"             # 10c: the dense arch
LM_CHECK_LAYERS = 2                  # 10a's depth (card vs CPU, f32)
LM_CHECK_SEQ = 64                    # 10a's prompt and 10b/10c's check prompt
LM_CHECK_STEPS = 4                   # 10a's decode steps
LM_DENSE_LAYERS = 4                  # 10c's depth, of granite-20b's 52
LM_BATCH = 8                         # 10b/10c prefill and decode batch
LM_SEQ = 512                         # 10b/10c prefill length
LM_DECODE_STEPS = 32
LM_PREFILL_REPS = 3
LM_SEED = 0
BF16_PEAK_FLOPS = 989e12             # H100 SXM dense bf16 (data sheet)


@contextlib.contextmanager
def recorded_routes():
    """Record each MoE routing call while the block runs: yields a list of
    ``(groups, gate_idx)``, the indices left on their device (no sync)."""
    from repro_torch.models import moe

    route, seen = moe.route, []

    def wrapper(params, x, cfg, groups=1):
        out = route(params, x, cfg, groups)
        seen.append((groups, out[2]))
        return out

    moe.route = wrapper
    try:
        yield seen
    finally:
        moe.route = route


def greedy_decode(model, cfg, tokens, steps: int, max_len: int):
    """Prefill ``tokens`` then ``steps`` greedy decode steps through the
    model's entry points: (prefill logits, [step logits], [tokens fed])."""
    from repro_torch.models import transformer as tf

    with torch.inference_mode():
        logits, cache = tf.lm_prefill(model.params(), tokens, cfg)
        full = model.init_kv_cache(tokens.shape[0], max_len)
        full["k"][:, :, :tokens.shape[1]] = cache["k"]
        full["v"][:, :, :tokens.shape[1]] = cache["v"]
        full["len"] = cache["len"]
        out, fed, nxt = [], [], logits.argmax(-1)
        for _ in range(steps):
            fed.append(nxt)
            step_logits, full = tf.lm_decode_step(model.params(), full, nxt,
                                                  cfg)
            out.append(step_logits)
            nxt = step_logits.argmax(-1)
    return logits, out, fed


def rec_dtype(dtype) -> str:
    return str(dtype).replace("torch.", "")


def tree_map(fn, tree: dict) -> dict:
    return {k: tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def prefill_decode_vs_forward(params: dict, cfg, toks):
    """Prefill ``toks[:, :-1]`` into a bf16 cache, decode ``toks[:, -1]``,
    and run ``lm_forward`` over all of ``toks``: (decode logits, the
    forward's last logits, how many (row, layer) routings of the last
    token differ between the two)."""
    from repro_torch.models import transformer as tf

    b, s = toks.shape[0], toks.shape[1] - 1
    with torch.inference_mode(), recorded_routes() as routes:
        _, cache = tf.lm_prefill(params, toks[:, :-1], cfg)
        kv = tf.init_kv_cache(cfg, b, s + 1, dtype=torch.bfloat16,
                              device=toks.device)
        kv["k"][:, :, :s] = cache["k"]
        kv["v"][:, :, :s] = cache["v"]
        kv["len"] = cache["len"]
        del cache
        n_prefill = len(routes)
        step, _ = tf.lm_decode_step(params, kv, toks[:, -1], cfg)
        n_decode = len(routes)
        fwd, _ = tf.lm_forward(params, toks, cfg)
    flips = 0
    for (_, dec), (_, full) in zip(routes[n_prefill:n_decode],
                                   routes[n_decode:]):
        last = full.reshape(b, s + 1, -1)[:, -1]
        flips += int((dec.reshape(b, -1).sort(-1)[0]
                      != last.sort(-1)[0]).any(-1).sum())
    return step, fwd[:, -1], flips


def lm_card_vs_cpu_phase(dev) -> dict:
    """Phase 10a: ``granite-moe-1b-a400m`` at full width, ``LM_CHECK_LAYERS``
    layers, f32 with TF32 off: the same seeded weights on the card and on
    the CPU, a 1 x ``LM_CHECK_SEQ`` prefill and ``LM_CHECK_STEPS`` greedy
    decode steps; logits within rtol/atol 1e-3, every routing index and
    every greedy token equal."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import transformer as tf

    cfg = dataclasses.replace(configs.get(LM_MOE).make_config(),
                              n_layers=LM_CHECK_LAYERS)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        toks = torch.from_numpy(np.random.default_rng(LM_SEED).integers(
            0, cfg.vocab, (1, LM_CHECK_SEQ)))
        runs = []
        for where in ("cpu", dev):
            model = tf.lm_init(LM_SEED, cfg, device="cpu").to(where)
            with recorded_routes() as routes:
                runs.append((*greedy_decode(
                    model, cfg, toks.to(where), LM_CHECK_STEPS,
                    LM_CHECK_SEQ + LM_CHECK_STEPS), routes))
            del model
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    (cp, cs, cfed, croutes), (gp, gs, gfed, groutes) = runs
    err = 0.0
    for want, got in zip([cp] + cs, [gp] + gs):
        got = got.cpu()
        check(torch.allclose(got, want, rtol=1e-3, atol=1e-3),
              "10a card logits == CPU logits within rtol/atol 1e-3")
        err = max(err, float((got - want).abs().max()))
    check(len(croutes) == len(groutes) == LM_CHECK_LAYERS * (
        1 + LM_CHECK_STEPS), "one routing call per layer and step")
    check(all(cg == gg and torch.equal(ci, gi.cpu())
              for (cg, ci), (gg, gi) in zip(croutes, groutes)),
          "10a every routing index equal on the card and the CPU")
    check(all(torch.equal(c, g.cpu()) for c, g in zip(cfed, gfed))
          and torch.equal(cs[-1].argmax(-1), gs[-1].argmax(-1).cpu()),
          "10a greedy tokens equal on the card and the CPU")
    print(f"phase 10a LM card vs CPU: ok — {LM_MOE} full width (d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads, {cfg.n_kv_heads} KV heads, "
          f"{cfg.moe.n_experts} experts top-{cfg.moe.top_k}, vocab "
          f"{cfg.vocab}), {cfg.n_layers} layers, f32, TF32 off: prefill "
          f"1x{LM_CHECK_SEQ} + {LM_CHECK_STEPS} greedy decode steps; "
          f"max_abs_err {err} (rtol/atol 1e-3); {len(groutes)} routing "
          f"calls' indices equal; greedy tokens "
          f"{[int(t) for t in torch.cat(gfed).cpu()]} equal")
    return {"max_abs_err": err}


def lm_serve_phase(label: str, arch: str, n_layers, dev) -> dict:
    """Phases 10b/10c: ``arch`` at full width (``n_layers`` layers; None =
    full depth) in ``param_dtype``: a ``LM_BATCH`` x ``LM_SEQ`` prefill
    through the registry's serve step (``prefill_32k`` cut to that shape),
    ``LM_DECODE_STEPS`` greedy decode steps through the ``decode_32k``
    step; every logit finite; then, with MoE capacity raised to 16, one
    decode step after a ``LM_CHECK_SEQ``-token prefill equals
    ``lm_forward`` on the extended sequence within rtol/atol 0.05."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.configs import lm_common
    from repro_torch.models import transformer as tf

    spec = configs.get(arch)
    full = spec.make_config()
    cfg = full if n_layers is None else dataclasses.replace(
        full, n_layers=n_layers)
    dtype = lm_common.param_dtype(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = tf.lm_init(LM_SEED, cfg, dtype=dtype, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    reset_launches()
    cell = dataclasses.replace(
        spec.shapes["prefill_32k"],
        meta={"seq": LM_SEQ, "batch": LM_BATCH, "mode": "prefill"})
    prefill = spec.step_fn(cfg, cell)
    decode = spec.step_fn(cfg, spec.shapes["decode_32k"])
    toks = torch.from_numpy(np.random.default_rng(LM_SEED + 1).integers(
        0, cfg.vocab, (LM_BATCH, LM_SEQ))).to(dev)
    params = model.params()
    prefill_ms = []
    with recorded_routes() as routes:
        for _ in range(1 + LM_PREFILL_REPS):        # the first warms up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = prefill(params, {"tokens": toks})
            torch.cuda.synchronize()
            prefill_ms.append(1e3 * (time.perf_counter() - t0))
        n_prefill_routes = len(routes)
        state = {"params": params,
                 "cache": model.init_kv_cache(LM_BATCH,
                                              LM_SEQ + LM_DECODE_STEPS)}
        with torch.inference_mode():
            state["cache"]["k"][:, :, :LM_SEQ] = cache["k"]
            state["cache"]["v"][:, :, :LM_SEQ] = cache["v"]
            state["cache"]["len"] = cache["len"]
        del cache
        finite = bool(torch.isfinite(logits).all())
        nxt = logits.argmax(-1)
        decode_ms = []
        for _ in range(LM_DECODE_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = decode(state, {"tokens": nxt})
            torch.cuda.synchronize()
            decode_ms.append(1e3 * (time.perf_counter() - t0))
            state["cache"] = out["cache"]
            finite &= bool(torch.isfinite(out["logits"]).all())
            nxt = out["logits"].argmax(-1)
    peak = torch.cuda.max_memory_allocated()
    launches = read_launches()
    check(finite, f"{label} every prefill and decode logit finite")
    check(int(state["cache"]["len"][0]) == LM_SEQ + LM_DECODE_STEPS,
          f"{label} the cache holds the prompt and every decoded token")
    check(not any(launches.values()),
          f"{label} the LM path launches none of the gene-search kernels")
    if cfg.moe is not None:
        groups = cfg.moe.dispatch_groups
        check(n_prefill_routes == cfg.n_layers * (1 + LM_PREFILL_REPS)
              and all(g == groups for g, _ in routes[:n_prefill_routes]),
              f"{label} the {LM_BATCH * LM_SEQ}-token prefill takes the "
              f"grouped dispatch ({groups} groups)")
        check(all(g == 1 for g, _ in routes[n_prefill_routes:]),
              f"{label} the batch-{LM_BATCH} decode takes the global dispatch")
    del state, out, logits

    # prefill + one decode step == forward on the extended sequence. In
    # bf16 the two paths' matmuls round differently and, with routing,
    # flip near-tied top-k choices of the last token in some layers (on
    # the CPU as on the card), so a routed arch is held to the check in
    # f32 of the same weights (the reference's test runs f32 weights over
    # a bf16 cache) and its bf16 gap is printed with its flips
    ccfg = cfg if cfg.moe is None else dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=16.0))
    ctoks = toks[:, :LM_CHECK_SEQ + 1]
    step, fwd, flips = prefill_decode_vs_forward(params, ccfg, ctoks)
    native = {"dtype": rec_dtype(dtype),
              "max_abs_err": float((step - fwd).abs().max())}
    if cfg.moe is not None:
        native["routing_flips"] = flips
    checked = native
    if cfg.moe is not None:
        del step, fwd
        f32 = tree_map(lambda p: p.float(), params)
        step, fwd, f32_flips = prefill_decode_vs_forward(f32, ccfg, ctoks)
        del f32
        checked = {"dtype": "float32", "max_abs_err": float(
            (step - fwd).abs().max()), "routing_flips": f32_flips}
    check(bool(torch.isfinite(step).all()) and torch.allclose(
        step, fwd, rtol=0.05, atol=0.05),
          f"{label} prefill + one decode step == lm_forward on the extended "
          f"sequence within rtol/atol 0.05 ({checked})")
    del model, params, step, fwd

    prefill_s = min(prefill_ms[1:]) / 1e3
    flops = lm_common.lm_model_flops(cfg, cell)
    dec_ms = float(np.mean(decode_ms[1:]))
    rec = {
        "arch": arch, "layers": f"{cfg.n_layers} of {full.n_layers}",
        "dtype": rec_dtype(dtype),
        "params": cfg.param_count(), "active_params": cfg.active_param_count(),
        "init_s": round(init_s, 3),
        "prefill_ms": [round(x, 3) for x in prefill_ms],
        "prefill_tokens_per_s": round(LM_BATCH * LM_SEQ / prefill_s, 1),
        "prefill_model_flops": flops,
        "prefill_mfu_bf16_peak": round(flops / prefill_s / BF16_PEAK_FLOPS, 4),
        "decode_ms_first": round(decode_ms[0], 3),
        "decode_ms_per_step": round(dec_ms, 3),
        "decode_tokens_per_s": round(LM_BATCH * 1e3 / dec_ms, 1),
        "consistency_checked": checked,
        "consistency_in_param_dtype": native,
        "max_memory_allocated": peak,
    }
    print(f"phase {label} LM serving: ok — {arch} full width (d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads, {cfg.n_kv_heads} KV heads, "
          f"vocab {cfg.vocab}), depth {rec['layers']} layers, "
          f"{rec['dtype']}; prefill {LM_BATCH}x{LM_SEQ} and "
          f"{LM_DECODE_STEPS} decode steps at batch {LM_BATCH}, every logit "
          f"finite; prefill + decode == forward within 0.05 in "
          f"{checked['dtype']} (max_abs_err {checked['max_abs_err']}); "
          + json.dumps(rec, sort_keys=True))
    return rec


# -- phase 11: the LM family's training path --------------------------------

TRAIN_CHECK_BATCH = 2                # 11a: batch x seq, f32, TF32 off
TRAIN_CHECK_SEQ = 128
TRAIN_CHECK_STEPS = 3                # 11a's AdamW steps, card and CPU
TRAIN_LOOP_STEPS = 8                 # 11a's loop, resumed from step 4
TRAIN_LOOP_CKPT_EVERY = 4
TRAIN_SEQ = 4096                     # train_4k's sequence
TRAIN_MOE_BATCH = 4                  # 11b: train_4k cut from 256 x 4096
TRAIN_DENSE_BATCH = 2                # 11c
TRAIN_STEPS = 6                      # 11b/11c: 0 cold, 1-4 timed, 5 profiled
TRAIN_TOP_OPS = 8


def tree_leaves(tree: dict) -> list:
    from repro_torch.train import optimizer as opt_mod

    return opt_mod.tree_leaves(tree)


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Same dtype, shape and bytes."""
    return (a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8)))


def adamw_bound(lr: float, steps: int) -> float:
    """How far two runs of ``steps`` AdamW steps (b1 0.9, b2 0.95) may put
    one weight apart when their gradients differ by rounding only: a
    gradient within rounding of zero may take opposite signs, and each
    step moves a weight by at most lr * |m_hat / sqrt(v_hat)| (<= 1.008
    for up to 8 steps, Cauchy-Schwarz), so 2 * lr * 1.008 a step, plus
    1e-5 of f32 rounding."""
    return 2 * lr * 1.008 * steps + 1e-5


def lm_train_pipeline(cfg, batch: int, seq: int, dev):
    """An ``idl``-dedup ``LMPipeline`` at ``cfg``'s vocab and its
    ``next_batch`` as tensors on ``dev``."""
    from repro_torch.data import lm_pipeline

    pipe = lm_pipeline.LMPipeline(lm_pipeline.LMPipelineConfig(
        vocab=cfg.vocab, seq_len=seq, global_batch=batch, dedup=True,
        dedup_scheme="idl"))

    def next_batch():
        return {k: torch.from_numpy(v).to(dev)
                for k, v in pipe.next_batch().items()}
    return pipe, next_batch


def lm_train_card_vs_cpu_phase(dev) -> dict:
    """Phase 11a: ``granite-moe-1b-a400m`` at full width, ``LM_CHECK_LAYERS``
    layers, f32 with TF32 off, remat on, batch ``TRAIN_CHECK_BATCH`` x
    ``TRAIN_CHECK_SEQ`` from the dedup pipeline: ``lm_loss`` and its
    gradients on the card and on the CPU (loss rtol 1e-3, each gradient
    leaf within 1e-3 of its max |g|, every routing index equal),
    ``TRAIN_CHECK_STEPS`` AdamW steps through ``make_train_step`` (losses
    rtol 1e-3, parameters within ``adamw_bound``), then ``loop.run`` for
    ``TRAIN_LOOP_STEPS`` steps with a checkpoint every
    ``TRAIN_LOOP_CKPT_EVERY``, stopped at 4 and resumed to 8 in a fresh
    loop: its losses and final parameters against an uninterrupted run's
    (losses rtol 1e-3, parameters within ``adamw_bound`` over 8 steps: the
    MoE combine's ``scatter_add_`` adds in no fixed order on the card)."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.configs import lm_common
    from repro_torch.models import transformer as tf
    from repro_torch.train import loop, train_state as ts

    t_phase = time.perf_counter()
    spec = configs.get(LM_MOE)
    cfg = dataclasses.replace(spec.make_config(), n_layers=LM_CHECK_LAYERS)
    check(cfg.remat, "11a trains with remat on")
    cell = dataclasses.replace(spec.shapes["train_4k"], meta={
        "seq": TRAIN_CHECK_SEQ, "batch": TRAIN_CHECK_BATCH})
    nchunks = lm_common.loss_chunks_for(cell)

    def loss_fn(p, b):
        return tf.lm_loss(p, b, cfg, loss_chunks=nchunks)

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    reset_launches()
    try:
        params = {"cpu": tf.lm_init(LM_SEED, cfg, device="cpu").params()}
        params[dev] = tree_map(lambda p: p.to(dev), params["cpu"])
        pipe, _ = lm_train_pipeline(cfg, TRAIN_CHECK_BATCH, TRAIN_CHECK_SEQ,
                                    "cpu")
        batches = [{k: torch.from_numpy(v) for k, v in
                    pipe.next_batch().items()} for _ in range(
            1 + TRAIN_CHECK_STEPS)]
        grads, routes = {}, {}
        for where in ("cpu", dev):
            with recorded_routes() as seen:
                loss, metrics, g = ts.value_and_grad(
                    loss_fn, params[where],
                    {k: v.to(where) for k, v in batches[0].items()})
            grads[where] = (loss.cpu(), tree_map(lambda x: x.cpu(), g))
            routes[where] = [(n, i.cpu()) for n, i in seen]
        (closs, cgrad), (gloss, ggrad) = grads["cpu"], grads[dev]
        check(torch.allclose(gloss, closs, rtol=1e-3, atol=0),
              f"11a loss on the card == CPU within rtol 1e-3 "
              f"({float(gloss)} vs {float(closs)})")
        grad_err = 0.0
        for name, c, g in zip(ckpt_keys(cgrad), tree_leaves(cgrad),
                              tree_leaves(ggrad)):
            scale = max(float(c.abs().max()), 1e-30)
            rel = float((g - c).abs().max()) / scale
            check(rel <= 1e-3, f"11a gradient {name} on the card within 1e-3 "
                  f"of its max |g| ({rel})")
            grad_err = max(grad_err, rel)
        check(len(routes["cpu"]) == len(routes[dev]) > 0 and all(
            n == m and torch.equal(a, b) for (n, a), (m, b) in zip(
                routes["cpu"], routes[dev])),
              "11a every routing index equal on the card and the CPU")

        opt = lm_common.choose_optimizer(cfg)
        lr = 3e-4                       # choose_optimizer's AdamW below 30e9
        step = ts.make_train_step(loss_fn, opt)
        states, losses = {}, {}
        for where in ("cpu", dev):
            state = ts.TrainState.create(
                tree_map(torch.clone, params[where]), opt)
            losses[where] = []
            for b in batches[1:]:
                state, m = step(state, {k: v.to(where) for k, v in b.items()})
                losses[where].append(float(m["loss"]))
            states[where] = state
        check(np.allclose(losses[dev], losses["cpu"], rtol=1e-3, atol=0),
              f"11a {TRAIN_CHECK_STEPS} AdamW steps' losses on the card == "
              f"CPU within rtol 1e-3 ({losses[dev]} vs {losses['cpu']})")
        step_err = max(max_abs_err(g.cpu(), c) for c, g in zip(
            tree_leaves(states["cpu"].params), tree_leaves(states[dev].params)))
        check(step_err <= adamw_bound(lr, TRAIN_CHECK_STEPS),
              f"11a parameters after {TRAIN_CHECK_STEPS} AdamW steps within "
              f"{adamw_bound(lr, TRAIN_CHECK_STEPS)} ({step_err})")
        del states, grads, cgrad, ggrad

        work = scratch_dir("11a", 4 << 30)
        try:
            runs = []
            for total, ckpt_dir in ((TRAIN_LOOP_STEPS, None),
                                    (TRAIN_LOOP_CKPT_EVERY, work),
                                    (TRAIN_LOOP_STEPS, work)):
                pipe, next_batch = lm_train_pipeline(
                    cfg, TRAIN_CHECK_BATCH, TRAIN_CHECK_SEQ, dev)
                runs.append(loop.run(
                    loss_fn, params[dev], opt, next_batch, loop.LoopConfig(
                        total_steps=total, ckpt_every=TRAIN_LOOP_CKPT_EVERY,
                        ckpt_dir=ckpt_dir, log_every=1),
                    pipeline_state=pipe.state_dict,
                    restore_pipeline=pipe.load_state_dict))
        finally:
            remove_dir(work)
        whole, first, resumed = runs
        check(first.resumed_from is None and int(first.state.step) ==
              TRAIN_LOOP_CKPT_EVERY and resumed.resumed_from ==
              TRAIN_LOOP_CKPT_EVERY and int(resumed.state.step) ==
              TRAIN_LOOP_STEPS, "11a the second loop resumed from step "
              f"{TRAIN_LOOP_CKPT_EVERY}")
        want = [h["loss"] for h in whole.history[TRAIN_LOOP_CKPT_EVERY:]]
        got = [h["loss"] for h in resumed.history]
        check(len(got) == len(want) and np.allclose(got, want, rtol=1e-3,
                                                    atol=0),
              f"11a resumed losses == uninterrupted within rtol 1e-3 "
              f"({got} vs {want})")
        resume_err = max(max_abs_err(a, b) for a, b in zip(
            tree_leaves(whole.state.params), tree_leaves(resumed.state.params)))
        check(resume_err <= adamw_bound(lr, TRAIN_LOOP_STEPS),
              f"11a resumed parameters within {adamw_bound(lr, TRAIN_LOOP_STEPS)}"
              f" of the uninterrupted run's ({resume_err})")
        losses_all = [h["loss"] for h in whole.history]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    launches = read_launches()
    check(not any(launches.values()),
          "11a the training path launches none of the gene-search kernels")
    rec = {"loss_rel_err": abs(float(gloss) - float(closs)) / abs(float(closs)),
           "grad_max_rel_err": grad_err, "routing_calls": len(routes[dev]),
           "step_losses_card": losses[dev], "step_losses_cpu": losses["cpu"],
           "params_max_abs_err_after_steps": step_err,
           "loop_losses": losses_all,
           "resumed_loss_max_abs_err": max(abs(a - b) for a, b in zip(got, want)),
           "resumed_params_max_abs_err": resume_err,
           "wall_s": round(time.perf_counter() - t_phase, 3)}
    print(f"phase 11a LM training card vs CPU: ok — {LM_MOE} full width, "
          f"{cfg.n_layers} layers, f32, TF32 off, remat, batch "
          f"{TRAIN_CHECK_BATCH}x{TRAIN_CHECK_SEQ}, {nchunks} loss chunks: "
          f"loss and gradients (1e-3), {TRAIN_CHECK_STEPS} AdamW steps "
          f"(parameters within {adamw_bound(lr, TRAIN_CHECK_STEPS)}), a "
          f"{TRAIN_LOOP_STEPS}-step loop resumed from step "
          f"{TRAIN_LOOP_CKPT_EVERY} (parameters within "
          f"{adamw_bound(lr, TRAIN_LOOP_STEPS)}); " + json.dumps(rec))
    return rec


def ckpt_keys(tree: dict) -> list:
    from repro_torch.train import checkpoint as ckpt_mod

    return list(ckpt_mod._flatten_with_paths(tree))


def warm_profiler() -> None:
    """Profile one tiny operation, before any phase. ``torch.profiler``'s
    first use imports ``torch._dynamo`` lazily, and that import leaves the
    frames of the stack it ran under in a reference cycle: inside a
    profiled train step, the loop's frame and its train state, held until
    the cyclic collector runs."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones(1, device="cuda").add_(1)
    torch.cuda.synchronize()


def profiled_step(step_fn, state, batch) -> tuple:
    """One train step under ``torch.profiler``: (its output, wall ms,
    device busy ms (the kernels' time, the profiler table's "Self CUDA
    time total"), kernels run, and the top ``TRAIN_TOP_OPS`` operators by
    the device time of the kernels they launched, as [name, ms, calls])."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step_fn(state, batch)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    ev = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    kernels = [e for e in ev if e.device_type == DeviceType.CUDA]
    ops = [e for e in ev if e.device_type == DeviceType.CPU]
    top = sorted(ops, key=dev_us, reverse=True)[:TRAIN_TOP_OPS]
    return (out, wall, sum(dev_us(e) for e in kernels) / 1e3,
            sum(e.count for e in kernels),
            [[e.key[:60], round(dev_us(e) / 1e3, 3), e.count] for e in top])


def lm_train_phase(label: str, arch: str, n_layers, batch: int, dev,
                   checkpoint: bool) -> dict:
    """Phases 11b/11c: ``arch`` at full width (``n_layers`` layers; None =
    full depth) in ``param_dtype`` with f32 AdamW moments
    (``choose_optimizer``) and remat on, ``train_4k`` cut to ``batch`` x
    ``TRAIN_SEQ`` (``loss_chunks_for`` the cut cell), batches from an
    ``idl``-dedup ``LMPipeline``: ``TRAIN_STEPS`` steps through
    ``loop.run`` (every loss finite), the median warm step, tokens a
    second, the model-FLOP share of 989 TFLOP/s, the peak device memory
    and one profiled warm step; with ``checkpoint``, the final state saved
    and restored through ``CheckpointManager`` (bit for bit)."""
    import dataclasses
    import os

    from repro_torch import configs
    from repro_torch.configs import lm_common
    from repro_torch.models import transformer as tf
    from repro_torch.train import checkpoint as ckpt_mod, loop

    t_phase = time.perf_counter()
    spec = configs.get(arch)
    full = spec.make_config()
    cfg = full if n_layers is None else dataclasses.replace(
        full, n_layers=n_layers)
    check(cfg.remat, f"{label} trains with remat on")
    dtype = lm_common.param_dtype(cfg)
    cell = dataclasses.replace(spec.shapes["train_4k"], meta={
        "seq": TRAIN_SEQ, "batch": batch})
    nchunks = lm_common.loss_chunks_for(cell)
    opt = lm_common.choose_optimizer(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = tf.lm_init(LM_SEED, cfg, dtype=dtype, device=dev).params()
    pipe, next_batch = lm_train_pipeline(cfg, batch, TRAIN_SEQ, dev)
    step_ms, prof = [], {}

    def timed(step_fn):
        def run(state, b):
            if len(step_ms) == TRAIN_STEPS - 1:
                (out, prof["wall_ms"], prof["busy_ms"], prof["kernels"],
                 prof["top"]) = profiled_step(step_fn, state, b)
                return out
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step_fn(state, b)
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t0))
            return out
        return run

    reset_launches()
    result = loop.run(
        lambda p, b: tf.lm_loss(p, b, cfg, loss_chunks=nchunks), params,
        opt, next_batch, loop.LoopConfig(total_steps=TRAIN_STEPS,
                                         log_every=1),
        step_fn_transform=timed)
    peak = torch.cuda.max_memory_allocated()
    launches = read_launches()
    del params
    losses = [h["loss"] for h in result.history]
    check(len(losses) == TRAIN_STEPS and all(np.isfinite(losses)),
          f"{label} every loss finite ({losses})")
    check(not any(launches.values()),
          f"{label} the training path launches none of the gene-search kernels")
    state = result.state
    del result
    warm = float(np.median(step_ms[1:]))
    tokens = batch * TRAIN_SEQ
    flops = lm_common.lm_model_flops(cfg, cell)
    state_bytes = sum(x.numel() * x.element_size() for x in
                      ckpt_mod._flatten_with_paths(state).values())
    rec = {
        "arch": arch, "layers": f"{cfg.n_layers} of {full.n_layers}",
        "dtype": rec_dtype(dtype), "optimizer": "adamw" if "mu" in
        state.opt_state else "adafactor",
        "params": cfg.param_count(), "active_params": cfg.active_param_count(),
        "batch": batch, "seq": TRAIN_SEQ, "loss_chunks": nchunks,
        "dropped_docs": pipe.dropped, "losses": losses,
        "step_ms": [round(x, 3) for x in step_ms],
        "warm_step_ms_median": round(warm, 3),
        "tokens_per_s": round(tokens / warm * 1e3, 1),
        "model_flops_per_step": flops,
        "mfu_bf16_peak": round(flops / (warm / 1e3) / BF16_PEAK_FLOPS, 4),
        "max_memory_allocated": peak, "train_state_bytes": state_bytes,
        "profiled_step_wall_ms": round(prof["wall_ms"], 3),
        "profiled_step_device_busy_ms": round(prof["busy_ms"], 3),
        "device_busy_share": round(prof["busy_ms"] / prof["wall_ms"], 4),
        "profiled_step_kernels": prof["kernels"],
        "top_device_ops": prof["top"],
    }
    if checkpoint:
        work = scratch_dir(label, state_bytes + (2 << 30))
        try:
            mgr = ckpt_mod.CheckpointManager(work)
            t0 = time.perf_counter()
            mgr.save(int(state.step), state, blocking=True)
            rec["ckpt_save_s"] = round(time.perf_counter() - t0, 3)
            rec["ckpt_bytes"] = os.path.getsize(
                os.path.join(work, f"ckpt_{int(state.step):08d}.npz"))
            t0 = time.perf_counter()
            restored, manifest = mgr.restore(state)
            torch.cuda.synchronize()
            rec["ckpt_restore_s"] = round(time.perf_counter() - t0, 3)
        finally:
            remove_dir(work)
        saved = ckpt_mod._flatten_with_paths(state)
        back = ckpt_mod._flatten_with_paths(restored)
        check(manifest["step"] == TRAIN_STEPS and list(saved) == list(back)
              and all(bits_equal(saved[k], back[k]) for k in saved),
              f"{label} the restored train state equals the saved one bit "
              f"for bit")
        rec["ckpt_leaves"] = len(saved)
        del restored, back, saved
    del state
    rec["wall_s"] = round(time.perf_counter() - t_phase, 3)
    print(f"phase {label} LM training: ok — {arch} full width (d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads, vocab {cfg.vocab}), depth "
          f"{rec['layers']} layers, {rec['dtype']} parameters, f32 moments, "
          f"remat, {batch}x{TRAIN_SEQ} from the idl dedup pipeline, "
          f"{TRAIN_STEPS} steps through loop.run, every loss finite"
          + (", checkpoint restored bit for bit" if checkpoint else "")
          + "; " + json.dumps(rec, sort_keys=True))
    return rec


# -- phase 12: the recsys family (IDL row hashing), served and trained -------

RECSYS_ARCHS = ["fm", "sasrec", "two-tower-retrieval", "mind"]
RECSYS_CHECK_BATCH = 64              # 12a: card vs CPU batch
RECSYS_CHECK_CANDS = 4096            # 12a: retrieval candidates
FM_CHECK_VOCAB = 1 << 12             # 12a: FM full width, vocab cut from 2^20
RECSYS_SCORE_CANDS = 100             # the reference's score_inputs: (B, 100)
RECSYS_SERVE_REPS = 5                # 12b: warm calls a cell, after one cold
RECSYS_TRAIN_STEPS = 3               # 12c: 0 cold, 1-2 timed
TWO_TOWER_TRAIN_ROWS = 1 << 22       # 12c: two-tower tables, cut from 2^23
RECSYS_SEED = 0


def recsys_init(arch: str):
    from repro_torch.models import recsys

    return {"fm": recsys.fm_init, "sasrec": recsys.sasrec_init,
            "two-tower-retrieval": recsys.twotower_init,
            "mind": recsys.mind_init}[arch]


def recsys_loss(arch: str):
    from repro_torch.models import recsys

    return {"fm": recsys.fm_loss, "sasrec": recsys.sasrec_loss,
            "two-tower-retrieval": recsys.twotower_loss,
            "mind": recsys.mind_loss}[arch]


def recsys_inputs(arch: str, cfg, kind: str, n: int, seed: int) -> dict:
    """Host (numpy) inputs of one cell of ``arch``: a ``train`` batch of n
    from ``SessionGenerator``, a ``score`` batch of n requests (sessions
    with planted locality, ``RECSYS_SCORE_CANDS`` candidates each) or a
    ``retrieval`` query against n candidates, shaped as the reference's
    ``*_inputs``."""
    from repro_torch.data import recsys_pipeline

    gen = recsys_pipeline.SessionGenerator(recsys_pipeline.RecsysSynthConfig(
        n_items=getattr(cfg, "n_items", 1 << 20),
        n_users=getattr(cfg, "n_users", 1 << 18),
        session_len=getattr(cfg, "seq_len", 50), seed=seed))
    rng = np.random.default_rng(seed + 1)
    i32 = np.int32
    if arch == "fm":
        if kind == "train":
            return gen.fm_batch(n, cfg.n_sparse, cfg.vocab_per_field)
        if kind == "score":
            return {"feats": gen.fm_batch(n, cfg.n_sparse,
                                          cfg.vocab_per_field)["feats"]}
        return {"context": rng.integers(0, cfg.vocab_per_field,
                                        (1, cfg.n_sparse)).astype(i32),
                "cands": rng.integers(0, cfg.vocab_per_field, n).astype(i32)}
    if arch == "two-tower-retrieval":
        if kind == "retrieval":
            b = gen.retrieval_batch(n, cfg.n_user_feats, cfg.n_item_feats)
            return {"user_feats": b["user_feats"], "cand_feats": b["cand_feats"]}
        return gen.twotower_batch(n, cfg.n_user_feats, cfg.n_item_feats)
    if kind == "train":
        return gen.sasrec_batch(n) if arch == "sasrec" else gen.mind_batch(n)
    rows = 1 if kind == "retrieval" else n
    out = {"seq": gen.sessions(rows),
           "cands": (rng.integers(0, cfg.n_items, n) if kind == "retrieval"
                     else rng.integers(0, cfg.n_items,
                                       (n, RECSYS_SCORE_CANDS))).astype(i32)}
    if arch == "mind":
        out["mask"] = np.ones(out["seq"].shape, np.float32)
    return out


def free_card() -> None:
    """Return the card's cached blocks, so a phase starts on a clear card
    and its peak memory is its own. An earlier phase's tensors are freed
    with their last reference: the port's checkpoints leave no reference
    cycle (phase 14b checks it with the collector off)."""
    torch.cuda.empty_cache()


def on_device(batch: dict, dev) -> dict:
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def grad_rel_errs(want: dict, got: dict) -> dict:
    """Per leaf: max |got - want| over the leaf's max |want|."""
    out = {}
    for name, w, g in zip(ckpt_keys(want), tree_leaves(want),
                          tree_leaves(got)):
        scale = max(float(w.abs().max()), 1e-30)
        out[name] = float((g.cpu() - w).abs().max()) / scale
    return out


def recsys_card_vs_cpu_phase(dev) -> dict:
    """Phase 12a: each recsys arch at its smoke config, and FM at full
    width with ``vocab_per_field`` cut to ``FM_CHECK_VOCAB``, f32 with TF32
    off, the same seeded weights on the card and the CPU: ``hash_rows``
    under the three schemes (negative ids and FM's full row count
    included) exactly equal; the registry's score and retrieval steps and
    the loss within rtol 1e-3, atol 1e-4; each gradient leaf within 1e-3
    of its max |g|."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import recsys
    from repro_torch.train import train_state as ts

    t_phase = time.perf_counter()
    rng = np.random.default_rng(RECSYS_SEED)
    ids = torch.from_numpy(np.concatenate([
        rng.integers(-(1 << 31), 1 << 31, 1 << 16),
        rng.integers(0, 1 << 20) + np.arange(-4096, 4096)]).astype(np.int32))
    full_rows = 39 * (1 << 20)
    for scheme in ("none", "rh", "idl"):
        for n_rows in (1 << 10, 8 * 256, full_rows):
            want = recsys.hash_rows(ids, n_rows, scheme)
            got = recsys.hash_rows(ids.to(dev), n_rows, scheme)
            check(got.dtype == torch.int32 and torch.equal(got.cpu(), want),
                  f"12a hash_rows {scheme} at {n_rows} rows equal on the "
                  f"card and the CPU")
    cases = [(a, configs.get(a).make_smoke_config()) for a in RECSYS_ARCHS]
    cases.append(("fm", dataclasses.replace(
        configs.get("fm").make_config(), vocab_per_field=FM_CHECK_VOCAB)))
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    reset_launches()
    recs = []
    try:
        for arch, cfg in cases:
            spec = configs.get(arch)
            params = {"cpu": recsys_init(arch)(RECSYS_SEED, cfg,
                                               device="cpu")}
            params[dev] = tree_map(lambda p: p.to(dev), params["cpu"])
            rec = {"arch": cfg.name}
            for cell in ("serve_p99", "retrieval_cand"):
                kind = spec.shapes[cell].meta["mode"]
                n = RECSYS_CHECK_BATCH if kind == "score" else \
                    RECSYS_CHECK_CANDS
                host = recsys_inputs(arch, cfg, kind, n, RECSYS_SEED + 2)
                step = spec.step_fn(cfg, spec.shapes[cell])
                want = step(params["cpu"], on_device(host, "cpu"))
                got = step(params[dev], on_device(host, dev)).cpu()
                check(torch.allclose(got, want, rtol=1e-3, atol=1e-4),
                      f"12a {cfg.name} {kind} on the card == CPU within "
                      f"rtol 1e-3, atol 1e-4")
                rec[f"{kind}_max_abs_err"] = float((got - want).abs().max())
            host = recsys_inputs(arch, cfg, "train", RECSYS_CHECK_BATCH,
                                 RECSYS_SEED + 3)
            if arch == "sasrec":
                host["pos"][:, :2] = -1            # masked positions

            def loss_fn(p, b):
                return recsys_loss(arch)(p, b, cfg)
            out = {w: ts.value_and_grad(loss_fn, params[w],
                                        on_device(host, w))
                   for w in ("cpu", dev)}
            (closs, _, cgrad), (gloss, _, ggrad) = out["cpu"], out[dev]
            check(torch.allclose(gloss.cpu(), closs, rtol=1e-3, atol=1e-4),
                  f"12a {cfg.name} loss on the card == CPU within rtol 1e-3 "
                  f"({float(gloss)} vs {float(closs)})")
            errs = grad_rel_errs(cgrad, ggrad)
            for name, e in errs.items():
                check(e <= 1e-3, f"12a {cfg.name} gradient {name} on the "
                      f"card within 1e-3 of its max |g| ({e})")
            rec.update(loss_rel_err=abs(float(gloss) - float(closs))
                       / max(abs(float(closs)), 1e-30),
                       grad_max_rel_err=max(errs.values()))
            recs.append(rec)
            del params, out, cgrad, ggrad
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    launches = read_launches()
    check(not any(launches.values()),
          "12a the recsys path launches none of the gene-search kernels")
    print(f"phase 12a recsys card vs CPU: ok ({nvidia_smi()}) — hash_rows "
          f"none/rh/idl equal at 1024, 2048 and {full_rows} rows; the four "
          f"smoke configs and FM full width (vocab {FM_CHECK_VOCAB} a "
          f"field), f32, TF32 off: score and retrieval rtol 1e-3 atol 1e-4, "
          f"loss rtol 1e-3, gradients within 1e-3 of each leaf's max; wall "
          f"{time.perf_counter() - t_phase:.3f} s; " + json.dumps(recs))
    return {"cases": recs}


def timed_calls(fn, reps: int) -> list:
    """Host wall ms of ``reps`` calls of ``fn``, each ended by a sync."""
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t0))
    return out


def recsys_serve_phase(dev) -> dict:
    """Phase 12b: each arch's ``full_config`` (published widths, random
    seeded weights, f32) served through the registry's ``step_fn`` on its
    three serve cells: ``serve_p99`` (512 requests), ``serve_bulk``
    (262,144) and ``retrieval_cand`` (1 query x 1,000,000 candidates).
    Per cell: one cold call, the median of ``RECSYS_SERVE_REPS`` warm
    calls, rows (candidates) a second and the peak device memory; every
    score finite. FM and SASRec also serve ``serve_bulk`` under
    ``hash_scheme`` ``rh`` and ``idl`` with the same weights (the paper's
    row locality on the gather; reported, not judged)."""
    import dataclasses

    from repro_torch import configs

    t_phase = time.perf_counter()
    check(not torch.backends.cuda.matmul.allow_tf32, "12b f32 without TF32")
    recs = []
    reset_launches()
    for arch in RECSYS_ARCHS:
        spec = configs.get(arch)
        cfg = spec.make_config()
        free_card()
        params = recsys_init(arch)(RECSYS_SEED, cfg, device=dev)
        param_bytes = sum(x.numel() * x.element_size()
                          for x in tree_leaves(params))
        runs = [(c, "none") for c in ("serve_p99", "serve_bulk",
                                      "retrieval_cand")]
        if arch in ("fm", "sasrec"):
            runs += [("serve_bulk", "rh"), ("serve_bulk", "idl")]
        for cell_name, scheme in runs:
            cell = spec.shapes[cell_name]
            ccfg = dataclasses.replace(cfg, hash_scheme=scheme)
            kind = cell.meta["mode"]
            n = cell.meta["candidates"] if kind == "retrieval" else \
                cell.meta["batch"]
            t0 = time.perf_counter()
            batch = on_device(recsys_inputs(arch, ccfg, kind, n,
                                            RECSYS_SEED + 4), dev)
            inputs_s = time.perf_counter() - t0
            step = spec.step_fn(ccfg, cell)
            torch.cuda.reset_peak_memory_stats()
            out = {}

            def call():
                out["scores"] = step(params, batch)
            cold = timed_calls(call, 1)[0]
            warm = timed_calls(call, RECSYS_SERVE_REPS)
            peak = torch.cuda.max_memory_allocated()
            scores = out["scores"]
            want = (n,) if kind == "retrieval" else (n,) if arch in (
                "fm", "two-tower-retrieval") else (n, RECSYS_SCORE_CANDS)
            check(tuple(scores.shape) == want and bool(
                torch.isfinite(scores).all()),
                  f"12b {arch} {cell_name} {scheme}: scores of shape {want}, "
                  f"all finite")
            med = float(np.median(warm))
            recs.append({
                "arch": arch, "cell": cell_name, "hash_scheme": scheme,
                "rows": n, "cold_ms": round(cold, 3),
                "warm_ms": [round(x, 3) for x in warm],
                "warm_ms_median": round(med, 3),
                "rows_per_s": round(n / med * 1e3, 1),
                "max_memory_allocated": peak, "param_bytes": param_bytes,
                "inputs_host_s": round(inputs_s, 3),
                "model_flops": spec.model_flops_fn(ccfg, cell)})
            del batch, out, scores
        del params
    launches = read_launches()
    check(not any(launches.values()),
          "12b the recsys path launches none of the gene-search kernels")
    torch.cuda.empty_cache()
    print(f"phase 12b recsys serving: ok ({nvidia_smi()}) — full configs "
          f"(fm 39 x 2^20 x 10; sasrec d 50, 2 blocks, S 50, 2^20 items; "
          f"two-tower d 256, towers 1024-512-256, 2^23 users and items; mind "
          f"d 64, 4 interests, 3 iterations, S 50, 2^20 items), f32, through "
          f"the registry's step_fn, every score finite; wall "
          f"{time.perf_counter() - t_phase:.3f} s; " + json.dumps(recs))
    return {"cells": recs}


def recsys_train_phase(dev) -> dict:
    """Phase 12c: each arch's ``full_config`` (two-tower's tables cut to
    ``TWO_TOWER_TRAIN_ROWS`` rows each), f32 parameters and AdamW moments,
    ``RECSYS_TRAIN_STEPS`` steps through the registry's ``train_batch``
    ``step_fn`` at batch 65,536 from ``SessionGenerator``: every loss
    finite, the median warm step, the model-FLOP share of 989 TFLOP/s and
    the peak device memory."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.train import optimizer as opt_mod, train_state as ts

    t_phase = time.perf_counter()
    check(not torch.backends.cuda.matmul.allow_tf32, "12c f32 without TF32")
    recs = []
    reset_launches()
    for arch in RECSYS_ARCHS:
        spec = configs.get(arch)
        cfg = spec.make_config()
        reduced = []
        if arch == "two-tower-retrieval":
            cfg = dataclasses.replace(cfg, n_users=TWO_TOWER_TRAIN_ROWS,
                                      n_items=TWO_TOWER_TRAIN_ROWS)
            reduced.append(f"user and item tables 2^23 -> "
                           f"{TWO_TOWER_TRAIN_ROWS} rows each (at 2^23, "
                           f"17.2 GB of tables, their dense gradients, two "
                           f"AdamW moments and the update come to 86 GB "
                           f"before temporaries)")
        cell = spec.shapes["train_batch"]
        b = cell.meta["batch"]
        free_card()
        torch.cuda.reset_peak_memory_stats()
        state = ts.TrainState.create(
            recsys_init(arch)(RECSYS_SEED, cfg, device=dev),
            opt_mod.adamw(1e-3))
        step = spec.step_fn(cfg, cell)
        batches = [on_device(recsys_inputs(arch, cfg, "train", b,
                                           RECSYS_SEED + 10 + i), dev)
                   for i in range(RECSYS_TRAIN_STEPS)]
        losses, ms = [], []
        for batch in batches:
            out = {}

            def call():
                out["state"], out["m"] = step(state, batch)
            ms.append(timed_calls(call, 1)[0])
            losses.append(float(out["m"]["loss"]))
        peak = torch.cuda.max_memory_allocated()
        check(all(np.isfinite(losses)) and int(state.step) ==
              RECSYS_TRAIN_STEPS, f"12c {arch} every loss finite ({losses})")
        warm = float(np.median(ms[1:]))
        flops = spec.model_flops_fn(cfg, cell)
        recs.append({
            "arch": arch, "batch": b, "reduced": reduced, "losses": losses,
            "step_ms": [round(x, 3) for x in ms],
            "warm_step_ms_median": round(warm, 3),
            "examples_per_s": round(b / warm * 1e3, 1),
            "model_flops_per_step": flops,
            "mfu_bf16_peak": flops / (warm / 1e3) / BF16_PEAK_FLOPS,
            "max_memory_allocated": peak,
            "param_count": sum(x.numel() for x in tree_leaves(state.params))})
        del state, batches, out
    launches = read_launches()
    check(not any(launches.values()),
          "12c the recsys path launches none of the gene-search kernels")
    torch.cuda.empty_cache()
    print(f"phase 12c recsys training: ok ({nvidia_smi()}) — full configs, "
          f"f32 parameters and AdamW moments, TF32 off, train_batch 65,536 "
          f"through the registry's step_fn, {RECSYS_TRAIN_STEPS} steps each "
          f"(0 cold), every loss finite; wall "
          f"{time.perf_counter() - t_phase:.3f} s; " + json.dumps(recs))
    return {"cells": recs}


# -- phase 13: the EquiformerV2 GNN, trained -------------------------------

EQ_CHECK_LAYERS = 2                  # 13a: full widths, 2 of 12 layers
EQ_CHECK_NODES, EQ_CHECK_EDGES = 64, 256
EQ_STEPS = 4                         # 13b-d: 0 cold, 1-2 timed, 3 profiled
EQ_ROT_REPS = 3                      # edge-rotation stage timings
MINIBATCH_LAYERS = 2                 # 13d: depth cut from 12 (memory)
MINIBATCH_SEEDS = 1024               # minibatch_lg: 15-10 fanout from 1,024
MINIBATCH_FANOUT = [15, 10]
REDDIT_NODES = 232_965               # minibatch_lg's graph (Reddit)
REDDIT_FULL_EDGES = 114_615_892
REDDIT_EDGES = REDDIT_FULL_EDGES // 10   # cut for the host CSR build
EQ_SEED = 0


def random_rotation(seed: int) -> torch.Tensor:
    """A 3x3 rotation: QR of a gaussian, det fixed to +1."""
    q, r = np.linalg.qr(np.random.default_rng(seed).normal(size=(3, 3)))
    q = q * np.sign(np.diag(r))
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    return torch.from_numpy(q.astype(np.float32))


def equiformer_card_vs_cpu_phase(dev) -> dict:
    """Phase 13a: the Equiformer at full widths (d_hidden 128, l_max 6,
    m_max 2, 8 heads) cut to ``EQ_CHECK_LAYERS`` layers, 8 classes, remat
    on, f32 with TF32 off, on a ``synth_graph`` of ``EQ_CHECK_NODES``
    nodes: the same seeded weights on the card and the CPU, loss within
    rtol 1e-3 and each gradient leaf within 1e-3 of its max |g|; on the
    card, the outputs invariant under a global rotation of the positions
    (rtol and atol 2e-3)."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.data import graph_pipeline
    from repro_torch.models import equiformer as eq
    from repro_torch.train import train_state as ts

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(configs.get("equiformer-v2").make_config(),
                              n_layers=EQ_CHECK_LAYERS, n_classes=8)
    check(cfg.remat, "13a trains with remat on")
    host = graph_pipeline.full_batch(graph_pipeline.synth_graph(
        EQ_CHECK_NODES, EQ_CHECK_EDGES, n_classes=8, seed=EQ_SEED))
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    reset_launches()
    try:
        params = {"cpu": eq.equiformer_init(EQ_SEED, cfg, device="cpu")}
        params[dev] = tree_map(lambda p: p.to(dev), params["cpu"])

        def loss_fn(p, b):
            return eq.equiformer_loss(p, b, cfg)
        out = {w: ts.value_and_grad(loss_fn, params[w], on_device(host, w))
               for w in ("cpu", dev)}
        (closs, _, cgrad), (gloss, _, ggrad) = out["cpu"], out[dev]
        check(torch.allclose(gloss.cpu(), closs, rtol=1e-3, atol=0),
              f"13a loss on the card == CPU within rtol 1e-3 ({float(gloss)} "
              f"vs {float(closs)})")
        errs = grad_rel_errs(cgrad, ggrad)
        for name, e in errs.items():
            check(e <= 1e-3, f"13a gradient {name} on the card within 1e-3 "
                  f"of its max |g| ({e})")
        batch = on_device(host, dev)
        with torch.no_grad():
            out1 = eq.equiformer_forward(params[dev], batch, cfg)
            rotated = dict(batch, positions=batch["positions"]
                           @ random_rotation(5).T.to(dev))
            out2 = eq.equiformer_forward(params[dev], rotated, cfg)
        inv_err = float((out1 - out2).abs().max())
        check(torch.allclose(out1, out2, rtol=2e-3, atol=2e-3),
              f"13a outputs on the card invariant under a rotation of the "
              f"positions within 2e-3 ({inv_err})")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    launches = read_launches()
    check(not any(launches.values()),
          "13a the GNN path launches none of the gene-search kernels")
    rec = {"loss_rel_err": abs(float(gloss) - float(closs)) / abs(
        float(closs)), "grad_max_rel_err": max(errs.values()),
        "rotation_invariance_max_abs_err": inv_err,
        "wall_s": round(time.perf_counter() - t_phase, 3)}
    print(f"phase 13a equiformer card vs CPU: ok ({nvidia_smi()}) — full "
          f"widths (d_hidden {cfg.d_hidden}, l_max {cfg.l_max}, m_max "
          f"{cfg.m_max}, {cfg.n_heads} heads), {cfg.n_layers} layers, remat, "
          f"f32, TF32 off, {EQ_CHECK_NODES} nodes / {EQ_CHECK_EDGES} edges: "
          f"loss rtol 1e-3, gradients within 1e-3 of each leaf's max, "
          f"rotation invariance on the card within 2e-3; " + json.dumps(rec))
    return rec


def edge_rotation_stage(ccfg, batch) -> dict:
    """The edge-rotation stage alone (``rotation_to_z`` + the Wigner
    recursion, once per forward): median host ms of ``EQ_ROT_REPS``
    synced calls, and the device kernels of one call under the
    profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import equiformer as eq

    args = (batch["positions"], batch["src"].long(), batch["dst"].long(), ccfg)
    ms = timed_calls(lambda: eq._edge_rotations(*args), EQ_ROT_REPS)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eq._edge_rotations(*args)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    return {"edge_rotation_ms": [round(x, 3) for x in ms],
            "edge_rotation_ms_median": round(float(np.median(ms)), 3),
            "edge_rotation_kernels": sum(e.count for e in kernels)}


def equiformer_cell_phase(label: str, cell_name: str, host_batch: dict,
                          n_layers: int, reduced: list, dev,
                          setup_s: float) -> dict:
    """Phases 13b-13d: the Equiformer's ``full_config`` (``n_layers`` of
    its 12 layers; d_hidden 128, l_max 6, m_max 2, 8 heads, remat) in f32
    with TF32 off, on the cell's config (its ``d_feat`` and classes),
    ``EQ_STEPS`` AdamW steps through the registry's ``step_fn``: every
    loss finite, the median warm step, the edge-rotation stage alone, the
    peak device memory and the device's busy share over the last step
    under ``torch.profiler``."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.configs import equiformer_v2
    from repro_torch.models import equiformer as eq
    from repro_torch.train import optimizer as opt_mod, train_state as ts

    t_phase = time.perf_counter()
    spec = configs.get("equiformer-v2")
    cfg = dataclasses.replace(spec.make_config(), n_layers=n_layers)
    check(cfg.remat and not torch.backends.cuda.matmul.allow_tf32,
          f"{label} trains with remat on, f32 without TF32")
    cell = spec.shapes[cell_name]
    ccfg = equiformer_v2.cell_config(cfg, cell)
    free_card()
    torch.cuda.reset_peak_memory_stats()
    batch = on_device(host_batch, dev)
    n, e = batch["node_mask"].shape[0], batch["src"].shape[0]
    state = ts.TrainState.create(eq.equiformer_init(EQ_SEED, ccfg, device=dev),
                                 opt_mod.adamw(1e-3))
    step = spec.step_fn(cfg, cell)
    reset_launches()
    losses, ms, prof = [], [], {}
    for i in range(EQ_STEPS):
        if i == EQ_STEPS - 1:
            (out, prof["wall_ms"], prof["busy_ms"], prof["kernels"],
             prof["top"]) = profiled_step(step, state, batch)
        else:
            out = {}

            def call():
                out["r"] = step(state, batch)
            ms.append(timed_calls(call, 1)[0])
            out = out["r"]
        state, m = out
        losses.append(float(m["loss"]))
    rot = edge_rotation_stage(ccfg, batch)
    peak = torch.cuda.max_memory_allocated()
    launches = read_launches()
    check(len(losses) == EQ_STEPS and all(np.isfinite(losses)),
          f"{label} every loss finite ({losses})")
    check(not any(launches.values()),
          f"{label} the GNN path launches none of the gene-search kernels")
    check((n, e) == (cell.meta["nodes"], cell.meta["edges"]),
          f"{label} the batch has the cell's {cell.meta['nodes']} nodes and "
          f"{cell.meta['edges']} edges")
    warm = float(np.median(ms[1:]))
    flops = spec.model_flops_fn(ccfg, cell)
    rec = {
        "cell": cell_name, "layers": f"{n_layers} of 12", "nodes": n,
        "edges": e, "real_edges": int(host_batch["edge_mask"].sum()),
        "real_nodes": int(host_batch["node_mask"].sum()),
        "d_feat": ccfg.d_feat, "classes": ccfg.n_classes,
        "reduced": reduced, "host_setup_s": round(setup_s, 3),
        "losses": losses, "step_ms": [round(x, 3) for x in ms],
        "warm_step_ms_median": round(warm, 3),
        **rot,
        "edge_rotation_share_of_step": round(
            rot["edge_rotation_ms_median"] / warm, 4),
        "model_flops_per_step": flops,
        "mfu_bf16_peak": flops / (warm / 1e3) / BF16_PEAK_FLOPS,
        "max_memory_allocated": peak,
        "profiled_step_wall_ms": round(prof["wall_ms"], 3),
        "profiled_step_device_busy_ms": round(prof["busy_ms"], 3),
        "device_busy_share": round(prof["busy_ms"] / prof["wall_ms"], 4),
        "profiled_step_kernels": prof["kernels"],
        "top_device_ops": prof["top"],
        "wall_s": round(time.perf_counter() - t_phase, 3)}
    del state, batch, out
    torch.cuda.empty_cache()
    print(f"phase {label} equiformer {cell_name}: ok ({nvidia_smi()}) — "
          f"full widths, {rec['layers']} layers, remat, f32, TF32 off, "
          f"{n} nodes / {e} edges, {EQ_STEPS} AdamW steps through the "
          f"registry's step_fn, every loss finite; "
          + json.dumps(rec, sort_keys=True))
    return rec


def equiformer_phases(dev) -> list:
    """Phases 13b-13d, each at its cell's sizes: ``full_graph_sm`` (a
    Cora-sized ``synth_graph`` with 1,433 features and 7 classes),
    ``molecule`` (128 graphs of 30 nodes / 64 edges) and ``minibatch_lg``
    (one 15-10 fanout batch from 1,024 seeds of a 232,965-node graph,
    padded to the cell's nodes and edges, at ``MINIBATCH_LAYERS``
    layers). ``ogb_products`` does not run: one (E, 49, 128) f32 edge
    tensor at its 61.9M edges is 1.55 TB."""
    from repro_torch import configs
    from repro_torch.data import graph_pipeline

    shapes = configs.get("equiformer-v2").shapes
    recs = []
    meta = shapes["full_graph_sm"].meta
    t0 = time.perf_counter()
    g = graph_pipeline.synth_graph(meta["nodes"], meta["edges"],
                                   d_feat=meta["d_feat"],
                                   n_classes=meta["classes"], seed=EQ_SEED)
    recs.append(equiformer_cell_phase(
        "13b", "full_graph_sm", graph_pipeline.full_batch(g), 12, [], dev,
        time.perf_counter() - t0))
    meta = shapes["molecule"].meta
    t0 = time.perf_counter()
    mol = graph_pipeline.molecule_batch(
        meta["graphs"], meta["nodes"] // meta["graphs"],
        meta["edges"] // meta["graphs"], seed=EQ_SEED)
    recs.append(equiformer_cell_phase("13c", "molecule", mol, 12, [], dev,
                                      time.perf_counter() - t0))
    meta = shapes["minibatch_lg"].meta
    t0 = time.perf_counter()
    g = graph_pipeline.synth_graph(REDDIT_NODES, REDDIT_EDGES,
                                   n_classes=meta["classes"], seed=EQ_SEED)
    loader = graph_pipeline.FanoutLoader(g, MINIBATCH_SEEDS, MINIBATCH_FANOUT,
                                         meta["nodes"], meta["edges"],
                                         seed=EQ_SEED)
    batch = loader.next_batch()
    del g, loader
    recs.append(equiformer_cell_phase(
        "13d", "minibatch_lg", batch, MINIBATCH_LAYERS,
        [f"depth 12 -> {MINIBATCH_LAYERS} layers (remat keeps one "
         f"(N, 49, 128) f32 node tensor a layer, 4.26 GB, but one layer's "
         f"recompute and backward hold ~60 GB: its saved edge and node "
         f"tensors and the gradient buffers, 4.2 GB each; 4 layers ran out "
         f"of the card's 80 GB)",
         f"graph edges {REDDIT_FULL_EDGES} -> {REDDIT_EDGES} (Reddit's "
         f"edge count cut 10x for the host CSR build; ~49 in-edges a node "
         f"still saturate the 15-10 fanout, so the padded batch keeps the "
         f"cell's shape)"],
        dev, time.perf_counter() - t0))
    return recs

# -- phase 14: int8 compression, the freed train state, the mesh, roofline --

INT8_SIDE = 4096                     # 14a: a (4096, 4096) f32 tensor
INT8_STEPS = 3                       # 14a: AdamW steps with int8 gradients
C1_SLACK = 64 << 20                  # 14b / 11c: bytes left after a drop
ROOFLINE_CELLS = [("fm", "serve_p99"), ("sasrec", "serve_p99"),
                  ("equiformer-v2", "full_graph_sm")]


def int8_card_steps(cfg, params_cpu, batches, loss_fn, dev) -> tuple:
    """``INT8_STEPS`` int8-compressed AdamW steps of ``loss_fn`` on the
    card from ``params_cpu``: (losses, final parameters on the CPU). The
    state and outputs die with this frame."""
    from repro_torch.distributed import collectives
    from repro_torch.train import optimizer as opt_mod, train_state as ts

    step = ts.make_train_step(
        loss_fn, opt_mod.adamw(3e-4),
        grad_compression=collectives.make_compression("int8"))
    state = ts.TrainState.create(tree_map(lambda p: p.to(dev), params_cpu),
                                 opt_mod.adamw(3e-4))
    losses = []
    for b in batches:
        state, m = step(state, {k: v.to(dev) for k, v in b.items()})
        losses.append(float(m["loss"]))
    return losses, tree_map(lambda p: p.cpu(), state.params)


def int8_phase(dev) -> dict:
    """Phases 14a and 14b: ``quantize_int8`` on a seeded (4096, 4096) f32
    tensor, card against CPU (``q`` equal, ``scale`` bit for bit); one
    ``compress_with_feedback`` round (residual within 1e-6 of its max);
    ``granite-moe-1b-a400m`` at full width, ``LM_CHECK_LAYERS`` layers,
    f32, TF32 off, ``INT8_STEPS`` steps through ``make_train_step`` with
    ``make_compression("int8")`` on the card and the CPU (losses rtol 1e-3,
    parameters within ``adamw_bound``, as 11a). 14b: the card's steps run
    with the cyclic collector off; once their state and outputs are
    dropped, ``memory_allocated`` must be back within ``C1_SLACK`` of its
    value before them."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.configs import lm_common
    from repro_torch.distributed import collectives
    from repro_torch.models import transformer as tf
    from repro_torch.train import optimizer as opt_mod, train_state as ts

    t_phase = time.perf_counter()
    reset_launches()
    gen = torch.Generator().manual_seed(LM_SEED)
    x = torch.randn((INT8_SIDE, INT8_SIDE), generator=gen)
    q_cpu, s_cpu = collectives.quantize_int8(x)
    q_dev, s_dev = collectives.quantize_int8(x.to(dev))
    check(torch.equal(q_dev.cpu(), q_cpu) and bits_equal(s_dev.cpu(), s_cpu),
          "14a quantize_int8 on the card == CPU: q equal, scale bit for bit")
    grads = {"w": x, "b": torch.randn((INT8_SIDE,), generator=gen)}
    resid = {}
    for where in ("cpu", dev):
        ef = collectives.init_error_feedback(
            tree_map(lambda g: g.to(where), grads))
        _, ef = collectives.compress_with_feedback(
            tree_map(lambda g: g.to(where), grads), ef)
        resid[where] = tree_map(lambda r: r.cpu(), ef.residual)
    resid_err = max(
        float((resid[dev][k] - resid["cpu"][k]).abs().max())
        / max(float(resid["cpu"][k].abs().max()), 1e-30) for k in grads)
    check(resid_err <= 1e-6, f"14a compress_with_feedback residual on the "
          f"card within 1e-6 of its max ({resid_err})")
    del x, q_cpu, s_cpu, q_dev, s_dev, grads, resid, ef

    spec = configs.get(LM_MOE)
    cfg = dataclasses.replace(spec.make_config(), n_layers=LM_CHECK_LAYERS)
    cell = dataclasses.replace(spec.shapes["train_4k"], meta={
        "seq": TRAIN_CHECK_SEQ, "batch": TRAIN_CHECK_BATCH})
    nchunks = lm_common.loss_chunks_for(cell)

    def loss_fn(p, b):
        return tf.lm_loss(p, b, cfg, loss_chunks=nchunks)

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    gc_was = gc.isenabled()
    try:
        params = tf.lm_init(LM_SEED, cfg, device="cpu").params()
        pipe, _ = lm_train_pipeline(cfg, TRAIN_CHECK_BATCH, TRAIN_CHECK_SEQ,
                                    "cpu")
        batches = [{k: torch.from_numpy(v) for k, v in
                    pipe.next_batch().items()} for _ in range(INT8_STEPS)]
        step = ts.make_train_step(
            loss_fn, opt_mod.adamw(3e-4),
            grad_compression=collectives.make_compression("int8"))
        state = ts.TrainState.create(tree_map(torch.clone, params),
                                     opt_mod.adamw(3e-4))
        cpu_losses = []
        for b in batches:
            state, m = step(state, b)
            cpu_losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        gc.disable()
        before = torch.cuda.memory_allocated()
        card_losses, card_params = int8_card_steps(cfg, params, batches,
                                                   loss_fn, dev)
        torch.cuda.synchronize()
        after = torch.cuda.memory_allocated()
    finally:
        if gc_was:
            gc.enable()
        torch.backends.cuda.matmul.allow_tf32 = tf32
    check(np.allclose(card_losses, cpu_losses, rtol=1e-3, atol=0),
          f"14a {INT8_STEPS} int8-compressed AdamW steps' losses on the card "
          f"== CPU within rtol 1e-3 ({card_losses} vs {cpu_losses})")
    step_err = max(max_abs_err(g, c) for c, g in zip(
        tree_leaves(state.params), tree_leaves(card_params)))
    bound = adamw_bound(3e-4, INT8_STEPS)
    check(step_err <= bound, f"14a parameters after {INT8_STEPS} int8 steps "
          f"within {bound} ({step_err})")
    print(f"phase 14b memory_allocated before the card's int8 steps "
          f"{before}, after their state and outputs were dropped with the "
          f"collector off {after}")
    check(after - before <= C1_SLACK, f"14b the train state is freed without "
          f"the cyclic collector ({after - before} bytes left, at most "
          f"{C1_SLACK})")
    launches = read_launches()
    check(not any(launches.values()),
          "14a/14b launch none of the gene-search kernels")
    rec = {"q_equal": True, "scale_bits_equal": True,
           "ef_residual_rel_err": resid_err, "losses_card": card_losses,
           "losses_cpu": cpu_losses, "params_max_abs_err": step_err,
           "params_bound": bound, "memory_allocated_before": before,
           "memory_allocated_after_drop": after,
           "wall_s": round(time.perf_counter() - t_phase, 3)}
    print(f"phase 14a/14b int8 compression and the freed train state: ok — "
          f"quantize_int8 on ({INT8_SIDE}, {INT8_SIDE}) f32, {LM_MOE} full "
          f"width, {cfg.n_layers} layers, f32, TF32 off, {INT8_STEPS} "
          f"int8-compressed AdamW steps card vs CPU; " + json.dumps(rec))
    return rec


def mesh_phase(dev) -> dict:
    """Phase 14c: a one-process NCCL group (a local ``HashStore``),
    ``make_host_mesh()`` over the card, and SASRec's full-config serve
    state distributed by ``tree_shardings``: every local shard is the
    whole leaf on the card, equal to the source. The group is destroyed
    at the end."""
    import torch.distributed as dist
    from torch.distributed.tensor import Shard, distribute_tensor

    from repro_torch import configs
    from repro_torch.configs import base
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import recsys

    t_phase = time.perf_counter()
    reset_launches()
    spec = configs.get("sasrec")
    cfg = spec.make_config()
    cell = spec.shapes["serve_p99"]
    params = recsys.sasrec_init(RECSYS_SEED, cfg, device=dev)
    check(list(base.tree_paths(params)) == list(base.tree_paths(
        spec.abstract_state(cfg, cell))), "14c the serve state's paths are "
          "abstract_state's")
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = mesh_mod.make_host_mesh()
        shardings = base.tree_shardings(
            mesh, params, lambda p, s: spec.state_spec_fn(cfg, p, s))
        leaves = base.tree_paths(params)
        sharded = 0
        for path, leaf in leaves.items():
            placements = shardings[path].placements
            local = distribute_tensor(leaf, mesh, list(placements)).to_local()
            check(local.device == leaf.device and torch.equal(local, leaf),
                  f"14c {path}: the local shard is the whole leaf on the card")
            sharded += any(isinstance(p, Shard) for p in placements)
        mesh_shape = tuple(mesh.shape)
    finally:
        dist.destroy_process_group()
    check(not dist.is_initialized(), "14c the group is destroyed")
    launches = read_launches()
    check(not any(launches.values()),
          "14c launches none of the gene-search kernels")
    rec = {"mesh": mesh_shape, "leaves": len(leaves),
           "leaves_with_shard_placements": sharded,
           "wall_s": round(time.perf_counter() - t_phase, 3)}
    print(f"phase 14c the mesh on the card: ok — make_host_mesh() over an "
          f"NCCL group of 1, SASRec's full serve state distributed by "
          f"tree_shardings, every local shard equal to its leaf; "
          + json.dumps(rec))
    return rec


def roofline_phase(serve: dict, eq_recs: list) -> dict:
    """Phase 14d: the dry run's counters (``count_cell`` on meta tensors)
    at one device for FM's and SASRec's ``serve_p99`` (timed by 12b) and
    the Equiformer's ``full_graph_sm`` train step (timed by 13b), beside
    the measured medians. ``t_compute`` charges the counted FLOPs at the
    bf16 dense peak while these cells run f32, so it is a lower bound: a
    measured time more than 5% under it fails (a miscount). ``t_memory``
    counts every operator's bytes unfused, so L2 hits can beat it: a
    measured time under it is printed as the count's overstatement."""
    from repro_torch import configs
    from repro_torch.launch import dryrun
    from repro_torch.roofline import analysis

    t_phase = time.perf_counter()
    reset_launches()
    measured = {(r["arch"], r["cell"]): r["warm_ms_median"]
                for r in serve["cells"] if r["hash_scheme"] == "none"}
    measured.update({("equiformer-v2", r["cell"]): r["warm_step_ms_median"]
                     for r in eq_recs})
    rows = []
    for arch, cell_name in ROOFLINE_CELLS:
        spec = configs.get(arch)
        cfg = spec.make_config()
        cell = spec.shapes[cell_name]
        counts = dryrun.count_cell(spec, cfg, cell)
        roof = analysis.Roofline(
            arch=arch, shape=cell_name, mesh="one", chips=1,
            flops_per_chip=counts["flops"], bytes_per_chip=counts["bytes"],
            coll_bytes_per_chip=None, coll_breakdown={},
            model_flops=spec.model_flops_fn(cfg, cell))
        ms = measured[arch, cell_name]
        t_ms = {k: 1e3 * getattr(roof, k)
                for k in ("t_compute", "t_memory", "t_bound")}
        check(ms >= 0.95 * t_ms["t_compute"],
              f"14d {arch} {cell_name}: measured {ms} ms is not more than 5% "
              f"under t_compute {t_ms['t_compute']} ms")
        rows.append({"arch": arch, "cell": cell_name, "measured_ms": ms,
                     "t_compute_ms": t_ms["t_compute"],
                     "t_memory_ms": t_ms["t_memory"],
                     "t_bound_ms": t_ms["t_bound"],
                     "bottleneck": roof.bottleneck,
                     "flops": counts["flops"], "bytes": counts["bytes"],
                     "count_source": counts["count_source"],
                     "measured_over_t_bound": ms / t_ms["t_bound"],
                     "t_memory_overstated_by": (
                         t_ms["t_memory"] / ms if ms < t_ms["t_memory"]
                         else None)})
    launches = read_launches()
    check(not any(launches.values()),
          "14d launches none of the gene-search kernels")
    print(f"phase 14d roofline against the card: ok ({nvidia_smi()}) — "
          f"counts at one device on meta tensors, peaks "
          f"{analysis.PEAK_FLOPS:.3e} FLOP/s bf16 and {analysis.HBM_BW:.3e} "
          f"B/s, every measured median at or above 0.95 t_compute; wall "
          f"{time.perf_counter() - t_phase:.3f} s; " + json.dumps(rows))
    return {"cells": rows}


# -- phase 15: the sharded step: DTensor state over a one-card mesh ----------

SHARDED_SERVE_REPS = 10              # 15b: timed serve calls a side


def sharded_phase(dev, roof: dict) -> dict:
    """Phase 15: the registry's steps run sharded, plain PyTorch (no kernel
    of ``csrc/``). A one-process NCCL group and ``make_host_mesh()`` (one
    card); each step runs once on plain tensors and once on DTensors laid
    out by the arch's spec functions, under the cell's rules
    (``cell_rules``, ``sharded_step``). 15a ``granite-moe-1b-a400m`` at
    full width, ``LM_CHECK_LAYERS`` layers, f32, TF32 off: 3 AdamW steps
    each side on the same batches, losses rtol 1e-3 and parameters within
    ``adamw_bound`` (11a's bounds), every routing index equal; 15b SASRec's
    ``serve_p99`` (512 requests, full config): scores rtol 1e-3, atol
    1e-6. Each step is timed on both sides (host wall, synced), and the
    difference printed as DTensor's overhead. 15c the dry run's count of
    14d's three cells on the sharded step (``count_sharded`` on meta
    tensors over this mesh): per-device FLOPs, bytes, collective bytes (0
    on one device) and memory beside 14d's measured medians."""
    import dataclasses

    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch import configs
    from repro_torch.configs import base, lm_common
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import dryrun, mesh as mesh_mod
    from repro_torch.models import recsys, transformer as tf
    from repro_torch.roofline import analysis
    from repro_torch.train import train_state as ts

    t_phase = time.perf_counter()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    reset_launches()
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = mesh_mod.make_host_mesh()
        # 15a: the MoE train step
        spec = configs.get(LM_MOE)
        cfg = dataclasses.replace(spec.make_config(), n_layers=LM_CHECK_LAYERS)
        cell = dataclasses.replace(spec.shapes["train_4k"], meta={
            "seq": TRAIN_CHECK_SEQ, "batch": TRAIN_CHECK_BATCH})
        step = spec.step_fn(cfg, cell)
        rules = base.cell_rules(spec, cell, mesh)
        pipe, _ = lm_train_pipeline(cfg, TRAIN_CHECK_BATCH, TRAIN_CHECK_SEQ,
                                    "cpu")
        batches = [{k: torch.from_numpy(v).to(dev) for k, v in
                    pipe.next_batch().items()} for _ in range(TRAIN_CHECK_STEPS)]
        lm = {}
        for side in ("plain", "sharded"):
            params = tf.lm_init(LM_SEED, cfg, device=dev).params()
            state = ts.TrainState.create(params,
                                         lm_common.choose_optimizer(cfg))
            losses, ms = [], []
            state_sh, batch_sh = base.cell_shardings(spec, cfg, mesh, state,
                                                     batches[0])
            if side == "sharded":
                state = sh.distribute_tree(state, state_sh)
            with recorded_routes() as seen:
                for b in batches:
                    if side == "sharded":
                        b = sh.distribute_tree(b, batch_sh)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    if side == "sharded":
                        with sh.sharded_step(rules):
                            state, m = step(state, b)
                    else:
                        state, m = step(state, b)
                    loss = float(m["loss"].full_tensor() if isinstance(
                        m["loss"], DTensor) else m["loss"])
                    ms.append(1e3 * (time.perf_counter() - t0))
                    losses.append(loss)
                routes = [i.full_tensor() if isinstance(i, DTensor) else i
                          for _, i in seen]
            leaves = [p.full_tensor() if isinstance(p, DTensor) else p
                      for p in tree_leaves(state.params)]
            lm[side] = (losses, ms, routes, leaves)
            del state, params
        (pl, pms, pr, pp), (sl, sms, sr, sp) = lm["plain"], lm["sharded"]
        lr = 3e-4                       # choose_optimizer's AdamW below 30e9
        check(np.allclose(sl, pl, rtol=1e-3, atol=0),
              f"15a {TRAIN_CHECK_STEPS} sharded AdamW steps' losses == plain "
              f"within rtol 1e-3 ({sl} vs {pl})")
        param_err = max(max_abs_err(a, b) for a, b in zip(sp, pp))
        check(param_err <= adamw_bound(lr, TRAIN_CHECK_STEPS),
              f"15a sharded parameters within "
              f"{adamw_bound(lr, TRAIN_CHECK_STEPS)} of plain ({param_err})")
        check(len(sr) == len(pr) > 0 and all(
            torch.equal(a, b) for a, b in zip(sr, pr)),
              "15a every routing index equal, sharded and plain")
        del lm, batches

        # 15b: SASRec's serve_p99
        spec = configs.get("sasrec")
        cfg = spec.make_config()
        cell = spec.shapes["serve_p99"]
        serve = spec.step_fn(cfg, cell)
        params = recsys.sasrec_init(RECSYS_SEED, cfg, device=dev)
        batch = on_device(recsys_inputs("sasrec", cfg, "score",
                                        cell.meta["batch"], RECSYS_SEED + 4),
                          dev)
        dparams, dbatch = base.distribute_cell(spec, cfg, mesh, params, batch)
        srules = base.cell_rules(spec, cell, mesh)
        out = {}

        def plain_call():
            out["plain"] = serve(params, batch)

        def sharded_call():
            with sh.sharded_step(srules):
                out["sharded"] = serve(dparams, dbatch)
        plain_ms = timed_calls(plain_call, 1 + SHARDED_SERVE_REPS)[1:]
        sharded_ms = timed_calls(sharded_call, 1 + SHARDED_SERVE_REPS)[1:]
        got = out["sharded"].full_tensor()
        check(tuple(got.shape) == tuple(out["plain"].shape) and torch.allclose(
            got, out["plain"], rtol=1e-3, atol=1e-6),
              "15b SASRec serve_p99 sharded scores == plain (rtol 1e-3)")
        serve_err = float((got - out["plain"]).abs().max())
        del params, batch, dparams, dbatch, out, got

        # 15c: the dry run's sharded count of 14d's cells at one device
        measured = {(r["arch"], r["cell"]): r["measured_ms"]
                    for r in roof["cells"]}
        rows = []
        for arch, cell_name in ROOFLINE_CELLS:
            spec = configs.get(arch)
            cfg = spec.make_config()
            cell = spec.shapes[cell_name]
            counts = dryrun.count_sharded(spec, cfg, cell, mesh)
            coll = float(sum(v for k, v in counts["coll"].items()
                             if k != "count"))
            r = analysis.Roofline(
                arch=arch, shape=cell_name, mesh="one", chips=1,
                flops_per_chip=counts["flops"],
                bytes_per_chip=counts["bytes"], coll_bytes_per_chip=coll,
                coll_breakdown=counts["coll"],
                model_flops=spec.model_flops_fn(cfg, cell))
            check(coll == 0, f"15c {arch} {cell_name}: no collective on one "
                  f"device ({counts['coll']})")
            ms = measured[arch, cell_name]
            rows.append({"arch": arch, "cell": cell_name, "measured_ms": ms,
                         "flops": counts["flops"], "bytes": counts["bytes"],
                         "coll_bytes": coll, "t_compute_ms": 1e3 * r.t_compute,
                         "t_memory_ms": 1e3 * r.t_memory,
                         "t_collective_ms": 1e3 * r.t_collective,
                         "t_bound_ms": 1e3 * r.t_bound,
                         "bottleneck": r.bottleneck,
                         "output_bytes": counts["output_bytes"],
                         "temp_bytes": counts["temp_bytes"],
                         "measured_over_t_bound": ms / (1e3 * r.t_bound)})
        mesh_shape = tuple(mesh.shape)
    finally:
        dist.destroy_process_group()
        torch.backends.cuda.matmul.allow_tf32 = tf32
    check(not dist.is_initialized(), "15 the group is destroyed")
    launches = read_launches()
    check(not any(launches.values()),
          "15 the sharded steps launch none of the gene-search kernels")
    rec = {"mesh": mesh_shape,
           "lm_losses_plain": pl, "lm_losses_sharded": sl,
           "lm_params_max_abs_err": param_err, "lm_routing_calls": len(pr),
           "lm_step_ms_plain": [round(x, 3) for x in pms],
           "lm_step_ms_sharded": [round(x, 3) for x in sms],
           "lm_overhead_ms_median": round(float(np.median(sms[1:]) -
                                                np.median(pms[1:])), 3),
           "serve_ms_plain_median": round(float(np.median(plain_ms)), 3),
           "serve_ms_sharded_median": round(float(np.median(sharded_ms)), 3),
           "serve_overhead_ms_median": round(float(
               np.median(sharded_ms) - np.median(plain_ms)), 3),
           "serve_max_abs_err": serve_err, "roofline": rows,
           "wall_s": round(time.perf_counter() - t_phase, 3)}
    print(f"phase 15 the sharded step on the card: ok ({nvidia_smi()}) — "
          f"make_host_mesh() over an NCCL group of 1; {LM_MOE} full width, "
          f"{LM_CHECK_LAYERS} layers, f32, TF32 off, {TRAIN_CHECK_STEPS} AdamW "
          f"steps sharded == plain (losses rtol 1e-3, parameters within "
          f"{adamw_bound(3e-4, TRAIN_CHECK_STEPS)}, routing equal); SASRec "
          f"serve_p99 sharded == plain; DTensor's overhead is the sharded "
          f"minus the plain median (steps after the first); the dry run's "
          f"sharded count of 14d's cells at one device; " + json.dumps(rec))
    return rec


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
    warm_profiler()
    small_shapes_phase(dev)
    cfg = idl_genesearch.full_config()
    archive = genome.synth_archive(cfg.n_files, genome_len=GENOME_LEN,
                                   seed=ARCHIVE_SEED)
    kernels = main_shapes_phase(cfg, archive, dev)
    kernels.append(window_min_phase(dev))
    fcfg = flat_config()
    kernels += locations_phase(cfg.idl_config(), fcfg, dev)
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
    torch.cuda.empty_cache()        # phase 10 runs on a card 9b has freed
    lm_card_vs_cpu_phase(dev)
    lm_serve_phase("10b", LM_MOE, None, dev)
    lm_serve_phase("10c", LM_DENSE, LM_DENSE_LAYERS, dev)
    torch.cuda.empty_cache()
    lm_train_card_vs_cpu_phase(dev)
    torch.cuda.synchronize()
    level = torch.cuda.memory_allocated()
    lm_train_phase("11b", LM_MOE, None, TRAIN_MOE_BATCH, dev, checkpoint=True)
    lm_train_phase("11c", LM_DENSE, LM_DENSE_LAYERS, TRAIN_DENSE_BATCH, dev,
                   checkpoint=False)
    free_card()
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    print(f"phase 11c memory_allocated before 11b {level}, after 11c's state "
          f"was dropped {after}")
    check(after - level <= C1_SLACK, f"11c's train state is freed by its last "
          f"reference ({after - level} bytes left, at most {C1_SLACK})")
    recsys_card_vs_cpu_phase(dev)
    serve = recsys_serve_phase(dev)
    recsys_train_phase(dev)
    equiformer_card_vs_cpu_phase(dev)
    eq_recs = equiformer_phases(dev)
    free_card()
    int8_phase(dev)
    mesh_phase(dev)
    roof = roofline_phase(serve, eq_recs)
    sharded_phase(dev, roof)
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
