#!/usr/bin/env python3
"""Drive the PyTorch port's ingest-to-serve path on one CUDA card.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It imports ``repro_torch`` from ``src/`` beside this file (never JAX or the
reference package) and runs three phases, printing one line each:

1. device and build — the card, its power limit, and an ``nvcc`` build of
   every kernel source (``-Xptxas -v`` registers / shared memory / spills);
2. kernels vs their plain PyTorch versions on the card, bit for bit, at
   small widths (W = 1 and 32, pad lanes, ragged run counts, an empty
   insert plan) and at the main path's shapes (204,800 probes into a
   2^26 x 32 matrix; one 512-read insert batch), each timed with CUDA
   events beside its plain version, its byte bound and a library call;
3. the main path at full width (``full_config``: m = 2^26 rows, 1024 files,
   k 31, t 16, L 2^17, η 4): an 8 GiB ``BitSlicedIndex`` built through
   ``build_archive(backend="idl_insert")`` and served through
   ``GeneSearchService(backend="idl_probe")`` in 256-read batches, with the
   launch counters zeroed just before and read just after; recall must be
   total and the first batch must match the plain ``"torch"`` backend;
   then the mean host time of each planner stage over that run, as the
   package's own ``planner.stage_ms`` timers recorded it.

Then it prints the kernels' JSON line, the ``nvidia-smi`` name and power
limit, and last ``{"ok": true, "device": {...}}``. It exits non-zero,
printing no result, without a CUDA device, without the port beside it, or
when any build, launch or check fails.
"""

from __future__ import annotations

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


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest |a - b| over int32 words (0 when equal)."""
    diff = (a != b).nonzero(as_tuple=True)
    if diff[0].numel() == 0:
        return 0
    return int((a[diff].long() - b[diff].long()).abs().max())


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
    """Phase 2a: both kernels against their plain versions at W = 1 and 32
    (pad lanes, runs longer than one 32-lane step, a padded run count), and
    an empty insert plan."""
    from repro_torch.kernels.idl_insert import kernel as ins_kernel
    from repro_torch.kernels.idl_insert import ops as ins_ops
    from repro_torch.kernels.idl_insert import ref as ins_ref
    from repro_torch.kernels.idl_probe import ops as probe_ops
    from repro_torch.kernels.idl_probe import ref as probe_ref

    rng = np.random.default_rng(0)
    small = []
    for w in (1, 32):
        matrix = rand_matrix(4096, w, dev)
        rows = rng.integers(0, 4096, size=(3, 97))
        rows[1].sort()
        rows[2] = np.sort(rng.integers(0, 128, size=97))   # ~48-probe runs
        plan = probe_ops.plan_probe_runs(rows, block_bits=64,
                                         probes_per_run=128)
        check((plan.offsets < 0).any(), "gather plan has pad lanes")
        got = probe_ops.gather_planned_rows(matrix, plan)
        want = probe_ref.gather_planned_rows_ref(
            matrix, *as_dev(dev, plan.block_ids, plan.offsets,
                            plan.probe_index),
            rows_per_block=64, n_probes=plan.n_probes)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"gather W={w} kernel == plain")
        flat = rng.integers(0, 4096 * w * 32, size=5000)
        flat[:100] = -1
        iplan = ins_ops.plan_insert_runs(flat, block_bits=64 * w * 32,
                                         inserts_per_run=128)
        want = ins_ref.insert_planned_ref(
            matrix.clone(), *as_dev(dev, iplan.block_ids, iplan.offsets),
            rows_per_block=64)
        ins_ops.insert_planned(matrix, iplan)
        torch.cuda.synchronize()
        check(torch.equal(matrix, want), f"insert W={w} kernel == plain")
        small.append(f"W={w}: {plan.n_runs} gather runs, {iplan.n_runs} "
                     f"insert runs ({iplan.block_ids.shape[0]} padded)")
    matrix = rand_matrix(64, 4, dev)
    before = matrix.clone()
    ins_ops.insert_planned(matrix, None)
    empty = torch.empty((0, 128), dtype=torch.int32, device=dev)
    ins_kernel.insert_planned(matrix, empty[:, 0], empty, rows_per_block=16)
    torch.cuda.synchronize()
    check(torch.equal(matrix, before), "empty insert plan leaves the matrix")
    print(f"phase 2a small shapes: ok (kernel == plain, tolerance 0: "
          f"bit-exact) — {'; '.join(small)}; empty plan ok")


def main_shapes_phase(cfg, archive, dev) -> list:
    """Phases 2b-2c: both kernels at the main path's shapes, against their
    plain versions and timed beside their byte bounds. Returns the kernels'
    JSON records."""
    from repro_torch.kernels.idl_insert import kernel as ins_kernel
    from repro_torch.kernels.idl_insert import ref as ins_ref
    from repro_torch.kernels.idl_probe import kernel as probe_kernel
    from repro_torch.kernels.idl_probe import ref as probe_ref
    from repro_torch.serving import genesearch as gs

    rng = np.random.default_rng(0)
    shape = (cfg.m, cfg.file_words)
    w = shape[1]
    matrix = rand_matrix(*shape, dev)

    # gather at one serve batch: 256 reads x 200 kmers x η 4 probes
    qplan = gs.query_plan(cfg, SERVE_BATCH, shape, device=dev)
    reads = torch.as_tensor(
        rng.integers(0, 4, size=(SERVE_BATCH, cfg.read_len), dtype=np.uint8),
        device=dev)
    rplan, locs = qplan.plan_runs(reads)
    bids, offs, pidx = as_dev(dev, rplan.block_ids, rplan.offsets,
                              rplan.probe_index)
    rpb = qplan.rows_per_block

    def gather_kernel():
        return probe_kernel.gather_planned_rows(
            matrix, bids, offs, pidx, rows_per_block=rpb,
            n_probes=rplan.n_probes)

    def gather_plain():
        return probe_ref.gather_planned_rows_ref(
            matrix, bids, offs, pidx, rows_per_block=rpb,
            n_probes=rplan.n_probes)

    probe_rows = locs.reshape(-1)

    def gather_library():
        return torch.index_select(matrix, 0, probe_rows)

    got, want, lib = gather_kernel(), gather_plain(), gather_library()
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    check(err == 0 and torch.equal(got, lib), "gather kernel == plain at "
          "the main path's shapes")
    del got, want, lib
    # the bound charges what the work needs: the runs' block ids, the
    # sectors of offsets and probe indices that hold a valid lane, the
    # distinct rows read and the rows written (not the -1 pad lanes)
    rows_read = torch.unique(probe_rows).cpu().numpy()
    lanes = valid_lanes(rplan.offsets)
    g_bytes = (sector_bytes(np.arange(rplan.n_runs), 1)
               + 2 * sector_bytes(lanes, 1)
               + sector_bytes(rows_read * w, w)
               + sector_bytes(np.arange(rplan.n_probes) * w, w))
    g_padded = rplan.offsets.nbytes + rplan.probe_index.nbytes
    gather = {
        "name": probe_kernel.NAME, "route": "cuda",
        "source": probe_kernel.SOURCE, "replaces": probe_kernel.REPLACES,
        "max_abs_err": err,
        "ms": cuda_ms(gather_kernel, 50),
        "plain_ms": cuda_ms(gather_plain, 10),
        "bound_ms": 1e3 * g_bytes / HBM_BYTES_PER_S, "bound_by": "bytes",
        "library_ms": cuda_ms(gather_library, 50),
    }
    print(f"phase 2b gather at serve shapes: ok (max_abs_err {err}, "
          f"tolerance 0) — {rplan.n_probes} probes in "
          f"{rplan.n_runs} runs of <= {rplan.probes_per_run} "
          f"(mean {rplan.n_probes / rplan.n_runs:.4f} probes/run, rpb {rpb}); "
          f"kernel {gather['ms']:.6f} ms, plain {gather['plain_ms']:.6f} ms, "
          f"index_select {gather['library_ms']:.6f} ms, bound "
          f"{gather['bound_ms']:.6f} ms ({g_bytes} B; the plan's padded "
          f"offsets and probe indices hold {g_padded} B, not charged)")

    # insert at one build_archive chunk: the archive's first 512 windows
    windows, fids = genome_windows(archive, cfg, INSERT_BATCH)
    windows = torch.as_tensor(np.stack(windows), device=dev)
    fids = torch.as_tensor(np.asarray(fids), device=dev)
    iplan_q = gs.insert_plan(cfg, INSERT_BATCH, shape, device=dev)
    iplan = iplan_q.plan_runs(windows, fids)
    # the true runs only, as ops.insert_planned passes them
    ibids, ioffs = as_dev(dev, iplan.block_ids[:iplan.n_runs],
                          iplan.offsets[:iplan.n_runs])
    irpb = iplan_q.rows_per_block
    copy = matrix.clone()

    def insert_kernel():
        return ins_kernel.insert_planned(matrix, ibids, ioffs,
                                         rows_per_block=irpb)

    def insert_plain():
        return ins_ref.insert_planned_ref(copy, ibids, ioffs,
                                          rows_per_block=irpb)

    insert_kernel()
    insert_plain()
    torch.cuda.synchronize()
    err = max_abs_err(matrix, copy)
    check(err == 0, "insert kernel == plain at the main path's shapes")
    # the bound charges the runs' block ids, the sectors of offsets that
    # hold a valid lane, and the touched words' sectors read and written
    offs = iplan.offsets[:iplan.n_runs]
    valid = offs >= 0
    words = np.unique((iplan.block_ids[:iplan.n_runs].astype(np.int64)[:, None]
                       * irpb * w + (offs >> 5))[valid])
    i_bytes = (sector_bytes(np.arange(iplan.n_runs), 1)
               + sector_bytes(valid_lanes(offs), 1)
               + 2 * sector_bytes(words, 1))
    insert = {
        "name": ins_kernel.NAME, "route": "cuda",
        "source": ins_kernel.SOURCE, "replaces": ins_kernel.REPLACES,
        "max_abs_err": err,
        "ms": cuda_ms(insert_kernel, 50),
        "plain_ms": cuda_ms(insert_plain, 10),
        "bound_ms": 1e3 * i_bytes / HBM_BYTES_PER_S, "bound_by": "bytes",
        "library_ms": None,
    }
    del copy
    print(f"phase 2c insert at build shapes: ok (max_abs_err {err}, "
          f"tolerance 0) — {iplan.n_locs} bits in "
          f"{iplan.n_runs} runs ({iplan.block_ids.shape[0]} padded, "
          f"{iplan.n_tiles} blocks, {words.size} words); kernel "
          f"{insert['ms']:.6f} ms, plain {insert['plain_ms']:.6f} ms, bound "
          f"{insert['bound_ms']:.6f} ms ({i_bytes} B; the padded offsets of "
          f"the true runs hold {offs.nbytes} B, not charged)")
    return [gather, insert]


def main_path_phase(cfg, archive, dev, kernels: list) -> None:
    """Phase 3: ingest the archive and serve batches through the entry
    points a user calls, with the launch counters zeroed just before and
    read just after; then the mean host time of each planner stage over
    that run (the package's ``planner.stage_ms`` timers)."""
    from repro_torch.index import BitSlicedIndex, build_archive
    from repro_torch.kernels.idl_insert import kernel as ins_kernel
    from repro_torch.kernels.idl_probe import kernel as probe_kernel
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.serving import GeneSearchService, ServiceConfig

    eng = BitSlicedIndex.build(cfg.idl_config(), cfg.scheme, cfg.n_files,
                               device=dev)
    obs_metrics.reset()
    torch.cuda.reset_peak_memory_stats()
    probe_kernel.launches = 0
    ins_kernel.launches = 0
    t0 = time.perf_counter()
    eng = build_archive(eng, archive, read_len=cfg.read_len,
                        chunk_reads=INSERT_BATCH, backend="idl_insert")
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    ingest_launches = ins_kernel.launches
    check(ingest_launches > 0, "insert_planned launched during ingest")

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
        results = svc.search(reads)
        batch_ms.append(1e3 * (time.perf_counter() - t0))
        for fid, res in zip(fids, results):
            check(res.matches.shape == (cfg.n_files,), "verdict shape")
            hit = int(fid) in res.file_ids
            correct += hit
            extra += len(res.file_ids) - hit
            total += 1
        if r == 0:
            plain = plain_svc.search(reads)
            check(all(np.array_equal(a.matches, b.matches)
                      for a, b in zip(results, plain)),
                  "idl_probe verdicts == torch verdicts on the first batch")
    kernels[0]["launches"] = probe_kernel.launches
    kernels[1]["launches"] = ins_kernel.launches
    check(kernels[0]["launches"] > 0,
          "gather_planned_rows launched while serving")
    check(correct == total, f"recall {correct}/{total} is total")
    snap = obs_metrics.DEFAULT.snapshot()
    tile_q = obs_metrics.counter_total(
        snap, "locality.planned_tile_bytes", {"op": "query"})
    tile_i = obs_metrics.counter_total(
        snap, "locality.planned_tile_bytes", {"op": "insert"})
    print(f"phase 3 main path: ok — {cfg.m}x{cfg.file_words} int32 index "
          f"({eng.state.nbytes} B) over {cfg.n_files} files x {GENOME_LEN} "
          f"bases; ingest {ingest_s:.3f} s ({ingest_launches} insert_planned "
          f"launches); serve {SERVE_BATCHES} x {SERVE_BATCH} reads, batch ms "
          f"{[round(b, 3) for b in batch_ms]} ({kernels[0]['launches']} "
          f"gather_planned_rows launches); recall {correct}/{total}; mean "
          f"extra matched files {extra / total:.4f}; first batch == torch "
          f"backend; max_memory_allocated "
          f"{torch.cuda.max_memory_allocated()} B; "
          f"locality.planned_tile_bytes query {tile_q:.0f} insert "
          f"{tile_i:.0f}")
    stages = {}
    for key, hist in snap["hists"].get("planner.stage_ms", {}).items():
        labels = obs_metrics.parse_label_key(key)
        stages[f"{labels['op']}.{labels['stage']}"] = {
            "mean_ms": hist["sum"] / hist["count"], "batches": hist["count"]}
    stages["insert.whole_batch"] = {
        "mean_ms": 1e3 * ingest_s / ingest_launches, "batches": ingest_launches}
    stages["query.whole_batch"] = {
        "mean_ms": sum(batch_ms) / len(batch_ms), "batches": len(batch_ms)}
    print("phase 3 where the time goes (host ms per batch, means over the "
          "main path's run): " + json.dumps(stages, sort_keys=True))


def main() -> None:
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
    torch.cuda.empty_cache()
    main_path_phase(cfg, archive, dev, kernels)
    print(f"total {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}))


if __name__ == "__main__":
    main()
