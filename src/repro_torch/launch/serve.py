"""Serving launcher: ``python -m repro_torch.launch.serve``.

Builds a bit-sliced gene-search index over a synthetic archive (one genome
per file, through the ``idl_insert`` backend) and serves batched MSMT
queries through :class:`GeneSearchService` (``idl_probe`` backend), then
prints the recall — the port of ``repro.launch.serve``, with the
reference's smoke configuration. ``--device`` picks the device (default
``cuda``; ``cpu`` runs the kernels' plain versions). ``--procs N`` serves
the same traffic through a :class:`ProcessFabric` instead: the index is
snapshotted once and N worker processes load it onto ``--device`` behind
one gateway. ``--shards N`` partitions the index into N shard states,
saves the shard-set snapshot and serves through a
:class:`ScatterGatherRouter` (each shard a worker process when
``--procs`` is also set). ``--obs-dump PATH`` writes the merged
observability snapshot after serving.
"""

from __future__ import annotations

import argparse
import dataclasses
import tempfile
import time

import numpy as np

from repro_torch.configs import idl_genesearch
from repro_torch.data import genome
from repro_torch.index import BitSlicedIndex
from repro_torch.serving import GeneSearchService, ServiceConfig


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=idl_genesearch.NAME)
    ap.add_argument("--files", type=int, default=32)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--requests", type=int, default=5)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the index (default: cuda)")
    ap.add_argument("--procs", type=int, default=0, metavar="N",
                    help="serve through a ProcessFabric of N mmap-booted "
                         "worker processes instead of in-process")
    ap.add_argument("--shards", type=int, default=0, metavar="N",
                    help="partition the index into N shards and serve "
                         "through a scatter-gather router (with --procs, "
                         "each shard runs in its own worker process)")
    ap.add_argument("--obs-dump", default=None, metavar="PATH",
                    help="after serving, write the merged observability "
                         "snapshot (metrics + traces, JSON) to PATH and "
                         "a Chrome trace_event file next to it")
    args = ap.parse_args(argv)

    if args.arch != idl_genesearch.NAME:
        raise SystemExit(f"serve launcher drives {idl_genesearch.NAME!r} "
                         f"only, got {args.arch!r}")
    args.files = max(32, -(-args.files // 32) * 32)  # bit-sliced: 32/word
    if args.shards:
        # file shards split on 32-file word columns: one column per shard
        # is the floor
        args.files = max(args.files, 32 * args.shards)
    cfg = dataclasses.replace(idl_genesearch.smoke_config(),
                              n_files=args.files)

    archive = genome.synth_archive(n_files=args.files, genome_len=2_000,
                                   seed=11)
    eng = BitSlicedIndex.build(cfg.idl_config(), cfg.scheme, cfg.n_files,
                               device=args.device)
    for f in archive:
        eng = eng.insert_batch(np.asarray(f.genome)[None],
                               np.asarray([f.file_id], dtype=np.int32))
    print(f"index: {args.files} files, "
          f"{eng.state.nbytes / 1e6:.1f} MB bit-sliced IndexState "
          f"on {args.device}")

    svc_cfg = ServiceConfig(theta=cfg.theta, max_batch=args.batch)
    if args.shards:
        from repro_torch.index import shards as shards_mod
        from repro_torch.serving import ScatterConfig, ScatterGatherRouter
        tmp = tempfile.TemporaryDirectory(prefix="serve_shards_")
        spec, parts = shards_mod.partition_state(eng, args.shards)
        shards_mod.save_shard_set(spec, parts, f"{tmp.name}/set")
        router = ScatterGatherRouter(f"{tmp.name}/set", ScatterConfig(
            procs=bool(args.procs), service=svc_cfg, device=args.device))
        mode = ("worker processes" if args.procs
                else "in-process schedulers")
        print(f"shards: {spec.n_shards} shards over the {spec.axis!r} "
              f"axis, served by {mode} (set version "
              f"{router.set_version})")
        search = router.search
    elif args.procs:
        from repro_torch.index import store
        from repro_torch.serving import FabricConfig, ProcessFabric
        tmp = tempfile.TemporaryDirectory(prefix="serve_fabric_")
        snap = store.save(eng, f"{tmp.name}/snap")
        fab = ProcessFabric(snap, FabricConfig(
            n_workers=args.procs, service=svc_cfg, device=args.device))
        print(f"fabric: {args.procs} worker processes, pids "
              f"{sorted(fab.worker_pids().values())}")
        search = fab.search
    else:
        search = GeneSearchService(eng, svc_cfg).search
    rng = np.random.default_rng(0)
    lat = []
    correct = total = 0
    for _ in range(args.requests):
        fids = rng.integers(0, args.files, size=args.batch)
        reads = [np.asarray(archive[int(f)].reads(cfg.read_len, 1)[0])
                 for f in fids]
        t0 = time.perf_counter()
        results = search(reads)
        lat.append(time.perf_counter() - t0)
        for fid, res in zip(fids, results):
            correct += int(int(fid) in res.file_ids)
            total += 1
    print(f"recall {correct}/{total}; "
          f"p50 latency {1e3 * float(np.median(lat)):.1f} ms "
          f"(batch={args.batch})")
    if args.obs_dump:
        from repro_torch.obs import export as obs_export
        if args.shards:
            snap = router.obs_snapshot()   # fleet merge over shard procs
        elif args.procs:
            snap = fab.obs_snapshot()      # fleet merge over workers
        else:
            snap = obs_export.snapshot()   # one process = one registry
        paths = obs_export.dump(snap, args.obs_dump)
        print(f"obs: {len(snap.get('spans', ()))} spans, "
              f"{len(snap['metrics'].get('counters', {}))} counter "
              f"series -> {paths[0]} (+ {paths[1]})")
    if args.shards:
        router.close()
        tmp.cleanup()
    elif args.procs:
        fab.close()
        tmp.cleanup()


if __name__ == "__main__":
    main()
