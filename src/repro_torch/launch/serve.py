"""Serving launcher: ``python -m repro_torch.launch.serve``.

Builds a bit-sliced gene-search index over a synthetic archive (one genome
per file, through the ``idl_insert`` backend) and serves batched MSMT
queries through :class:`GeneSearchService` (``idl_probe`` backend), then
prints the recall — the port of ``repro.launch.serve``'s in-process path,
with the reference's smoke configuration. ``--device`` picks the device
(default ``cuda``; ``cpu`` runs the kernels' plain versions).
"""

from __future__ import annotations

import argparse
import dataclasses
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
    args = ap.parse_args(argv)

    if args.arch != idl_genesearch.NAME:
        raise SystemExit(f"serve launcher drives {idl_genesearch.NAME!r} "
                         f"only, got {args.arch!r}")
    args.files = max(32, -(-args.files // 32) * 32)  # bit-sliced: 32/word
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

    svc = GeneSearchService(eng, ServiceConfig(theta=cfg.theta,
                                               max_batch=args.batch))
    rng = np.random.default_rng(0)
    lat = []
    correct = total = 0
    for _ in range(args.requests):
        fids = rng.integers(0, args.files, size=args.batch)
        reads = [np.asarray(archive[int(f)].reads(cfg.read_len, 1)[0])
                 for f in fids]
        t0 = time.perf_counter()
        results = svc.search(reads)
        lat.append(time.perf_counter() - t0)
        for fid, res in zip(fids, results):
            correct += int(int(fid) in res.file_ids)
            total += 1
    print(f"recall {correct}/{total}; "
          f"p50 latency {1e3 * float(np.median(lat)):.1f} ms "
          f"(batch={args.batch})")


if __name__ == "__main__":
    main()
