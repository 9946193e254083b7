"""End-to-end LIVE gene-search serving on the PyTorch port: boot a
2-replica fleet on a base archive that is missing four genomes, watch those
queries miss (recall 0/4), then stream the genomes in through the cluster
write path — the fleet answers 4/4 WITHOUT a restart, every result stamped
with the ``(version, delta_seq)`` coordinates that served it and orderable
against the write acks (read-your-writes). Finally fold the accumulated
deltas into a new base version under the same fleet: the answers don't
change, and every replica keeps the runners it had.

    PYTHONPATH=src python examples/torch_genesearch_service.py [--device cpu]
"""

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.core import idl
from repro_torch.data import genome
from repro_torch.index import BitSlicedIndex, ingest
from repro_torch.serving import LiveReplicaRouter, RouterConfig, ServiceConfig


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device of the index (default: cuda)")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    n_files = 64
    live_ids = [3, 17, 40, 59]            # these genomes arrive LIVE
    cfg = idl.IDLConfig(k=31, t=16, L=1 << 12, eta=3, m=1 << 20)
    archive = genome.synth_archive(n_files=n_files, genome_len=3_000, seed=42)

    print(f"indexing {n_files - len(live_ids)} of {n_files} genome files "
          f"(holding back {live_ids}) ...")
    # the streaming archive builder: every genome is chopped into read_len
    # windows overlapping by k-1 (no kmer lost), batched in chunks and fed
    # to the cached InsertPlan
    t0 = time.perf_counter()
    eng = BitSlicedIndex.build(cfg, "idl", n_files=n_files, device=dev)
    eng = ingest.build_archive(
        eng, [f for f in archive if f.file_id not in live_ids],
        read_len=230, chunk_reads=64)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    print(f"  base built in {time.perf_counter() - t0:.1f}s "
          f"({eng.state.nbytes / 1e6:.1f} MB bit-sliced IndexState)")

    # ragged query stream for the held-back genomes: full reads and
    # amplicon-length fragments — submit() returns futures immediately,
    # the background flushers batch each kmer bucket on its deadline
    queries = []
    for i, fid in enumerate(live_ids):
        read = archive[fid].reads(230, 6)[5]
        queries.append(np.asarray(read[:(80, 120, 160, 230)[i % 4]]))

    def search(router):
        futures = [router.submit(q) for q in queries]
        router.drain()
        return [f.result() for f in futures]

    with tempfile.TemporaryDirectory() as tmp:
        # the live fleet: each replica serves base + delta through the
        # exact two-probe merge; every write is journaled (write-ahead,
        # CRC-framed) before any replica's delta absorbs it
        router = LiveReplicaRouter(
            eng, ServiceConfig(theta=1.0, max_batch=8),
            RouterConfig(n_replicas=2, policy="bucket_affinity"),
            journal_path=os.path.join(tmp, "wal.bin"))
        print("  2-replica live router booted (write-ahead journal on)")

        results = search(router)
        hits = sum(fid in r.file_ids for fid, r in zip(live_ids, results))
        print(f"before live ingest: recall {hits}/{len(live_ids)} "
              f"(the genomes aren't indexed yet)")

        # the cluster write path: chop each held-back genome into k-1
        # overlapping windows (same rule as the offline builder) and
        # insert through the router — one journal append, then the batch
        # fans to every replica's flusher; all acks resolved = the write
        # is searchable fleet-wide
        t0 = time.perf_counter()
        acks = []
        for fid in live_ids:
            windows = genome.window_reads(archive[fid].genome, 230, cfg.k)
            fids = np.full(windows.shape[0], fid, dtype=np.int32)
            acks += router.insert(windows, fids)
        last = max(a.result().delta_seq for a in acks)
        print(f"streamed {len(live_ids)} genomes in "
              f"{time.perf_counter() - t0:.2f}s; last ack at delta_seq "
              f"{last} ({router.delta_batches()} delta batches pending)")

        results = search(router)
        hits = 0
        for fid, r, q in zip(live_ids, results, queries):
            hits += int(fid in r.file_ids)
            print(f"query from file {fid:2d} (len {len(q)}, bucket "
                  f"{r.bucket}, v{r.version} seq {r.delta_seq}): "
                  f"matched {list(r.file_ids)}")
        print(f"after live ingest: recall {hits}/{len(live_ids)} — "
              f"no restart, every result's delta_seq >= {last} (saw the "
              f"writes)")

        # compaction under the same fleet: fold every replica's delta into
        # a new base version; same geometry in and out, so every replica
        # keeps its bucket runners (the port's compile_counts)
        runners_before = dict(router.compile_counts())
        version = router.compact()
        results = search(router)
        hits = sum(fid in r.file_ids for fid, r in zip(live_ids, results))
        print(f"compacted -> base v{version} "
              f"({router.delta_batches()} delta batches left); recall "
              f"still {hits}/{len(live_ids)} at v{results[0].version}; "
              f"runners unchanged: "
              f"{dict(router.compile_counts()) == runners_before}")
        router.close()


if __name__ == "__main__":
    main()
