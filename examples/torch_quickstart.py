"""Quickstart on the PyTorch port: index a genome with an IDL Bloom filter
and query reads through the unified `GeneIndex` API (`repro_torch.index`),
on the card by default.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""

import argparse
import tempfile

import numpy as np
import torch

import repro_torch.index as index
from repro_torch.core import cache_model, idl
from repro_torch.data import genome
from repro_torch.index import PackedBloomIndex, registry, store
from repro_torch.serving import GeneSearchService, ServiceConfig


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device of the filter (default: cuda)")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    # 1. synthesize a genome and build the IDL-BF over its 31-mers through
    #    the streaming archive builder (chunked inserts through the
    #    planned insert kernel — the same call scales to whole FASTA
    #    archives)
    g = genome.synthesize_genome(50_000, seed=0)
    cfg = idl.IDLConfig(k=31, t=16, L=1 << 15, eta=4, m=1 << 24)
    bf = PackedBloomIndex.build(cfg, scheme="idl", device=dev)
    bf = index.build_archive(bf, [(0, g)], read_len=230, chunk_reads=64)
    print(f"indexed {len(g) - cfg.k + 1} kmers into a {cfg.m // 8 // 1024} KiB "
          f"IDL-BF (fill = {float(bf.fill_fraction):.3f})")

    # 2. genuine reads pass Membership Testing; 1-poisoned reads fail —
    #    both checked for the whole batch in one query_batch call
    reads = genome.extract_reads(g, 230, 5, seed=1)
    poisoned = genome.poison_queries(reads, seed=2)
    ok = bf.msmt(np.stack(reads)).cpu()
    bad = bf.msmt(poisoned).cpu()
    for i in range(3):
        print(f"read {i}: genuine -> {bool(ok[i])}, 1-poisoned -> {bool(bad[i])}")

    # 3. the paper's locality claim, measured per registered scheme: block
    #    switches along each hash repetition's probe stream
    read0 = torch.as_tensor(np.asarray(reads[0]), device=dev)
    for name in ("idl", "rh"):
        locs = registry.locations(cfg, read0, name)
        d = cache_model.count_block_dmas_partitioned(locs, cfg.L)
        print(f"{name.upper()}: {d['switches']} block DMAs for {d['accesses']} "
              f"probes ({d['switches'] / d['accesses']:.2%} per probe)")

    # 4. the same membership through the plain gather, the planned probe
    #    kernel and the sharded backend — one shared query layer
    batch = np.stack(reads)
    member = bf.query_batch(batch, backend="torch")
    member_kernel = bf.query_batch(batch, backend="idl_probe")
    member_sharded = bf.query_batch(batch, backend="sharded")
    print(f"idl_probe backend agrees: "
          f"{bool(torch.equal(member_kernel, member))}")
    print(f"sharded backend agrees:   "
          f"{bool(torch.equal(member_sharded, member))}")

    # 5. ... and the write side has the same backend choice: the plain
    #    scatter builds a filter bit-identical to the insert kernel's
    bf2 = PackedBloomIndex.build(cfg, scheme="idl", device=dev)
    bf2 = index.build_archive(bf2, [(0, g)], read_len=230, chunk_reads=64,
                              backend="torch")
    print(f"idl_insert backend agrees: "
          f"{bool(torch.equal(bf2.words, bf.words))}")

    # 6. the engine is a thin view over an IndexState — snapshot it to
    #    disk and serve ragged-length queries through the dynamic-batching
    #    service (one runner per pow2 kmer bucket)
    with tempfile.TemporaryDirectory() as snap:
        store.save(bf.state, snap)                 # versioned snapshot
        svc = GeneSearchService.from_snapshot(snap, ServiceConfig(),
                                              device=dev)
        ragged = [np.asarray(reads[0]), np.asarray(reads[1][:120]),
                  np.asarray(reads[2][:90])]
        results = svc.search(ragged)
        print("served ragged lengths "
              f"{[len(q) for q in ragged]} -> matches "
              f"{[bool(r.matches) for r in results]} "
              f"(buckets/runners: {svc.compile_counts()})")


if __name__ == "__main__":
    main()
