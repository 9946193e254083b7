"""IDL-RAMBO at archive scale on the PyTorch port: sub-linear MSMT over 100
files with B·R bucketed Bloom filters (paper §7.3), built through the
unified `GeneIndex` API — the whole archive is indexed with one batched
insert, on the card by default.

    PYTHONPATH=src python examples/torch_rambo_scale.py [--device cpu]
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.core import idl
from repro_torch.data import genome
from repro_torch.index import RamboIndex


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device of the filters (default: cuda)")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    n_files = 100
    archive = genome.synth_archive(n_files=n_files, genome_len=5_000, seed=3)
    cfg = idl.IDLConfig(k=31, t=16, L=1 << 12, eta=4, m=1 << 21)
    genomes = torch.as_tensor(
        np.stack([np.asarray(f.genome) for f in archive]), device=dev)
    file_ids = np.asarray([f.file_id for f in archive], dtype=np.int32)

    for scheme in ("rh", "idl"):
        r = RamboIndex.build(n_files, cfg, scheme=scheme, B=20, R=2,
                             device=dev)
        t0 = time.perf_counter()
        r = r.insert_batch(genomes, file_ids)
        _sync(dev)
        t_index = time.perf_counter() - t0

        reads = torch.as_tensor(np.stack(
            [f.reads(230, 1)[0] for f in archive[:20]]), device=dev)
        t0 = time.perf_counter()
        got = r.msmt(reads).cpu().numpy()
        t_query = (time.perf_counter() - t0) / len(reads)
        hits = int(got[np.arange(20), file_ids[:20]].sum())
        fp = int(got.sum()) - hits
        print(f"{scheme:3s}: {r.n_rep}x{r.n_buckets} filters, "
              f"{r.total_bits / 8e6:.1f} MB, index {t_index:.1f}s "
              f"(one insert_batch), query {t_query * 1e3:.1f} ms/read, "
              f"recall {hits}/{len(reads)}, fp/query {fp / len(reads):.2f}")


if __name__ == "__main__":
    main()
