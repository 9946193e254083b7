"""idl-genesearch — the paper's own system as a first-class architecture.

Bit-sliced COBS-style index over 1024 files, queried with batched MSMT
through the shared query planner (port of
:mod:`repro.configs.idl_genesearch` without its mesh and sharding
rules). The hashing scheme is selectable "idl" | "rh".
"""

from __future__ import annotations

import torch

from repro_torch.configs import base
from repro_torch.index import query
from repro_torch.serving import genesearch as gs

NAME = "idl-genesearch"


def full_config() -> gs.GeneSearchConfig:
    return gs.GeneSearchConfig(
        name="idl-genesearch", n_files=1024, m=1 << 26,
        k=31, t=16, L=1 << 17, eta=4, read_len=230, scheme="idl",
    )


def smoke_config() -> gs.GeneSearchConfig:
    return gs.GeneSearchConfig(
        name="idl-genesearch-smoke", n_files=64, m=1 << 18,
        k=31, t=12, L=1 << 10, eta=2, read_len=100, scheme="idl",
    )


def shapes() -> dict[str, base.ShapeCell]:
    return {
        "serve_p99": base.ShapeCell(
            "serve_p99", "serve", {"batch": 256}),
        "serve_bulk": base.ShapeCell(
            "serve_bulk", "serve", {"batch": 16384}),
    }


def step_fn(cfg: gs.GeneSearchConfig, cell: base.ShapeCell):
    """``serve(index (m, F/32) int32, {"queries": (B, read_len) uint8})``
    -> (B, F/32) int32 match masks: batched MSMT through the shared
    planner (the ``"idl_probe"`` row probe on the index's device, then the
    exact integer coverage threshold)."""
    def serve(index: torch.Tensor, batch) -> torch.Tensor:
        queries = query.as_reads(batch["queries"], index.device)
        plan = gs.query_plan(cfg, queries.shape[0], tuple(index.shape),
                             device=index.device)
        per_kmer = plan.execute(index, queries, backend="idl_probe")
        return query.file_match_mask(per_kmer, cfg.theta)
    return serve


def model_flops(cfg: gs.GeneSearchConfig, cell: base.ShapeCell) -> float:
    b = cell.meta["batch"]
    n_k = cfg.n_kmers
    # per kmer: ~w hash rounds of a few ALU ops + η gathers of F/32 words
    hash_ops = b * n_k * (cfg.k - cfg.t + 1) * 16
    and_ops = b * n_k * cfg.eta * cfg.file_words
    return float(hash_ops + and_ops)


SPEC = base.register(base.ArchSpec(
    name=NAME,
    family="genesearch",
    make_config=full_config,
    make_smoke_config=smoke_config,
    shapes=shapes(),
    step_fn=step_fn,
    model_flops_fn=model_flops,
))
