"""idl-genesearch — the paper's own system as a first-class architecture.

Bit-sliced COBS-style index over 1024 files, queried with batched MSMT
through the shared query planner (port of
:mod:`repro.configs.idl_genesearch`). The hashing scheme is selectable
"idl" | "rh". The index is (m, F/32) int32 words (the reference's uint32
words, same bits): rows replicated, the file slice over 'model'. The
serve step carries the reference's two sharding constraints, the
per-kmer words over ``("batch", None, "files")`` and the file mask over
``("batch", "files")`` (the identity without rules). Its kernels and
host planner need real data, so the dry run counts this cell from its
shapes, not from a sharded run of the step.
"""

from __future__ import annotations

import torch

from repro_torch.configs import base
from repro_torch.distributed.sharding import shard
from repro_torch.index import query
from repro_torch.serving import genesearch as gs

DP = base.DP_AXES
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



def input_specs(cfg: gs.GeneSearchConfig, cell: base.ShapeCell) -> dict:
    return {"queries": base.abstract((cell.meta["batch"], cfg.read_len),
                                     torch.uint8)}


def abstract_state(cfg: gs.GeneSearchConfig, cell: base.ShapeCell):
    return base.abstract((cfg.m, cfg.file_words), torch.int32)

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
        per_kmer = shard(per_kmer, ("batch", None, "files"))
        return shard(query.file_match_mask(per_kmer, cfg.theta),
                     ("batch", "files"))
    return serve



def state_spec(cfg, path: str, shape: tuple) -> tuple:
    # index (m, n_files/32): rows replicated, file slice over 'model' — the
    # per-query row gather is then device-local
    return (None, "model")


def batch_spec(cfg, path: str, shape: tuple) -> tuple:
    return (DP, None)

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
    input_specs=input_specs,
    abstract_state=abstract_state,
    step_fn=step_fn,
    state_spec_fn=state_spec,
    batch_spec_fn=batch_spec,
    model_flops_fn=model_flops,
))
