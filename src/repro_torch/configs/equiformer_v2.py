"""equiformer-v2 [gnn] — SO(2)-eSCN equivariant graph attention.

n_layers=12 d_hidden=128 l_max=6 m_max=2 n_heads=8. [arXiv:2306.12059]

Port of :mod:`repro.configs.equiformer_v2`. Shapes (assignment):
  full_graph_sm  2,708 nodes / 10,556 edges / d_feat 1,433  (Cora-like, 7 cls)
  minibatch_lg   232,965-node graph, fanout 15-10 from 1,024 seeds — the
                 cell is the PADDED SAMPLED SUBGRAPH:
                 nodes <= 1024·(1+15+15·10) = 169,984, edges <= 168,960
  ogb_products   2,449,029 nodes / 61,859,140 edges / d_feat 100 (47 cls)
  molecule       batch=128 graphs x (30 nodes / 64 edges), energy regression

Non-geometric datasets carry synthetic 3D positions: the equivariant
backbone is unchanged, positions are an input like any other. The
sharding rules are the reference's: edges over the whole mesh, nodes over
('pod','data'), weights' trailing matmul dims FSDP x TP.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs import base
from repro_torch.models import equiformer as eq
from repro_torch.train import optimizer as opt_mod, train_state as ts

DP = base.DP_AXES
ALL = ("pod", "data", "model")   # edge axis shards over the whole mesh


def full_config() -> eq.EquiformerConfig:
    return eq.EquiformerConfig(
        name="equiformer-v2", n_layers=12, d_hidden=128,
        l_max=6, m_max=2, n_heads=8,
    )


def smoke_config() -> eq.EquiformerConfig:
    return eq.EquiformerConfig(
        name="equiformer-v2-smoke", n_layers=2, d_hidden=16,
        l_max=2, m_max=1, n_heads=2, remat=False,
    )


def shapes() -> dict[str, base.ShapeCell]:
    return {
        "full_graph_sm": base.ShapeCell(
            "full_graph_sm", "train",
            {"nodes": 2708, "edges": 10556, "d_feat": 1433, "classes": 7,
             "task": "node_cls"}),
        "minibatch_lg": base.ShapeCell(
            "minibatch_lg", "train",
            {"nodes": 169984, "edges": 168960, "d_feat": 0, "classes": 41,
             "task": "node_cls"}),
        "ogb_products": base.ShapeCell(
            "ogb_products", "train",
            {"nodes": 2449029, "edges": 61859140, "d_feat": 100,
             "classes": 47, "task": "node_cls"}),
        "molecule": base.ShapeCell(
            "molecule", "train",
            {"nodes": 30 * 128, "edges": 64 * 128, "d_feat": 0, "classes": 0,
             "graphs": 128, "task": "regression"}),
    }


def cell_config(cfg: eq.EquiformerConfig,
                cell: base.ShapeCell) -> eq.EquiformerConfig:
    return dataclasses.replace(
        cfg, d_feat=cell.meta["d_feat"], n_classes=cell.meta["classes"]
    )



def input_specs(cfg: eq.EquiformerConfig, cell: base.ShapeCell) -> dict:
    n, e = cell.meta["nodes"], cell.meta["edges"]
    f32, i32 = torch.float32, torch.int32
    batch = {
        "positions": base.abstract((n, 3), f32),
        "src": base.abstract((e,), i32),
        "dst": base.abstract((e,), i32),
        "edge_mask": base.abstract((e,), f32),
        "node_mask": base.abstract((n,), f32),
        "node_type": base.abstract((n,), i32),
    }
    if cell.meta["d_feat"]:
        batch["node_feat"] = base.abstract((n, cell.meta["d_feat"]), f32)
    if cell.meta["task"] == "node_cls":
        batch["labels"] = base.abstract((n,), i32)
    else:
        batch["graph_id"] = base.abstract((n,), i32)
        batch["targets"] = base.abstract((cell.meta["graphs"],), f32)
    return batch


def abstract_state(cfg: eq.EquiformerConfig, cell: base.ShapeCell):
    params = eq.equiformer_init(0, cell_config(cfg, cell), device="meta")
    return ts.TrainState.create(params, opt_mod.adamw(1e-3))

def step_fn(cfg: eq.EquiformerConfig, cell: base.ShapeCell):
    """``train_step(state, batch) -> (state, metrics)`` over the cell's
    config (its ``d_feat`` and classes) with AdamW at 1e-3; the state is
    updated in place."""
    ccfg = cell_config(cfg, cell)
    return ts.make_train_step(lambda p, b: eq.equiformer_loss(p, b, ccfg),
                              opt_mod.adamw(1e-3))



def state_spec(cfg, path: str, shape: tuple) -> tuple:
    parts = [p for p in path.split("/") if p]
    if parts and parts[-1] == "step" or len(shape) <= 1:
        return ()
    name = parts[-1] if parts[-1] not in ("m",) else (
        parts[-2] if len(parts) >= 2 else parts[-1]
    )
    # so2 mixing and ffn weights: shard the trailing matmul dims
    if name.startswith("w") and len(shape) >= 2:
        return (None,) * (len(shape) - 2) + (DP, "model")
    if name in ("embed", "head"):
        return (DP, None)
    return ()


def batch_spec(cfg, path: str, shape: tuple) -> tuple:
    name = path.split("/")[-1]
    if name in ("src", "dst", "edge_mask"):
        return (ALL,)
    if name in ("positions", "node_mask", "node_type", "node_feat", "labels",
                "graph_id"):
        return ((*DP,) if len(shape) >= 1 else None,) + (None,) * (
            len(shape) - 1)
    if name == "targets":
        return (DP,)
    return ()

def model_flops(cfg: eq.EquiformerConfig, cell: base.ShapeCell) -> float:
    # dominant terms: 2 Wigner rotations + SO(2) mixes per edge per layer
    e = cell.meta["edges"]
    k = cfg.n_coeff
    c = cfg.d_hidden
    rot = 2 * e * k * k * c * 2            # two (K,K)@(K,C) einsums
    n_l = sum(cfg.l_max + 1 - m for m in range(cfg.m_max + 1))
    so2 = e * (n_l * c) ** 2 * 2 // (cfg.m_max + 1)  # per-m block mixes (approx)
    fwd = cfg.n_layers * (rot + so2)
    return 3.0 * fwd                        # fwd + bwd


SPEC = base.register(base.ArchSpec(
    name="equiformer-v2",
    family="gnn",
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
