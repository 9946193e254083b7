"""Graph data: synthetic graphs shaped like the assigned GNN cells + batching.

Port of :mod:`repro.data.graph_pipeline`: host-side numpy, as in the
reference, so every graph and batch is exactly the reference's for the
same seed.

Provides the host-side halves of the four equiformer-v2 shapes:
  full_graph_sm  — Cora-like (2708 nodes / 10556 edges / 1433 feats)
  minibatch_lg   — Reddit-like; REAL fanout sampling via gnn_common
  ogb_products   — products-like full batch (the reference's dry-run cell;
                   too big to materialize on one card)
  molecule       — batched small graphs (30 nodes / 64 edges × batch)
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.models import gnn_common


@dataclasses.dataclass
class SynthGraph:
    src: np.ndarray
    dst: np.ndarray
    positions: np.ndarray
    node_feat: np.ndarray | None
    node_type: np.ndarray
    labels: np.ndarray
    n_nodes: int

    @property
    def n_edges(self) -> int:
        return len(self.src)


def synth_graph(
    n_nodes: int, n_edges: int, d_feat: int = 0, n_classes: int = 8,
    n_types: int = 16, seed: int = 0,
) -> SynthGraph:
    """Random geometric-ish graph: nodes get 3D positions (the equiformer
    backbone needs them; non-geometric datasets get synthetic coordinates,
    see DESIGN.md), edges biased to nearby nodes."""
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(n_nodes, 3)).astype(np.float32)
    # half locality-biased edges, half uniform (keeps degree dist interesting)
    half = n_edges // 2
    src_a = rng.integers(0, n_nodes, size=half)
    dst_a = (src_a + rng.integers(1, max(2, n_nodes // 100), size=half)) % n_nodes
    src_b = rng.integers(0, n_nodes, size=n_edges - half)
    dst_b = rng.integers(0, n_nodes, size=n_edges - half)
    src = np.concatenate([src_a, src_b])
    dst = np.concatenate([dst_a, dst_b])
    feat = rng.normal(size=(n_nodes, d_feat)).astype(np.float32) if d_feat else None
    return SynthGraph(
        src=src.astype(np.int64), dst=dst.astype(np.int64),
        positions=pos,
        node_feat=feat,
        node_type=rng.integers(0, n_types, size=n_nodes).astype(np.int32),
        labels=rng.integers(0, n_classes, size=n_nodes).astype(np.int32),
        n_nodes=n_nodes,
    )


def full_batch(g: SynthGraph) -> dict[str, np.ndarray]:
    b = {
        "positions": g.positions,
        "src": g.src.astype(np.int32),
        "dst": g.dst.astype(np.int32),
        "edge_mask": np.ones(g.n_edges, np.float32),
        "node_mask": np.ones(g.n_nodes, np.float32),
        "node_type": g.node_type,
        "labels": g.labels,
    }
    if g.node_feat is not None:
        b["node_feat"] = g.node_feat
    return b


class FanoutLoader:
    """minibatch_lg: real neighbor sampling to static-padded subgraph batches."""

    def __init__(self, g: SynthGraph, batch_nodes: int, fanouts: list[int],
                 max_nodes: int, max_edges: int, seed: int = 0):
        self.g = g
        self.csr = gnn_common.CSRGraph.from_edge_index(g.src, g.dst, g.n_nodes)
        self.batch_nodes = batch_nodes
        self.fanouts = fanouts
        self.max_nodes = max_nodes
        self.max_edges = max_edges
        self.rng = np.random.default_rng(seed)

    def next_batch(self) -> dict[str, np.ndarray]:
        seeds = self.rng.choice(self.g.n_nodes, size=self.batch_nodes, replace=False)
        nodes, src, dst = gnn_common.sample_fanout(
            self.csr, seeds, self.fanouts, self.rng
        )
        nodes = nodes[: self.max_nodes]
        keep = (src < self.max_nodes) & (dst < self.max_nodes)
        src, dst = src[keep][: self.max_edges], dst[keep][: self.max_edges]
        pad = gnn_common.pad_graph_batch(
            src, dst, len(nodes), self.max_nodes, self.max_edges
        )
        sel = np.full(self.max_nodes, nodes[-1] if len(nodes) else 0, np.int64)
        sel[: len(nodes)] = nodes
        batch = {
            "positions": self.g.positions[sel],
            "node_type": self.g.node_type[sel],
            "labels": np.where(
                pad["node_mask"] > 0, self.g.labels[sel], -1
            ).astype(np.int32),
            **pad,
        }
        if self.g.node_feat is not None:
            batch["node_feat"] = self.g.node_feat[sel]
        return batch


def molecule_batch(
    batch: int, n_nodes: int, n_edges: int, seed: int = 0
) -> dict[str, np.ndarray]:
    """Batched small graphs flattened into one disjoint union (graph_id map)."""
    rng = np.random.default_rng(seed)
    n_tot, e_tot = batch * n_nodes, batch * n_edges
    src = np.concatenate([
        rng.integers(0, n_nodes, size=n_edges) + i * n_nodes for i in range(batch)
    ])
    dst = np.concatenate([
        rng.integers(0, n_nodes, size=n_edges) + i * n_nodes for i in range(batch)
    ])
    return {
        "positions": rng.normal(size=(n_tot, 3)).astype(np.float32),
        "node_type": rng.integers(0, 16, size=n_tot).astype(np.int32),
        "src": src.astype(np.int32),
        "dst": dst.astype(np.int32),
        "edge_mask": np.ones(e_tot, np.float32),
        "node_mask": np.ones(n_tot, np.float32),
        "graph_id": np.repeat(np.arange(batch, dtype=np.int32), n_nodes),
        "targets": rng.normal(size=batch).astype(np.float32),
    }
