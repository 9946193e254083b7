"""GNN substrate: segment message-passing ops + neighbor sampling.

Port of :mod:`repro.models.gnn_common`. Message passing runs over an edge
index: ``segment_sum`` is ``index_add`` (whose atomics on CUDA add in no
fixed order, so the card matches the CPU within rounding, not bit for
bit) and ``segment_max`` is ``scatter_reduce("amax")`` into a tensor
filled with -inf. On DTensors (a sharded step), each device reduces its
own rows of an edge-sharded tensor and the results are combined across
the devices (a ``Partial`` sum or max, the reduction GSPMD emits for a
segment reduction over a sharded dim): DTensor has no sharding strategy
for ``index_add`` or ``scatter_reduce``. The fanout sampler and the CSR
graph are the reference's host-side numpy, copied: the same seed gives
the same subgraph.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.distributed.sharding import rows


def _by_rows(fn, values: torch.Tensor, ids: torch.Tensor, reduce: str):
    """``fn(values, ids)``, a reduction of rows into segments. On DTensors
    each device runs ``fn`` on its own rows (``values`` laid out over the
    rows as ``ids`` is, a row sharding of ``ids`` being ``Shard(0)``) and
    the result is ``Partial(reduce)`` over the mesh axes that split the
    rows."""
    if not isinstance(values, DTensor) and not isinstance(ids, DTensor):
        return fn(values, ids)
    mesh = (values if isinstance(values, DTensor) else ids).device_mesh
    whole = [Replicate()] * mesh.ndim
    if not isinstance(ids, DTensor):
        ids = DTensor.from_local(ids, mesh, whole, run_check=False)
    if not isinstance(values, DTensor):
        values = DTensor.from_local(values, mesh, whole, run_check=False)
    rows = [Shard(0) if isinstance(p, Shard) and p.dim == 0 else Replicate()
            for p in ids.placements]
    ids = ids.redistribute(mesh, rows)
    values = values.redistribute(mesh, rows)
    out = fn(values.to_local(), ids.to_local())
    return _Partial.apply(out, mesh, tuple(
        Partial(reduce) if isinstance(p, Shard) else p for p in rows))


class _Partial(torch.autograd.Function):
    """Each device's whole-shaped local result as a DTensor partial over
    the given mesh dims; its gradient, the whole gradient on every device
    (``from_local`` would ask DTensor to redistribute a sharded gradient
    to a partial one, which it cannot)."""

    @staticmethod
    def forward(ctx, out, mesh, placements):
        ctx.mesh = mesh
        return DTensor.from_local(out, mesh, placements, run_check=False)

    @staticmethod
    def backward(ctx, grad):
        whole = [Replicate()] * ctx.mesh.ndim
        return grad.redistribute(ctx.mesh, whole).to_local(), None, None


def segment_sum(values: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Sum of the rows of ``values`` sharing a segment id (ids in
    ``[0, num_segments)``); an empty segment sums to 0."""
    def add(v, i):
        return v.new_zeros((num_segments,) + tuple(v.shape[1:])).index_add(
            0, i, v)
    return _by_rows(add, values, segment_ids, "sum")


def _segment_max(values: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    """Max of the rows of ``values`` sharing a segment id (-inf where a
    segment is empty). On DTensors the max carries no gradient: a
    device's own max is not the segment's, and the softmax that takes it
    is shift-invariant (its gradient through the max is zero up to
    rounding)."""
    if isinstance(values, DTensor):
        values = values.detach()

    def amax(v, i):
        idx = i.view(-1, *([1] * (v.dim() - 1))).expand_as(v)
        return v.new_full((num_segments,) + tuple(v.shape[1:]),
                          float("-inf")).scatter_reduce(
            0, idx, v, reduce="amax", include_self=False)
    return _by_rows(amax, values, segment_ids, "max")


def segment_softmax(
    logits: torch.Tensor, segment_ids: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """Softmax over entries sharing a segment id (edge-softmax)."""
    seg = segment_ids.long()
    maxes = _segment_max(logits, seg, num_segments)
    maxes = torch.where(torch.isfinite(maxes), maxes, 0.0)
    shifted = logits - rows(maxes, seg)
    ex = torch.exp(shifted)
    denom = segment_sum(ex, seg, num_segments)
    return ex / (rows(denom, seg) + 1e-9)


def scatter_mean(
    values: torch.Tensor, segment_ids: torch.Tensor, num_segments: int
) -> torch.Tensor:
    s = segment_sum(values, segment_ids, num_segments)
    c = segment_sum(values.new_ones(values.shape[:1]), segment_ids,
                    num_segments)
    return s / torch.clamp(c, min=1.0)[(...,) + (None,) * (values.dim() - 1)]


# --------------------------------------------------------------------------
# host-side graph structures + fanout sampler
# --------------------------------------------------------------------------

@dataclasses.dataclass
class CSRGraph:
    indptr: np.ndarray   # (N+1,)
    indices: np.ndarray  # (E,)

    @property
    def n_nodes(self) -> int:
        return len(self.indptr) - 1

    @property
    def n_edges(self) -> int:
        return len(self.indices)

    @classmethod
    def from_edge_index(cls, src: np.ndarray, dst: np.ndarray, n_nodes: int):
        order = np.argsort(dst, kind="stable")
        src_s, dst_s = src[order], dst[order]
        counts = np.bincount(dst_s, minlength=n_nodes)
        indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        return cls(indptr=indptr, indices=src_s.astype(np.int64))


def sample_fanout(
    graph: CSRGraph, seed_nodes: np.ndarray, fanouts: list[int],
    rng: np.random.Generator,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """GraphSAGE fanout sampling.

    Returns (nodes, src, dst): ``nodes`` is the union of sampled nodes with
    seeds first; (src, dst) are edges in *local* (renumbered) ids.
    """
    node_map: dict[int, int] = {int(n): i for i, n in enumerate(seed_nodes)}
    nodes = [int(n) for n in seed_nodes]
    src_l, dst_l = [], []
    frontier = list(seed_nodes)
    for fanout in fanouts:
        nxt = []
        for u in frontier:
            lo, hi = graph.indptr[u], graph.indptr[u + 1]
            neigh = graph.indices[lo:hi]
            if len(neigh) == 0:
                continue
            if len(neigh) > fanout:
                neigh = rng.choice(neigh, size=fanout, replace=False)
            for v in neigh:
                v = int(v)
                if v not in node_map:
                    node_map[v] = len(nodes)
                    nodes.append(v)
                src_l.append(node_map[v])
                dst_l.append(node_map[int(u)])
                nxt.append(v)
        frontier = nxt
    return (
        np.asarray(nodes, dtype=np.int64),
        np.asarray(src_l, dtype=np.int64),
        np.asarray(dst_l, dtype=np.int64),
    )


def pad_graph_batch(
    src: np.ndarray, dst: np.ndarray, n_nodes: int,
    max_nodes: int, max_edges: int,
) -> dict[str, np.ndarray]:
    """Pad a sampled subgraph to static shapes (pad edges point at a sink)."""
    e = len(src)
    if e > max_edges or n_nodes > max_nodes:
        raise ValueError(f"subgraph ({n_nodes} nodes, {e} edges) exceeds pad")
    src_p = np.full(max_edges, max_nodes - 1, dtype=np.int32)
    dst_p = np.full(max_edges, max_nodes - 1, dtype=np.int32)
    src_p[:e] = src
    dst_p[:e] = dst
    edge_mask = np.zeros(max_edges, dtype=np.float32)
    edge_mask[:e] = 1.0
    node_mask = np.zeros(max_nodes, dtype=np.float32)
    node_mask[:n_nodes] = 1.0
    return {
        "src": src_p, "dst": dst_p,
        "edge_mask": edge_mask, "node_mask": node_mask,
    }
