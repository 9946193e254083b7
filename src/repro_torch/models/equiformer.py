"""EquiformerV2-style SO(2)-eSCN equivariant graph attention network.

Port of :mod:`repro.models.equiformer` (arXiv:2306.12059 / eSCN
arXiv:2302.03655):
  * node features are real-SH irrep coefficients up to l_max (flat K =
    (l_max+1)^2 coeffs x C channels),
  * per edge, features are rotated into the edge-aligned frame with EXACT
    Wigner matrices (:func:`so3.wigner_matrices`, Ivanic-Ruedenberg),
  * the tensor-product convolution becomes an SO(2) per-m linear mix,
    truncated to |m| <= m_max (the O(L^6) -> O(L^3) eSCN trick),
  * messages are weighted by scalar-channel graph attention
    (segment-softmax over incoming edges), rotated back, aggregated.

The reference's documented simplifications are kept: the radial function
modulates each (m-block, channel) pair of the static mixing weights, and
the S2 activation is a scalar-gated per-degree channel mix; both keep
exact equivariance (the rotation-invariance test holds the port to it).

Parameters are the reference's tree: per-layer leaves stacked on axis 0
(``layers``), read through one ``unbind`` a leaf. The edge rotations are
built once per forward, outside the layer loop and outside autograd (they
depend on positions only). Under autograd with ``cfg.remat`` each layer
runs through :func:`repro_torch.models.remat.checkpoint` (the reference's
``jax.checkpoint`` of the scan body), so only each layer's input is kept.
The reference's sharding constraints stand at its call sites, with its
logical axes (:func:`~repro_torch.distributed.sharding.shard`: the
identity without rules).
"""

from __future__ import annotations

import dataclasses
import math
from functools import lru_cache

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor
from repro_torch.distributed.sharding import (gather_dims, grad_as_placed,
                                              index_select, layout, like,
                                              reduce_partial, rows, shard,
                                              split_last, ways)
from repro_torch.models import gnn_common, layers, remat, so3
from repro_torch.models.layers import Params


@dataclasses.dataclass(frozen=True)
class EquiformerConfig:
    name: str = "equiformer-v2"
    n_layers: int = 12
    d_hidden: int = 128
    l_max: int = 6
    m_max: int = 2
    n_heads: int = 8
    d_feat: int = 0            # input node feature dim (0 = atom-type embed)
    n_node_types: int = 120
    n_classes: int = 0         # >0 => node classification head
    n_rbf: int = 32
    cutoff: float = 6.0
    remat: bool = True

    @property
    def n_coeff(self) -> int:
        return (self.l_max + 1) ** 2

    def degree_slices(self) -> list[tuple[int, int]]:
        """[(offset, 2l+1)] per l into the flat coefficient axis."""
        out, off = [], 0
        for l in range(self.l_max + 1):
            out.append((off, 2 * l + 1))
            off += 2 * l + 1
        return out

    def m_blocks(self) -> list[tuple[int, list[int]]]:
        """SO(2) blocks: for m=0 the flat indices of (l, m=0) coeffs; for
        m>0 the indices of (l, +m), then (-m, those of (l, -m))."""
        signed = [0] + [s for m in range(1, self.m_max + 1) for s in (m, -m)]
        return [(m, _m_indices(self, m)) for m in signed]


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def _so2_weights(gen: torch.Generator, cfg: EquiformerConfig, dtype,
                 lead: tuple) -> Params:
    """Static mixing weights per |m|: real & imaginary parts. For block m:
    (n_l(m) * C) -> (n_l(m) * C), n_l(m) = number of degrees l >= m."""
    p = {}
    for m in range(cfg.m_max + 1):
        d = (cfg.l_max + 1 - m) * cfg.d_hidden
        p[f"w{m}_r"] = layers.dense_init(gen, d, d, dtype, lead=lead)
        if m > 0:
            p[f"w{m}_i"] = layers.dense_init(gen, d, d, dtype, lead=lead)
    return p


def _layers_init(gen: torch.Generator, cfg: EquiformerConfig,
                 dtype) -> Params:
    """Every layer's parameters, stacked along a leading n_layers axis."""
    n, c = (cfg.n_layers,), cfg.d_hidden
    wl = layers.randn(gen, (cfg.n_layers, cfg.l_max + 1, c, c))
    return {
        "so2": _so2_weights(gen, cfg, dtype, n),
        "radial": {
            "w1": layers.dense_init(gen, cfg.n_rbf, c, dtype, lead=n),
            "w2": layers.dense_init(gen, c, (cfg.m_max + 1) * c, dtype,
                                    lead=n),
        },
        "attn": {
            "w_alpha": layers.dense_init(gen, 3 * c, cfg.n_heads, dtype,
                                         lead=n),
        },
        "ffn": {
            # per-degree channel mixing (equivariant: shared over m in l)
            "wl": (wl / math.sqrt(c)).to(dtype),
            "gate": layers.dense_init(gen, c, (cfg.l_max + 1) * c, dtype,
                                      lead=n),
        },
        "ln_scale": torch.ones((cfg.n_layers, cfg.l_max + 1, c),
                               dtype=dtype, device=gen.device),
    }


def equiformer_init(seed: int, cfg: EquiformerConfig, dtype=torch.float32,
                    device="cuda") -> Params:
    """Random weights drawn on ``device`` from a generator seeded with
    ``seed`` (on ``"meta"``: shapes and dtypes only, nothing drawn)."""
    gen = layers.generator(seed, device)
    d_in = cfg.d_feat if cfg.d_feat else cfg.n_node_types
    return {
        "embed": layers.dense_init(gen, d_in, cfg.d_hidden, dtype),
        "layers": _layers_init(gen, cfg, dtype),
        "head": layers.dense_init(
            gen, cfg.d_hidden, cfg.n_classes if cfg.n_classes else 1, dtype),
    }


# --------------------------------------------------------------------------
# equivariant primitives
# --------------------------------------------------------------------------

def equiv_layernorm(x: torch.Tensor, scale: torch.Tensor,
                    cfg: EquiformerConfig) -> torch.Tensor:
    """Norm over each degree's (2l+1, C) block magnitude; scale per (l, C)."""
    outs = []
    for l, (off, w) in enumerate(cfg.degree_slices()):
        blk = x[:, off: off + w, :]
        norm = torch.sqrt(torch.mean(blk.float() ** 2, dim=(1, 2),
                                     keepdim=True) + 1e-6)
        outs.append((blk / norm.to(blk.dtype)) * scale[l][None, None, :])
    return torch.cat(outs, dim=1)


def _rbf(dist: torch.Tensor, cfg: EquiformerConfig) -> torch.Tensor:
    centers = torch.linspace(0.0, cfg.cutoff, cfg.n_rbf, dtype=torch.float32,
                             device=dist.device)
    gamma = (cfg.n_rbf / cfg.cutoff) ** 2
    return torch.exp(-gamma * (dist[:, None] - centers[None, :]) ** 2).to(
        dist.dtype)


def _m_indices(cfg: EquiformerConfig, m: int) -> list[int]:
    idx, off = [], 0
    for l in range(cfg.l_max + 1):
        w = 2 * l + 1
        if abs(m) <= l:
            idx.append(off + l + m)
        off += w
    return idx


@lru_cache(maxsize=None)
def _m_index_tensor(cfg: EquiformerConfig, m: int,
                    device: torch.device) -> torch.Tensor:
    return torch.tensor(_m_indices(cfg, m), dtype=torch.int64, device=device)


@lru_cache(maxsize=None)
def _m_gather_tensor(cfg: EquiformerConfig,
                     device: torch.device) -> torch.Tensor:
    """For each of the K coefficients, its place among so2_conv's parts
    (m = 0, 1, -1, 2, -2, ...), or the zero slot past them where |m| >
    m_max."""
    order = _m_indices(cfg, 0)
    for m in range(1, cfg.m_max + 1):
        order += _m_indices(cfg, m) + _m_indices(cfg, -m)
    where = {k: i for i, k in enumerate(order)}
    return torch.tensor([where.get(k, len(order))
                         for k in range(cfg.n_coeff)], dtype=torch.int64,
                        device=device)


def _mix(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (N, n, C) @ w (C, D). Where x's rows are sharded unevenly (a
    DTensor of a node count the mesh axis does not divide), as a product
    batched over the rows: DTensor cannot fold uneven rows into the
    product's rows, forward or backward."""
    if x.shape[0] % ways(x, 0):
        y = torch.bmm(x, w.expand(x.shape[0], *w.shape))
    else:
        y = x @ w
    # its gradient laid out as y, so the product's backward folds the
    # rows the forward folded
    return grad_as_placed(y)


def _channels(y: torch.Tensor, c: int) -> torch.Tensor:
    """(E, n·c) -> (E, n, c)."""
    return split_last(y, (y.shape[-1] // c, c))


def so2_conv(lp: Params, x_rot: torch.Tensor, radial: torch.Tensor,
             cfg: EquiformerConfig) -> torch.Tensor:
    """SO(2) convolution in the edge frame, |m| <= m_max.

    x_rot: (E, K, C) rotated coefficients; radial: (E, m_max+1, C).
    Output: (E, K, C) with coefficients for |m| > m_max zeroed, assembled
    by one out-of-place ``index_copy`` (autograd saves no tensor that is
    written afterwards).
    """
    e = x_rot.shape[0]
    c = cfg.d_hidden
    dt = x_rot.dtype
    dev = x_rot.device

    def pick(m):
        idx = _m_index_tensor(cfg, m, dev)
        return idx, index_select(x_rot, 1, idx).reshape(e, -1)

    idx0, h0 = pick(0)
    y0 = _channels(h0 @ lp["so2"]["w0_r"].to(dt), c) * radial[:, 0:1, :]
    idxs, parts = [idx0], [y0]
    for m in range(1, cfg.m_max + 1):
        ip, xp = pick(m)
        im, xm = pick(-m)
        wr = lp["so2"][f"w{m}_r"].to(dt)
        wi = lp["so2"][f"w{m}_i"].to(dt)
        yp = xp @ wr - xm @ wi
        ym = xp @ wi + xm @ wr
        rad = radial[:, m: m + 1, :]
        idxs += [ip, im]
        parts += [_channels(yp, c) * rad, _channels(ym, c) * rad]
    parts = torch.cat(parts, dim=1)
    if isinstance(parts, DTensor):
        # the same output as a gather of the parts' coefficients (a zero
        # slot for |m| > m_max): DTensor has no sharded index_copy
        return index_select(torch.cat([parts, parts.new_zeros(e, 1, c)],
                                      dim=1), 1, _m_gather_tensor(cfg, dev))
    return x_rot.new_zeros(x_rot.shape).index_copy(1, torch.cat(idxs), parts)


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------

@torch.no_grad()
def _edge_rotations(positions: torch.Tensor, src: torch.Tensor,
                    dst: torch.Tensor, cfg: EquiformerConfig):
    """Per-degree Wigner blocks [(E, 2l+1, 2l+1)] — not the dense (E, K,
    K) block-diagonal, which is 81% zeros at l_max=6 — and the edge
    lengths (E,). Positions carry no gradient, so neither do these. On
    DTensors each device computes its own edges' rotations as plain
    tensors (every edge's is its own: the Wigner stage's thousands of
    small operators then need no sharding strategy)."""
    vec = rows(positions, dst.long()) - rows(positions, src.long())
    if not isinstance(vec, DTensor):
        return _rotations(vec, cfg)
    vec = gather_dims(reduce_partial(vec), (1,))
    mesh, where, e = vec.device_mesh, vec.placements, vec.shape[0]

    def back(t):
        shape = (e, *t.shape[1:])
        return DTensor.from_local(t, mesh, where, run_check=False,
                                  shape=shape, stride=_strides(shape))
    mats, dist = _rotations(vec.to_local(), cfg)
    return [back(m) for m in mats], back(dist)


def _rotations(vec: torch.Tensor, cfg: EquiformerConfig):
    """The Wigner blocks and lengths of edge vectors ``vec`` (E, 3)."""
    dist = torch.linalg.vector_norm(vec.float(), dim=-1) + 1e-9
    m3 = so3.rotation_to_z(vec.float())
    mats = so3.wigner_matrices(m3, cfg.l_max)     # [(E, 2l+1, 2l+1)]
    return [m.to(vec.dtype) for m in mats], dist.to(vec.dtype)


def _strides(shape: tuple) -> tuple:
    """A contiguous tensor's strides."""
    out, n = [], 1
    for d in reversed(shape):
        out.append(n)
        n *= d
    return tuple(reversed(out))


def _rotate(mats: list, x: torch.Tensor, cfg: EquiformerConfig,
            transpose: bool = False) -> torch.Tensor:
    """Apply the block-diagonal rotation degree by degree."""
    outs = []
    for l, (off, w) in enumerate(cfg.degree_slices()):
        r = mats[l].transpose(-1, -2) if transpose else mats[l]
        outs.append(torch.matmul(r, x[:, off: off + w, :]))
    return torch.cat(outs, dim=1)


def _layer(lp: Params, x: torch.Tensor, dmat: list, dist: torch.Tensor,
           src: torch.Tensor, dst: torch.Tensor, edge_mask: torch.Tensor,
           n_nodes: int, cfg: EquiformerConfig) -> torch.Tensor:
    dt = x.dtype
    c = cfg.d_hidden
    e = src.shape[0]
    # gather + rotate into the edge frame (per-degree blocks)
    x_src = index_select(x, 0, src)                   # (E, K, C)
    x_rot = shard(_rotate(dmat, x_src, cfg), ("edges", None, None))
    # radial modulation
    rad = _rbf(dist, cfg)
    h = F.silu(rad @ lp["radial"]["w1"].to(dt))
    radial = _channels(h @ lp["radial"]["w2"].to(dt), c)
    msg_rot = so2_conv(lp, x_rot, radial, cfg)
    # rotate back (D^T = D^{-1}, per degree)
    msg = shard(_rotate(dmat, msg_rot, cfg, transpose=True),
                ("edges", None, None))
    # scalar-channel attention over incoming edges
    inv_t = index_select(x[:, 0, :], 0, dst)
    inv_s = x_src[:, 0, :]
    inv_m = msg[:, 0, :]
    alpha_in = torch.cat([inv_t, inv_s, inv_m], dim=-1)
    logits = (alpha_in @ lp["attn"]["w_alpha"].to(dt)).float()
    logits = torch.where(edge_mask[:, None] > 0, logits, layers.NEG_INF)
    alpha = gnn_common.segment_softmax(logits, dst, n_nodes)      # (E, H)
    alpha = (alpha * edge_mask[:, None]).to(dt)
    mh = msg.reshape(e, cfg.n_coeff, cfg.n_heads, c // cfg.n_heads)
    mh = mh * alpha[:, None, :, None]
    agg = gnn_common.segment_sum(mh.reshape(e, cfg.n_coeff, c), dst, n_nodes)
    # the edges' partial sums reduced onto the nodes' own layout
    x = x + like(agg, x)
    # equivariant FFN: scalar-gated per-degree channel mix
    x = equiv_layernorm(x, lp["ln_scale"], cfg)
    gates = torch.sigmoid(
        x[:, 0, :] @ lp["ffn"]["gate"].to(dt)).reshape(-1, cfg.l_max + 1, c)
    outs = []
    for l, (off, w) in enumerate(cfg.degree_slices()):
        blk = _mix(x[:, off: off + w, :], lp["ffn"]["wl"][l].to(dt))
        outs.append(blk * gates[:, l: l + 1, :])
    return x + torch.cat(outs, dim=1)


def equiformer_forward(params: Params, batch: dict,
                       cfg: EquiformerConfig) -> torch.Tensor:
    """batch: positions (N,3), node_feat (N,d) or node_type (N,), src/dst
    (E,), edge_mask (E,), node_mask (N,). Returns the per-node head
    output (N, n_classes or 1)."""
    dt = params["embed"].dtype
    if cfg.d_feat:
        feats = batch["node_feat"].to(dt)
    else:
        feats = F.one_hot(batch["node_type"].long(), cfg.n_node_types).to(dt)
    n = feats.shape[0]
    x0 = feats @ params["embed"].to(dt)               # (N, C)
    x = torch.cat([x0[:, None, :],
                   x0.new_zeros((n, cfg.n_coeff - 1, cfg.d_hidden))], dim=1)
    x = shard(x, ("nodes", None, None))
    # the edge inputs in the edge messages' layout (the batch may split
    # them over more axes)
    src, dst, edge_mask = (layout(batch[k], ("edges",))
                           for k in ("src", "dst", "edge_mask"))
    src, dst = src.long(), dst.long()
    dmat, dist = _edge_rotations(batch["positions"].to(dt), src, dst, cfg)
    recompute = cfg.remat and torch.is_grad_enabled()
    for lp in layers.unstack(params["layers"], cfg.n_layers):
        args = (lp, x, dmat, dist, src, dst, edge_mask, n, cfg)
        if recompute:
            x = remat.checkpoint(_layer, *args)
        else:
            x = _layer(*args)
    return x[:, 0, :] @ params["head"].to(dt)


def equiformer_loss(params: Params, batch: dict, cfg: EquiformerConfig):
    out = equiformer_forward(params, batch, cfg).float()
    mask = batch["node_mask"].float()
    if cfg.n_classes:
        labels = batch["labels"]
        lm = mask * (labels >= 0)
        logz = torch.logsumexp(out, dim=-1)
        ll = reduce_partial(torch.gather(
            out, -1, labels.clamp(min=0).long()[:, None]))[:, 0]
        ce = -((ll - logz) * lm).sum() / torch.clamp(lm.sum(), min=1.0)
        return ce, {"ce": ce}
    # graph energy regression: sum node scalars per graph
    n_graphs = batch["targets"].shape[0]
    energy = gnn_common.segment_sum(out[:, 0] * mask, batch["graph_id"].long(),
                                    n_graphs)
    mse = torch.mean((energy - batch["targets"]) ** 2)
    return mse, {"mse": mse}
