"""RecSys model zoo: SASRec, FM, two-tower retrieval, MIND.

Port of :mod:`repro.models.recsys`. The embedding lookup is the hot path:
a row gather (``index_select``) and, for ragged bags, an ``index_add``
over each id's bag. Tables support the hashing trick, and the row
assignment is selectable between RH and **IDL** (the paper's hash applied
to embedding rows): temporally-correlated ids (session neighbours) then
land in the same L-row window of the table, so a batch's gather touches
fewer pages, the same locality argument as the Bloom filter's probes.

Ids are int32 (negative ids occur: SASRec pads with -1). Every scheme
reproduces the reference's integer semantics: ``%`` and ``//`` floor as
``jnp``'s do, and an int32 id enters the 64-bit hash sign-extended, as
``astype(uint64)`` does (the uint64 bits ride in int64,
:mod:`repro_torch.core.hashing`). Rows come out int32.

Parameters are nested dicts of tensors under the reference's keys; each
``*_init(seed, cfg, dtype, device)`` draws from a ``torch.Generator`` on
``device``, or nothing on ``"meta"`` (the values differ from
``jax.random``'s; :mod:`repro_torch.models.convert` carries a reference
tree across). SASRec's per-block leaves are stacked on axis 0, as the
reference's ``vmap``ped init stacks them. The reference's sharding
constraints stand at its call sites, with its logical axes
(:func:`~repro_torch.distributed.sharding.shard`: the identity without
rules).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from repro_torch.core import hashing
from repro_torch.distributed.sharding import lookup, reduce_partial, shard
from repro_torch.models import layers, remat
from repro_torch.models.layers import Params


# --------------------------------------------------------------------------
# EmbeddingBag with optional hashing-trick (RH or IDL row assignment)
# --------------------------------------------------------------------------

def _rows_none(ids: torch.Tensor, n_rows: int, L: int) -> torch.Tensor:
    del L
    return torch.remainder(ids, n_rows).to(torch.int32)


def _rows_rh(ids: torch.Tensor, n_rows: int, L: int) -> torch.Tensor:
    del L
    return hashing.hash_to_range(ids.to(torch.int64), 0x5EED,
                                 n_rows).to(torch.int32)


def _rows_idl(ids: torch.Tensor, n_rows: int, L: int) -> torch.Tensor:
    # ids are grouped L/16 per window of L rows (load factor 1/16):
    # identity preservation needs the window sparse, as the paper's L >>
    # expected probes per window
    group = max(1, L // 16)
    bucket = torch.div(ids, group, rounding_mode="floor").to(torch.int64)
    anchor = hashing.hash_to_range(bucket, 0xA17C, max(n_rows // L, 1))
    local = hashing.hash_to_range(ids.to(torch.int64), 0x10CA, L)
    rows = anchor.to(torch.int32) * L + local.to(torch.int32)
    return torch.remainder(rows, n_rows)


_ROW_SCHEMES = {"none": _rows_none, "rh": _rows_rh, "idl": _rows_idl}


def hash_rows(ids: torch.Tensor, n_rows: int, scheme: str = "none",
              L: int = 4096) -> torch.Tensor:
    """Map raw int32 ids -> int32 table rows. "none": modulo; "rh":
    murmur-style; "idl": anchor from the id's block (locality) + a local
    hash, so session-adjacent ids land in the same L-row window without
    colliding."""
    try:
        row_fn = _ROW_SCHEMES[scheme]
    except KeyError:
        raise ValueError(scheme) from None
    return row_fn(ids, n_rows, L)


def take_rows(table: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``table[rows]`` for int32 rows of any shape: (*rows.shape, d) (on
    a DTensor table, each device's own rows, :func:`sharding.lookup`)."""
    got = lookup(table, rows)
    if got is not None:
        return got
    return table.index_select(0, rows.reshape(-1)).reshape(
        *rows.shape, table.shape[1])


def embedding_bag(
    table: torch.Tensor, ids: torch.Tensor,
    offsets: torch.Tensor | None = None, mode: str = "sum",
    hash_scheme: str = "none",
) -> torch.Tensor:
    """``torch.nn.EmbeddingBag`` equivalent, as the reference builds it.

    ids (n,) with offsets (bags+1,) => ragged bags (id i belongs to the
    bag ``searchsorted(offsets[1:], i, right)``; ids past ``offsets[-1]``
    fall in no bag, an empty bag sums to 0 and its mean is 0); or ids
    (B, k) => fixed bags.
    """
    n_rows = table.shape[0]
    vecs = take_rows(table, hash_rows(ids, n_rows, hash_scheme))
    if offsets is None:
        return vecs.sum(dim=-2) if mode == "sum" else vecs.mean(dim=-2)
    n_bags = offsets.shape[0] - 1
    seg = torch.searchsorted(
        offsets[1:].contiguous(),
        torch.arange(ids.shape[0], device=ids.device,
                     dtype=offsets.dtype), right=True)
    # one spill row takes the ids past the last bag (segment_sum drops them)
    out = vecs.new_zeros((n_bags + 1, vecs.shape[-1])).index_add(
        0, seg, vecs)[:n_bags]
    if mode == "mean":
        cnt = vecs.new_zeros((n_bags + 1,)).index_add(
            0, seg, torch.ones_like(seg, dtype=vecs.dtype))[:n_bags]
        out = out / torch.clamp(cnt, min=1.0)[:, None]
    return out


# --------------------------------------------------------------------------
# FM — factorization machine (Rendle ICDM'10): O(nk) sum-square trick
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FMConfig:
    name: str = "fm"
    n_sparse: int = 39
    embed_dim: int = 10
    vocab_per_field: int = 1 << 20
    hash_scheme: str = "none"


def fm_init(seed: int, cfg: FMConfig, dtype=torch.float32,
            device="cuda") -> Params:
    gen = layers.generator(seed, device)
    n = cfg.n_sparse * cfg.vocab_per_field
    return {
        "tables": layers.embed_init(gen, n, cfg.embed_dim, dtype),
        "linear": layers.embed_init(gen, n, 1, dtype),
        "bias": torch.zeros((), dtype=dtype, device=device),
    }


def fm_forward(params: Params, feats: torch.Tensor,
               cfg: FMConfig) -> torch.Tensor:
    """feats: (B, n_sparse) int32 raw categorical ids -> (B,) f32 logit."""
    field_offset = torch.arange(cfg.n_sparse, dtype=feats.dtype,
                                device=feats.device) * cfg.vocab_per_field
    ids = feats + field_offset[None, :]
    rows = hash_rows(ids, params["tables"].shape[0], cfg.hash_scheme)
    v = shard(take_rows(params["tables"], rows),         # (B, F, k)
              ("batch", None, None))
    lin = take_rows(params["linear"], rows)[..., 0].sum(-1)
    s = v.sum(dim=1)                                     # Σ v_i x_i
    pair = 0.5 * ((s * s).sum(-1) - (v * v).sum(dim=(1, 2)))
    return params["bias"].float() + lin.float() + pair.float()


def _bce_logits(logit: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return (torch.clamp(logit, min=0) - logit * y
            + torch.log1p(torch.exp(-torch.abs(logit))))


def fm_loss(params: Params, batch: dict, cfg: FMConfig):
    logit = fm_forward(params, batch["feats"], cfg)
    loss = torch.mean(_bce_logits(logit, batch["labels"].float()))
    return loss, {"bce": loss}


# --------------------------------------------------------------------------
# two-tower retrieval (YouTube RecSys'19): in-batch sampled softmax
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TwoTowerConfig:
    name: str = "two-tower-retrieval"
    embed_dim: int = 256
    tower_dims: tuple[int, ...] = (1024, 512, 256)
    n_users: int = 1 << 23
    n_items: int = 1 << 23
    n_user_feats: int = 8
    n_item_feats: int = 4
    hash_scheme: str = "none"
    temperature: float = 0.05


def _tower_init(gen: torch.Generator, d_in: int, dims: tuple[int, ...],
                dtype) -> Params:
    return {
        f"w{i}": layers.dense_init(gen, d_in if i == 0 else dims[i - 1], d,
                                   dtype)
        for i, d in enumerate(dims)
    }


def _tower(params: Params, x: torch.Tensor,
           dims: tuple[int, ...]) -> torch.Tensor:
    for i in range(len(dims)):
        x = x @ params[f"w{i}"].to(x.dtype)
        if i < len(dims) - 1:
            x = F.relu(x)
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-6)


def twotower_init(seed: int, cfg: TwoTowerConfig, dtype=torch.float32,
                  device="cuda") -> Params:
    gen = layers.generator(seed, device)
    return {
        "user_table": layers.embed_init(gen, cfg.n_users, cfg.embed_dim,
                                        dtype),
        "item_table": layers.embed_init(gen, cfg.n_items, cfg.embed_dim,
                                        dtype),
        "user_tower": _tower_init(gen, cfg.n_user_feats * cfg.embed_dim,
                                  cfg.tower_dims, dtype),
        "item_tower": _tower_init(gen, cfg.n_item_feats * cfg.embed_dim,
                                  cfg.tower_dims, dtype),
    }


def _flat_rows(table: torch.Tensor, feats: torch.Tensor, n_rows: int,
               scheme: str) -> torch.Tensor:
    """(B, n_feats) ids -> (B, n_feats * d): each feature's own vector."""
    return take_rows(table, hash_rows(feats, n_rows, scheme)).reshape(
        feats.shape[0], -1)


def twotower_embed(params: Params, batch: dict, cfg: TwoTowerConfig):
    """(user vectors, item vectors), each (B, tower_dims[-1]) unit rows.

    The reference also sums the user features through ``embedding_bag``
    and then deletes the sum (dead code under ``jit``); the port does not
    compute it."""
    uraw = _flat_rows(params["user_table"], batch["user_feats"], cfg.n_users,
                      cfg.hash_scheme)
    iraw = _flat_rows(params["item_table"], batch["item_feats"], cfg.n_items,
                      cfg.hash_scheme)
    u = _tower(params["user_tower"], shard(uraw, ("batch", None)),
               cfg.tower_dims)
    it = _tower(params["item_tower"], shard(iraw, ("batch", None)),
                cfg.tower_dims)
    return u, it


TWOTOWER_ROW_CHUNK = 8192


def _inbatch_nll_rows(u_rows: torch.Tensor, it: torch.Tensor,
                      rows: torch.Tensor, temperature: float) -> torch.Tensor:
    """-sum over ``rows`` of log softmax(u_r . it / T)[r]: each row's own
    item is its positive, the batch's other items its negatives."""
    logits = (u_rows @ it.T) / temperature        # (rows, B)
    logz = torch.logsumexp(logits, dim=-1)
    ll = reduce_partial(torch.gather(logits, 1, rows[:, None]))[:, 0] - logz
    return -ll.sum()


def twotower_loss(params: Params, batch: dict, cfg: TwoTowerConfig):
    """In-batch sampled softmax over the (B, B) logits, taken in blocks of
    ``TWOTOWER_ROW_CHUNK`` rows; with more than one block, each is
    checkpointed under autograd, so one block of logits is live at a time
    (the reference materialises all (B, B): 17.2 GB at B = 65,536, and
    several such buffers in its backward)."""
    u, it = twotower_embed(params, batch, cfg)
    b, step = u.shape[0], TWOTOWER_ROW_CHUNK
    recompute = torch.is_grad_enabled() and b > step
    total = u.new_zeros((), dtype=torch.float32)
    for i in range(0, b, step):
        rows = torch.arange(i, min(i + step, b), device=u.device)
        args = (u[i:i + step], it, rows, cfg.temperature)
        if recompute:
            total = total + remat.checkpoint(_inbatch_nll_rows, *args)
        else:
            total = total + _inbatch_nll_rows(*args)
    loss = total / b
    return loss, {"sampled_softmax": loss}


def twotower_score_candidates(params: Params, batch: dict,
                              cfg: TwoTowerConfig) -> torch.Tensor:
    """retrieval_cand shape: one query vs n_candidates items (batched dot)."""
    uraw = _flat_rows(params["user_table"], batch["user_feats"],
                      cfg.n_users, cfg.hash_scheme)
    u = _tower(params["user_tower"], shard(uraw, ("batch", None)),
               cfg.tower_dims)
    iraw = _flat_rows(params["item_table"], batch["cand_feats"], cfg.n_items,
                      cfg.hash_scheme)
    it = _tower(params["item_tower"], shard(iraw, ("batch", None)),
                cfg.tower_dims)
    return (it @ u[0]).float()                     # (n_candidates,)


# --------------------------------------------------------------------------
# SASRec (arXiv:1808.09781): causal self-attention over item sequences
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SASRecConfig:
    name: str = "sasrec"
    embed_dim: int = 50
    n_blocks: int = 2
    n_heads: int = 1
    seq_len: int = 50
    n_items: int = 1 << 20
    hash_scheme: str = "none"

    def attn_cfg(self) -> layers.AttnConfig:
        return layers.AttnConfig(
            d_model=self.embed_dim, n_heads=self.n_heads,
            n_kv_heads=self.n_heads, d_head=self.embed_dim // self.n_heads,
        )

    def mlp_cfg(self) -> layers.MlpConfig:
        return layers.MlpConfig(self.embed_dim, 4 * self.embed_dim, "relu",
                                False)


def sasrec_init(seed: int, cfg: SASRecConfig, dtype=torch.float32,
                device="cuda") -> Params:
    gen = layers.generator(seed, device)
    n, d = cfg.n_blocks, cfg.embed_dim
    return {
        "item_table": layers.embed_init(gen, cfg.n_items, d, dtype),
        "pos": layers.embed_init(gen, cfg.seq_len, d, dtype),
        "blocks": {
            "ln1": torch.ones((n, d), dtype=dtype, device=device),
            "ln2": torch.ones((n, d), dtype=dtype, device=device),
            "attn": layers.attn_init(gen, cfg.attn_cfg(), dtype, lead=(n,)),
            "mlp": layers.mlp_init(gen, cfg.mlp_cfg(), dtype, lead=(n,)),
        },
        "ln_f": torch.ones((d,), dtype=dtype, device=device),
    }


def sasrec_forward(params: Params, seq: torch.Tensor,
                   cfg: SASRecConfig) -> torch.Tensor:
    """seq (B, S) item ids -> (B, S, d) sequence representations."""
    rows = hash_rows(seq, cfg.n_items, cfg.hash_scheme)
    x = take_rows(params["item_table"], rows)
    x = x + params["pos"][None, : seq.shape[1], :].to(x.dtype)
    x = shard(x, ("batch", "seq", None))
    for bp in layers.unstack(params["blocks"], cfg.n_blocks):
        h = layers.rmsnorm(x, bp["ln1"])
        x = x + layers.attention(bp["attn"], h, cfg.attn_cfg())
        h = layers.rmsnorm(x, bp["ln2"])
        x = x + layers.mlp(bp["mlp"], h, cfg.mlp_cfg())
    return layers.rmsnorm(x, params["ln_f"])


def sasrec_loss(params: Params, batch: dict, cfg: SASRecConfig):
    """BCE on (positive next item, sampled negative), the paper's
    objective; positions whose positive id is negative are masked."""
    h = sasrec_forward(params, batch["seq"], cfg)            # (B, S, d)
    pe = take_rows(params["item_table"],
                   hash_rows(batch["pos"], cfg.n_items, cfg.hash_scheme))
    ne = take_rows(params["item_table"],
                   hash_rows(batch["neg"], cfg.n_items, cfg.hash_scheme))
    pos_logit = (h * pe).sum(-1).float()
    neg_logit = (h * ne).sum(-1).float()
    mask = (batch["pos"] >= 0).float()
    bce = (torch.log1p(torch.exp(-pos_logit))
           + torch.log1p(torch.exp(neg_logit)))
    loss = (bce * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return loss, {"bce": loss}


# --------------------------------------------------------------------------
# MIND (arXiv:1904.08030): multi-interest dynamic-routing capsules
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MINDConfig:
    name: str = "mind"
    embed_dim: int = 64
    n_interests: int = 4
    capsule_iters: int = 3
    seq_len: int = 50
    n_items: int = 1 << 20
    hash_scheme: str = "none"


def mind_init(seed: int, cfg: MINDConfig, dtype=torch.float32,
              device="cuda") -> Params:
    gen = layers.generator(seed, device)
    return {
        "item_table": layers.embed_init(gen, cfg.n_items, cfg.embed_dim,
                                        dtype),
        "S": layers.dense_init(gen, cfg.embed_dim, cfg.embed_dim, dtype),
    }


def _squash(v: torch.Tensor) -> torch.Tensor:
    n2 = torch.sum(v * v, dim=-1, keepdim=True)
    return (n2 / (1.0 + n2)) * v / torch.sqrt(n2 + 1e-9)


def mind_interests(params: Params, seq: torch.Tensor, mask: torch.Tensor,
                   cfg: MINDConfig) -> torch.Tensor:
    """Dynamic routing: (B, S) history -> (B, K, d) interest capsules."""
    e = take_rows(params["item_table"],
                  hash_rows(seq, cfg.n_items, cfg.hash_scheme))  # (B, S, d)
    e = shard(e, ("batch", "seq", None))
    u = e @ params["S"].to(e.dtype)                              # behaviour caps
    b = torch.zeros((seq.shape[0], cfg.n_interests, seq.shape[1]),
                    dtype=torch.float32, device=seq.device)
    for _ in range(cfg.capsule_iters):                           # fixed iters
        w = torch.softmax(b, dim=1)                              # over interests
        w = w * mask[:, None, :].to(w.dtype)
        v = _squash(torch.einsum("bks,bsd->bkd", w.to(u.dtype), u))
        b = b + torch.einsum("bkd,bsd->bks", v, u).float()
    return v


def mind_loss(params: Params, batch: dict, cfg: MINDConfig):
    """Label-aware attention: sampled softmax on the interest closest to
    the positive (the first on a tie, as ``jnp.argmax``)."""
    v = mind_interests(params, batch["seq"], batch["mask"], cfg)  # (B, K, d)
    pe = take_rows(params["item_table"],
                   hash_rows(batch["pos"], cfg.n_items, cfg.hash_scheme))
    ne = take_rows(params["item_table"],
                   hash_rows(batch["negs"], cfg.n_items, cfg.hash_scheme))
    sim = torch.einsum("bkd,bd->bk", v, pe)
    pick = torch.argmax(sim, dim=1)
    best = torch.gather(
        v, 1, pick[:, None, None].expand(-1, 1, v.shape[-1]))[:, 0]
    pos_logit = (best * pe).sum(-1).float()
    neg_logit = torch.einsum("bd,bnd->bn", best, ne).float()
    logits = torch.cat([pos_logit[:, None], neg_logit], dim=1)
    loss = -(pos_logit - torch.logsumexp(logits, dim=1)).mean()
    return loss, {"sampled_softmax": loss}
